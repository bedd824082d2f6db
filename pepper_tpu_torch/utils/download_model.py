"""Model download (reference: pepper/modules/python/download_model.py:10-27),
a copy of the JAX package's utils/download_model.py.

The reference fetches a ``name,url`` CSV of published model checkpoints from
GCS with ``wget`` and downloads each one, skipping files already present.
This implementation uses only the stdlib (``urllib``), so it also accepts
``file://`` description URLs — which is how it is tested in the zero-egress
build environment. Downloaded ``.pkl`` torch checkpoints are directly usable
via ``-m/--model_path`` (converted on load by models/torch_convert.py).
"""

from __future__ import annotations

import os
import sys
import urllib.error
import urllib.parse
import urllib.request
from datetime import datetime

DEFAULT_DESCRIPTION_URL = ("https://storage.googleapis.com/kishwar-helen/"
                           "models_pepper/pepper_model_description.csv")


def _log(message: str) -> None:
    stamp = datetime.now().strftime("%m-%d-%Y %H:%M:%S")
    sys.stderr.write(f"[{stamp}] INFO: {message}\n")
    sys.stderr.flush()


def download_models(output_dir: str,
                    description_url: str = DEFAULT_DESCRIPTION_URL
                    ) -> list[str]:
    """Fetch the model-description CSV and download every listed model.

    Returns the list of local paths (existing or downloaded). Mirrors the
    reference flow: description CSV of ``model_name,model_url`` lines;
    models already present as ``<model_name>.pkl`` are skipped
    (download_model.py:20-22).
    """
    os.makedirs(output_dir, exist_ok=True)
    try:
        with urllib.request.urlopen(description_url) as resp:
            lines = resp.read().decode().splitlines()
    except (urllib.error.URLError, OSError) as exc:
        _log(f"COULD NOT FETCH MODEL DESCRIPTION: {description_url}")
        _log(f"REASON: {exc}")
        _log("This environment appears to have no network access. "
             "Download the models on a connected machine and pass the "
             ".pkl to -m/--model_path (converted on load), or train a "
             "native checkpoint with `pepper_tpu_torch train_model`.")
        raise

    downloaded = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        model_name, model_url = line.split(",", 1)
        local = os.path.join(output_dir, model_name + ".pkl")
        if os.path.exists(local):
            _log(f"MODEL EXISTS {model_name}.pkl")
            downloaded.append(local)
            continue
        _log(f"DOWNLOADING FILE: {model_name}.pkl")
        _log(f"DOWNLOADING LINK: {model_url}")
        # download to the URL's basename like wget, then keep the
        # <model_name>.pkl existence contract by preferring that name when
        # the basename already matches it
        basename = os.path.basename(urllib.parse.urlparse(model_url).path)
        target = os.path.join(output_dir, basename or model_name + ".pkl")
        tmp = target + ".part"
        with urllib.request.urlopen(model_url) as resp, open(tmp, "wb") as f:
            while True:
                block = resp.read(1 << 20)
                if not block:
                    break
                f.write(block)
        os.replace(tmp, target)
        downloaded.append(target)
    return downloaded
