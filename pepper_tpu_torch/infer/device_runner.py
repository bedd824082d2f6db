"""Fused device-window inference (`--device_pileup`): native int8 region
images go to the device and the window gather + feature injection +
classifier run there, one classify_regions_images call per region batch
(ops/device_windows.py).  The host default assembles window images in the
summarizer instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..decode.candidate_finder import CandidatePrediction
from ..device import resolve_device
from ..models.params import map_params, params_from_jax
from ..ops.device_windows import classify_regions_images


class DeviceRegionRunner:
    """Consumes RegionPackage batches, returns CandidatePrediction lists
    (the same contract as InferenceRunner.predict over windows), on
    `device`: cuda unless the caller asks for another."""

    def __init__(self, params, compute_dtype: str = "float32",
                 region_batch: int = 32, features: int = 26, device=None):
        self.device = resolve_device(device)
        self.compute_dtype = (torch.bfloat16 if compute_dtype == "bfloat16"
                              else torch.float32)
        self.region_batch = region_batch
        self.features = features
        # device-resident in the compute dtype once, so a batch moves only
        # the region images and the descriptors
        self.params = map_params(lambda p: p.to(self.compute_dtype),
                                 params_from_jax(params, self.device))

    def predict(self, packages) -> list[CandidatePrediction]:
        predictions: list[CandidatePrediction] = []
        for i in range(0, len(packages), self.region_batch):
            predictions.extend(self._predict_batch(
                packages[i:i + self.region_batch]))
        return predictions

    def _predict_batch(self, packages):
        if not packages:
            return []
        probs = classify_regions_images(
            self.params, [p.image for p in packages],
            [p.descriptors for p in packages],
            [p.region_rows for p in packages],
            compute_dtype=self.compute_dtype,
            device=self.device).cpu().numpy()

        predictions = []
        index = 0
        for package in packages:
            for window in package.windows:
                predictions.append(CandidatePrediction(
                    contig=window.contig, position=window.position,
                    depth=window.depth, candidates=window.candidates,
                    candidate_frequency=window.candidate_frequency,
                    prediction_base=probs[index].astype(np.float64)))
                index += 1
        assert index == len(probs)
        return predictions
