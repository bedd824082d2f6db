"""Training-image merge helpers (reference
pepper_variant/modules/python/helper/merge_train_images.py:23-47).

The reference helper builds a flat *index* HDF5 mapping a global record id
to "source_file,region_name,image_index" so a lazy dataset can sample
across many per-worker image files.  `merge_image_index` reproduces that;
`merge_image_stores` additionally offers a physical merge (one file, all
summary groups copied) which is the friendlier shape for the eager input
pipeline (train/data.py loads whole stores into host RAM and feeds
fixed-size device batches).  A copy of the JAX package's
utils/merge_images.py; h5py is imported when a function runs
(io/datastore.py:require_h5py).
"""

from __future__ import annotations

import os

from ..io.datastore import require_h5py


def image_files_in(directory: str):
    """All .hdf/.hdf5 files in a directory (helper
    merge_train_images.py:12-20)."""
    out = []
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if os.path.isfile(path) and (name.endswith(".hdf")
                                     or name.endswith(".hdf5")):
            out.append(path)
    return out


def merge_image_index(input_directory: str, output_path: str) -> int:
    """Build the reference-style flat index: key <record_id> ->
    "file,region,image_index".  Returns the record count."""
    h5py = require_h5py()
    record_index = 0
    with h5py.File(output_path, "w") as out:
        for path in image_files_in(input_directory):
            with h5py.File(path, "r") as fh:
                if "summaries" not in fh:
                    continue
                for region_name in fh["summaries"]:
                    n = fh["summaries"][region_name]["images"].shape[0]
                    for image_index in range(n):
                        out[str(record_index)] = \
                            f"{path},{region_name},{image_index}"
                        record_index += 1
    return record_index


def read_indexed_record(index_path: str, record_id: int):
    """Resolve one index entry to (file, region, image_index)."""
    h5py = require_h5py()
    with h5py.File(index_path, "r") as fh:
        value = fh[str(record_id)][()]
    if isinstance(value, bytes):
        value = value.decode()
    path, region, image_index = value.rsplit(",", 2)
    return path, region, int(image_index)


def merge_image_stores(input_directory: str, output_path: str) -> int:
    """Physically merge every summary group from every store into one file
    (group names prefixed with the source file index to stay unique).
    Returns the number of groups copied."""
    h5py = require_h5py()
    copied = 0
    with h5py.File(output_path, "w") as out:
        for i, path in enumerate(image_files_in(input_directory)):
            with h5py.File(path, "r") as fh:
                if "summaries" not in fh:
                    continue
                for region_name in fh["summaries"]:
                    fh.copy(f"summaries/{region_name}", out,
                            f"summaries/f{i}_{region_name}")
                    copied += 1
    return copied
