"""Training data loading: eager full-load of HDF5 image stores into RAM
(the reference's SequenceDataset, dataloader.py:44-93), returned as flat
numpy arrays ready to split over devices.  The stores need h5py, which
io/datastore.py imports when one opens."""

from __future__ import annotations

import os

import numpy as np

from ..io.datastore import ImageStore


def load_image_dir(image_dir: str):
    """Load every summary from every .hdf5 file under image_dir ->
    (images float32 (N,T,F), type_labels int32 (N,), base_labels int32)."""
    images, type_labels, base_labels = [], [], []
    files = sorted(os.path.join(image_dir, f) for f in os.listdir(image_dir)
                   if f.endswith((".hdf5", ".h5")))
    for path in files:
        with ImageStore(path, "r") as store:
            for name in store.summary_names():
                grp = store.file_handler[f"summaries/{name}"]
                images.append(grp["images"][()].astype(np.float32))
                n = len(images[-1])
                if "type_label" in grp:
                    type_labels.append(grp["type_label"][()].astype(np.int32))
                else:
                    type_labels.append(np.zeros(n, np.int32))
                if "base_labels" in grp:
                    base_labels.append(
                        grp["base_labels"][()].astype(np.int32))
                else:
                    base_labels.append(np.zeros(n, np.int32))
    if not images:
        raise ValueError(f"no training images found under {image_dir}")
    return (np.concatenate(images), np.concatenate(type_labels),
            np.concatenate(base_labels))


def batch_iterator(images, labels, batch_size: int, rng: np.random.RandomState,
                   shuffle: bool = True, drop_last: bool = False):
    n = len(images)
    order = rng.permutation(n) if shuffle else np.arange(n)
    for start in range(0, n, batch_size):
        index = order[start:start + batch_size]
        if drop_last and len(index) < batch_size:
            break
        yield images[index], labels[index]
