"""HDF5 inter-stage stores, layout-compatible with the reference
(DataStore.py:54-99, DataStorePredict.py:49-98) and with the JAX
package's io/datastore.py, so make_images / run_inference /
find_candidates interoperate as standalone subcommands and the files of
either package read in the other.  call_variant and polish never open a
store: h5py is imported when a store is opened, never at import, and its
absence raises an ImportError naming the paths that need it."""

from __future__ import annotations

import ast

import numpy as np

NEEDS_H5PY = ("the staged subcommands (make_images, run_inference, "
              "find_candidates; polish make_images, call_consensus, stitch), "
              "the training subcommands of both CLIs (make_train_images, "
              "train_model, test_model, run_hyperband), utils/merge_images "
              "and the sharded paths (call_variant --sharded, "
              "polish_sharded)")


def require_h5py():
    """h5py, or an ImportError that says which paths need it."""
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            f"h5py is not installed: {NEEDS_H5PY} write and read HDF5 "
            "files and need it; call_variant and polish run without "
            "it") from exc
    return h5py


class ImageStore:
    """summaries/<name>/{contigs,positions,depths,candidates,
    candidate_frequency,images[,base_labels,type_label]}"""

    def __init__(self, filename: str, mode: str = "r"):
        self.filename = filename
        self.file_handler = require_h5py().File(filename, mode)
        self._names: set[str] = set()

    def close(self):
        self.file_handler.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def write_summary(self, summary_name: str, windows, train_mode: bool):
        if summary_name in self._names or not windows:
            return
        self._names.add(summary_name)
        grp = f"summaries/{summary_name}"
        dt = require_h5py().special_dtype(vlen=str)
        fh = self.file_handler
        fh[f"{grp}/contigs"] = np.array([w.contig for w in windows],
                                        dtype="S")
        fh[f"{grp}/positions"] = np.array([w.position for w in windows],
                                          np.int32)
        fh[f"{grp}/depths"] = np.array([w.depth for w in windows], np.uint8)
        fh[f"{grp}/candidates"] = np.array(
            [str(w.candidates) for w in windows], dtype=dt)
        fh[f"{grp}/candidate_frequency"] = np.array(
            [str(w.candidate_frequency) for w in windows], dtype=dt)
        fh[f"{grp}/images"] = np.array([w.image for w in windows], np.int8)
        if train_mode:
            fh[f"{grp}/base_labels"] = np.array(
                [w.base_label for w in windows], np.uint8)
            fh[f"{grp}/type_label"] = np.array(
                [w.type_label for w in windows], np.uint8)

    def summary_names(self):
        if "summaries" not in self.file_handler:
            return []
        return list(self.file_handler["summaries"].keys())

    def read_summary(self, summary_name: str, train_mode: bool = False):
        from ..ops.pileup_ref import CandidateWindow

        grp = self.file_handler[f"summaries/{summary_name}"]
        contigs = [c.decode() for c in grp["contigs"][()]]
        positions = grp["positions"][()]
        depths = grp["depths"][()]
        candidates = [_parse_str_list(c) for c in grp["candidates"][()]]
        frequencies = [_parse_int_list(c)
                       for c in grp["candidate_frequency"][()]]
        images = grp["images"][()]
        base_labels = (grp["base_labels"][()] if "base_labels" in grp
                       else np.zeros(len(contigs), np.uint8))
        type_labels = (grp["type_label"][()] if "type_label" in grp
                       else np.zeros(len(contigs), np.uint8))
        return [
            CandidateWindow(
                contig=contigs[i], position=int(positions[i]),
                depth=int(depths[i]), candidates=candidates[i],
                candidate_frequency=frequencies[i],
                image=images[i].astype(np.int32),
                base_label=int(base_labels[i]),
                type_label=int(type_labels[i]))
            for i in range(len(contigs))
        ]


def _parse_str_list(value) -> list[str]:
    """Parse a candidate list: either our stringified form ("['1T']") or
    the reference's (N, 1) vlen-str rows, which arrive as arrays/lists
    (CandidateFinder.py:374-377 does the equivalent str-mangling)."""
    if isinstance(value, (list, tuple, np.ndarray)):
        return [x.decode() if isinstance(x, bytes) else str(x)
                for x in np.asarray(value).ravel()]
    if isinstance(value, bytes):
        value = value.decode()
    parsed = ast.literal_eval(value)
    return [str(x) for x in parsed]


def _parse_int_list(value) -> list[int]:
    if isinstance(value, (list, tuple, np.ndarray)):
        return [int(x) for x in np.asarray(value).ravel()]
    if isinstance(value, bytes):
        value = value.decode()
    return [int(x) for x in ast.literal_eval(value)]


class PredictionStore:
    """predictions/batch_<n>/{contigs,positions,depths,candidates,
    candidate_frequency,base_prediction}"""

    def __init__(self, filename: str, mode: str = "r"):
        self.filename = filename
        self.file_handler = require_h5py().File(filename, mode)
        self._names: set[str] = set()

    def close(self):
        self.file_handler.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def write_prediction(self, batch_no, predictions):
        name = f"batch_{batch_no}"
        if name in self._names or not predictions:
            return
        if f"predictions/{name}" in self.file_handler:  # resumed run
            return
        self._names.add(name)
        grp = f"predictions/{name}"
        dt = require_h5py().special_dtype(vlen=str)
        fh = self.file_handler
        fh[f"{grp}/contigs"] = np.array([p.contig for p in predictions],
                                        dtype="S")
        fh[f"{grp}/positions"] = np.array([p.position for p in predictions],
                                          np.int32)
        fh[f"{grp}/depths"] = np.array([p.depth for p in predictions],
                                       np.uint8)
        fh[f"{grp}/candidates"] = np.array(
            [str(p.candidates) for p in predictions], dtype=dt)
        fh[f"{grp}/candidate_frequency"] = np.array(
            [str(p.candidate_frequency) for p in predictions], dtype=dt)
        fh[f"{grp}/base_prediction"] = np.array(
            [p.prediction_base for p in predictions], np.float64)

    def write_prediction_hp(self, contig, contig_start, contig_end, chunk_id,
                            position, index, base_predictions_hp1,
                            base_predictions_hp2):
        """HP-mode prediction layout, reference-compatible
        (DataStorePredict.py:69-98): keyed predictions/<contig>/
        <contig-start-end>/<chunk_id>/{position,index,
        base_predictions_hp1,base_predictions_hp2}, votes stored int16."""
        prefix = f"{contig}-{int(contig_start)}-{int(contig_end)}"
        fh = self.file_handler
        region = f"predictions/{contig}/{prefix}"
        if f"{region}/contig_start" not in fh:
            fh[f"{region}/contig_start"] = int(contig_start)
            fh[f"{region}/contig_end"] = int(contig_end)
        chunk = f"{region}/{int(chunk_id)}"
        if f"{chunk}/position" in fh:   # resumed run
            return
        fh[f"{chunk}/position"] = np.asarray(position, np.int32)
        fh[f"{chunk}/index"] = np.asarray(index, np.int32)
        fh[f"{chunk}/base_predictions_hp1"] = np.asarray(
            base_predictions_hp1, np.int16)
        fh[f"{chunk}/base_predictions_hp2"] = np.asarray(
            base_predictions_hp2, np.int16)

    def read_prediction_hp(self, contig, contig_start, contig_end, chunk_id):
        prefix = f"{contig}-{int(contig_start)}-{int(contig_end)}"
        grp = self.file_handler[
            f"predictions/{contig}/{prefix}/{int(chunk_id)}"]
        return (grp["position"][()], grp["index"][()],
                grp["base_predictions_hp1"][()],
                grp["base_predictions_hp2"][()])

    def hp_chunk_keys(self):
        """All (contig, contig_start, contig_end, chunk_id) tuples present."""
        keys = []
        if "predictions" not in self.file_handler:
            return keys
        preds = self.file_handler["predictions"]
        for contig in preds:
            node = preds[contig]
            if not isinstance(node, require_h5py().Group):
                continue
            for prefix in node:
                region = node[prefix]
                if "contig_start" not in region:
                    continue
                start = int(region["contig_start"][()])
                end = int(region["contig_end"][()])
                for name in region:
                    if name in ("contig_start", "contig_end"):
                        continue
                    keys.append((contig, start, end, int(name)))
        return keys

    def batch_names(self):
        if "predictions" not in self.file_handler:
            return []
        return list(self.file_handler["predictions"].keys())

    def read_batch(self, name: str):
        from ..decode.candidate_finder import CandidatePrediction

        grp = self.file_handler[f"predictions/{name}"]
        contigs = [c.decode() for c in grp["contigs"][()]]
        positions = grp["positions"][()]
        depths = grp["depths"][()]
        candidates = [_parse_str_list(c) for c in grp["candidates"][()]]
        frequencies = [_parse_int_list(c)
                       for c in grp["candidate_frequency"][()]]
        base_predictions = grp["base_prediction"][()]
        return [
            CandidatePrediction(
                contig=contigs[i], position=int(positions[i]),
                depth=int(depths[i]), candidates=candidates[i],
                candidate_frequency=frequencies[i],
                prediction_base=base_predictions[i])
            for i in range(len(contigs))
        ]
