"""Polish-mode HDF5 stores, layout-compatible with the reference
(pepper/modules/python/DataStore.py:53-67, DataStorePredict.py:49-77) and
with the JAX package's polish/datastore.py.  h5py is imported when a store
is opened (io/datastore.py:require_h5py), so polish runs without it."""

from __future__ import annotations

import numpy as np

from ..io.datastore import require_h5py


class PolishImageStore:
    """summaries/<name>/{image,label,position,index,contig,region_start,
    region_end,chunk_id}"""

    def __init__(self, filename: str, mode: str = "r"):
        self.file_handler = require_h5py().File(filename, mode)
        self._names: set[str] = set()

    def close(self):
        self.file_handler.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def write_summary(self, region, image, label, position, index,
                      chunk_id, summary_name):
        if summary_name in self._names:
            return
        self._names.add(summary_name)
        contig_name, region_start, region_end = region
        grp = f"summaries/{summary_name}"
        fh = self.file_handler
        fh[f"{grp}/image"] = np.asarray(image, np.uint8)
        fh[f"{grp}/label"] = np.asarray(label, np.uint8)
        fh[f"{grp}/position"] = np.asarray(position, np.int64)
        fh[f"{grp}/index"] = np.asarray(index, np.int64)
        fh[f"{grp}/contig"] = contig_name
        fh[f"{grp}/region_start"] = region_start
        fh[f"{grp}/region_end"] = region_end
        fh[f"{grp}/chunk_id"] = chunk_id

    def summary_names(self):
        if "summaries" not in self.file_handler:
            return []
        return list(self.file_handler["summaries"].keys())

    def read_summary(self, name: str):
        grp = self.file_handler[f"summaries/{name}"]
        contig = grp["contig"][()]
        if isinstance(contig, bytes):
            contig = contig.decode()
        return dict(
            contig=contig,
            region_start=int(grp["region_start"][()]),
            region_end=int(grp["region_end"][()]),
            chunk_id=int(grp["chunk_id"][()]),
            image=grp["image"][()],
            label=grp["label"][()],
            position=grp["position"][()],
            index=grp["index"][()],
        )


class PolishPredictionStore:
    """predictions/<contig>/<contig-start-end>/{contig_start,contig_end,
    <chunk_id>/{position,index,bases,phred_score}}"""

    def __init__(self, filename: str, mode: str = "r"):
        self.file_handler = require_h5py().File(filename, mode)
        self._prefixes: set[str] = set()
        self._names: set[str] = set()

    def close(self):
        self.file_handler.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def write_prediction(self, contig, contig_start, contig_end, chunk_id,
                         position, index, predicted_bases, phred_score):
        prefix = f"{contig}-{contig_start}-{contig_end}"
        name = f"{contig}{prefix}{chunk_id}"
        fh = self.file_handler
        if prefix not in self._prefixes:
            self._prefixes.add(prefix)
            fh[f"predictions/{contig}/{prefix}/contig_start"] = contig_start
            fh[f"predictions/{contig}/{prefix}/contig_end"] = contig_end
        if name in self._names:
            return
        self._names.add(name)
        base = f"predictions/{contig}/{prefix}/{chunk_id}"
        if base in self.file_handler:  # resumed run re-emitting a chunk
            return
        fh[f"{base}/position"] = np.asarray(position, np.int64)
        fh[f"{base}/index"] = np.asarray(index, np.int64)
        fh[f"{base}/bases"] = np.asarray(predicted_bases, np.uint8)
        fh[f"{base}/phred_score"] = np.asarray(phred_score, np.uint8)

    def contigs(self):
        if "predictions" not in self.file_handler:
            return []
        return list(self.file_handler["predictions"].keys())

    def chunk_groups(self, contig):
        """Yields (prefix, contig_start, contig_end, chunk_records) where
        chunk_records are (region_start, positions (L,2), labels)."""
        grp = self.file_handler[f"predictions/{contig}"]
        for prefix in sorted(grp.keys()):
            sub = grp[prefix]
            contig_start = int(sub["contig_start"][()])
            contig_end = int(sub["contig_end"][()])
            records = []
            # lexical (string) sort — the reference's quirk (Stitch.py:50
            # sorts HDF5 keys as strings), which decides override order
            # when overlapping chunks disagree and chunk ids reach 10+
            chunk_keys = sorted(
                k for k in sub.keys()
                if k not in ("contig_start", "contig_end"))
            for chunk_key in chunk_keys:
                chunk = sub[chunk_key]
                positions = np.stack([chunk["position"][()],
                                      chunk["index"][()]], axis=1)
                records.append((contig_start, positions,
                                chunk["bases"][()]))
            yield prefix, contig_start, contig_end, records
