"""Scalar, histogram and text log writer (counterpart of
``paddle_tpu/utils/log_writer.py``), in the reference's file format: one
JSON line a record in ``{logdir}/{file_name}`` (default
``paddle_tpu_log.{pid}.jsonl``), and one ``{tag}.tsv`` of ``step\\tvalue``
lines a scalar tag (``/`` in a tag written as ``_``)."""

from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["LogWriter"]


class LogWriter:
    def __init__(self, logdir: str, file_name: str = "", **kwargs):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._path = os.path.join(logdir, file_name or f"paddle_tpu_log.{os.getpid()}.jsonl")
        self._f = open(self._path, "a", buffering=1)
        self._tsv: dict = {}

    def _write(self, rec: dict):
        self._f.write(json.dumps(rec) + "\n")

    def add_scalar(self, tag: str, value, step: int, walltime=None):
        self._write({"kind": "scalar", "tag": tag, "value": float(value), "step": int(step),
                     "ts": walltime or time.time()})
        tsv = self._tsv.get(tag)
        if tsv is None:
            tsv = open(os.path.join(self.logdir, f"{tag.replace('/', '_')}.tsv"), "a",
                       buffering=1)
            self._tsv[tag] = tsv
        tsv.write(f"{int(step)}\t{float(value)}\n")

    def add_histogram(self, tag: str, values, step: int, buckets: int = 10, walltime=None):
        arr = np.asarray(values, dtype=np.float64).ravel()
        hist, edges = np.histogram(arr, bins=buckets)
        self._write({"kind": "histogram", "tag": tag, "step": int(step),
                     "counts": hist.tolist(), "edges": edges.tolist(),
                     "min": float(arr.min()) if arr.size else 0.0,
                     "max": float(arr.max()) if arr.size else 0.0,
                     "mean": float(arr.mean()) if arr.size else 0.0,
                     "ts": walltime or time.time()})

    def add_text(self, tag: str, text: str, step: int, walltime=None):
        self._write({"kind": "text", "tag": tag, "text": str(text), "step": int(step),
                     "ts": walltime or time.time()})

    def scalars(self, tag: str) -> list[tuple[int, float]]:
        """The (step, value) pairs written under ``tag``, from the file."""
        out = []
        with open(self._path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("kind") == "scalar" and rec.get("tag") == tag:
                    out.append((rec["step"], rec["value"]))
        return out

    def flush(self):
        self._f.flush()
        for t in self._tsv.values():
            t.flush()

    def close(self):
        self.flush()
        self._f.close()
        for t in self._tsv.values():
            t.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
