"""Structured metrics logging (JSONL).

The counterpart of :mod:`plasma_control_tpu.utils.metrics`: an append-only
writer that streams structured records (per-step energies, per-episode
losses, solve throughput) to a JSONL file, one record per line. Tensors are
written as lists, from whatever device they lie on.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["MetricsLogger"]


def _jsonable(v: Any):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().tolist()
    if isinstance(v, (np.ndarray, np.generic)):
        return v.tolist()
    return v


class MetricsLogger:
    """Append-only JSONL metrics writer.

    >>> log = MetricsLogger("out/metrics.jsonl", run="feedback")
    >>> log.log("step", t=1, pe=0.5)
    """

    def __init__(self, path: Optional[str], **common):
        self.path = path
        self.common = common
        self._fh = None
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, kind: str, **fields):
        rec: Dict[str, Any] = {"kind": kind, "ts": time.time(), **self.common}
        rec.update({k: _jsonable(v) for k, v in fields.items()})
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        return rec

    def log_series(self, kind: str, series: Dict[str, Any], chunk: int = 0):
        """Log aligned 1D series (e.g. PE(t), H(t)) as one record."""
        return self.log(kind, chunk=chunk, **{k: _jsonable(v) for k, v in series.items()})

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
