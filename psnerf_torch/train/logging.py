"""Training metrics as a JSONL stream (counterpart of
psnerf_tpu/train/logging.py `MetricLogger`): one {"it", "wall", **scalars}
object per line. The TensorBoard mirror comes with a later slice."""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, it: int, scalars: dict) -> None:
        rec = {"it": int(it), "wall": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            if v is None:
                continue
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                pass
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()
