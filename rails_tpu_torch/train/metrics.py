"""Metrics log: machine-parseable JSONL, and TensorBoard scalars where the
writer imports.

Counterpart of `rails_tpu/train/metrics.py`: one JSON record per `write`
(step, wall time, every metric that converts to float, keyed
`<prefix>/<name>`) appended to `<log_dir>/metrics.jsonl`, and the same
scalars through `torch.utils.tensorboard.SummaryWriter` when it imports
(nothing is installed for it). A writer with no `log_dir` writes nothing:
the driver gives one only to the primary process.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsWriter:
    def __init__(self, log_dir: Optional[str]):
        self._tb = None
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:   # the tensorboard package is optional
                return
            self._tb = SummaryWriter(log_dir=log_dir)

    def write(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}/{k}" if prefix else k
            try:
                rec[key] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(key, rec[key], step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
        if self._jsonl is not None:
            self._jsonl.close()
