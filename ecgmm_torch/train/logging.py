"""Metric log (port of `ecgmm_tpu/train/logging.py`): one JSON line per
epoch in `metrics.jsonl`, with the reference's scalar names, and with
`use_tensorboard` (the default) the same scalars in a TensorBoard event
file beside it, written by `train/tfevents.py` as
`torch.utils.tensorboard.SummaryWriter.add_scalar` writes them."""

from __future__ import annotations

import json
import os
import time
from typing import Dict

from ecgmm_torch.train.tfevents import EventFileWriter


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = EventFileWriter(log_dir) if use_tensorboard else None

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in values.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, float(v), step)
            self._tb.flush()

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
