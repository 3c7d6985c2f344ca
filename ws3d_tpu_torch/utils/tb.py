"""Scalar logging (port of ws3d_tpu/utils/tb.py): every record goes to
LOG_DIR/scalars.jsonl, one JSON object a line ({"step", "ts", key: value});
TensorBoard event files are written beside it when
torch.utils.tensorboard imports (it needs the tensorboard package)."""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class ScalarWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            self._tb = SummaryWriter(log_dir=log_dir)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, step)
        self._jsonl.write(json.dumps({"step": step, "ts": time.time(),
                                      **scalars}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._jsonl.close()
