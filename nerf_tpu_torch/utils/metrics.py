"""Training metrics writer (port of nerf_tpu/utils/metrics.py).

A timestamped run directory ``<base>/<date>/<time>-epoch<N>/``, optionally
emptied first (``-d``).  Every scalar goes to ``metrics.jsonl`` there; to
tensorboard too when ``torch.utils.tensorboard`` imports and it is wanted.
A writer that is not ``enabled`` (a rank other than 0 of the distributed
modes) makes no directory and writes nothing.
"""

from __future__ import annotations

import json
import os
import shutil
import time


def _make_run_dir(base: str, epochs: int, del_dir: bool) -> str:
    if del_dir and os.path.exists(base):
        shutil.rmtree(base)
    stamp = time.localtime()
    day = time.strftime("%Y%m%d", stamp)
    clk = time.strftime("%H%M%S", stamp)
    path = os.path.join(base, day, f"{clk}-epoch{epochs}")
    os.makedirs(path, exist_ok=True)
    return path


class MetricsWriter:
    """Scalar metrics sink: JSONL always, tensorboard if available."""

    def __init__(self, base_dir: str = "./logs", epochs: int = 0,
                 del_dir: bool = False, use_tensorboard: bool = True,
                 enabled: bool = True):
        self.enabled = enabled
        if not enabled:
            return
        self.run_dir = _make_run_dir(base_dir, epochs, del_dir)
        self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=self.run_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value, step: int) -> None:
        if not self.enabled:
            return
        value = float(value)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": value, "step": int(step), "ts": time.time()}
        ) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def read_scalars(path: str, tag: str):
    """[(step, value)] of ``tag`` in a ``metrics.jsonl``, in file order."""
    out = []
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["tag"] == tag:
                out.append((rec["step"], rec["value"]))
    return out
