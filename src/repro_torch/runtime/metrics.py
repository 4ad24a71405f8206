"""Training metrics: tokens/s on the one chip (the paper's TGS), MFU, step
times (port of ``repro/runtime/metrics.py``, on the H100's peak).

The caller times work that has finished on the device: it synchronizes (or
reads a result back) before ``stop``.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.costmodel import H100


@dataclass
class Meter:
    tokens_per_step: int
    n_active_params: int
    history: list = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int, loss: float) -> dict:
        dt = time.perf_counter() - self._t0
        tgs = self.tokens_per_step / dt  # tokens/chip/s (§7), one chip
        mfu = (6 * self.n_active_params * self.tokens_per_step / dt
               / H100.peak_flops_bf16)
        rec = {"step": step, "loss": float(loss), "dt": dt,
               "tgs": tgs, "mfu": mfu}
        self.history.append(rec)
        return rec

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.history, f, indent=1)
