"""The part of the cost model the port's planner reaches.

A copy of ``full_act_bytes_per_token`` from ``repro/core/costmodel.py`` (the
JAX package): ``parallel/plans.py::resolve_plan`` sizes train-shape
microbatches with it.  The rest of the reference cost model (hardware
constants, solver inputs) comes with the slices that use it.
"""
from __future__ import annotations

ACT_ITEMSIZE = 2  # bf16 activations


def full_act_bytes_per_token(cfg) -> float:
    """The lumped ~34·d bytes/token/layer estimate of the *entire* per-layer
    activation set (the classic transformer accounting) — used for
    microbatch sizing (parallel/plans.py), where transient untagged
    tensors count too."""
    return 34 * cfg.d_model * ACT_ITEMSIZE
