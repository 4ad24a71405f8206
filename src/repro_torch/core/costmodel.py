"""The part of the cost model the port reaches (copied from
``repro/core/costmodel.py``, the JAX package).

- ``full_act_bytes_per_token``: ``parallel/plans.py::resolve_plan`` sizes
  train-shape microbatches with it;
- ``Hardware`` with an ``H100`` entry (the reference has ``V5E`` and
  ``A100``): the training meter's MFU divides by its peak, chip_smoke.py's
  kernel bounds by its peak and its HBM rate;
- ``count_active_params`` over trees of torch tensors (the reference walks
  JAX pytrees), the N of MFU's 6 N T.

The solver inputs of the reference cost model come with the slices that use
them.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core import tree

ACT_ITEMSIZE = 2  # bf16 activations


def full_act_bytes_per_token(cfg) -> float:
    """The lumped ~34·d bytes/token/layer estimate of the *entire* per-layer
    activation set (the classic transformer accounting) — used for
    microbatch sizing (parallel/plans.py), where transient untagged
    tensors count too."""
    return 34 * cfg.d_model * ACT_ITEMSIZE


@dataclass(frozen=True)
class Hardware:
    peak_flops_bf16: float   # per chip
    hbm_bw: float            # bytes/s per chip


# H100 SXM, the port's card.  Data-sheet values (dense bf16 tensor-core
# peak, HBM3 rate), not yet measured on the card; they assume its full
# 700 W power limit.
H100 = Hardware(peak_flops_bf16=989e12, hbm_bw=3.35e12)


def count_active_params(params) -> int:
    """The N of MFU = 6·N·T for the port's dense models: every parameter of
    the stage slots and the globals except the embedding table (the
    reference's ``count_active_params`` at pp = 1, dp = 1; the MFU
    convention counts non-embedding parameters)."""
    subtrees = [params["stages"]] + [sub for key, sub in params["globals"].items()
                                     if key not in ("embed", "pos")]
    return sum(leaf.numel() for sub in subtrees for leaf in tree.leaves(sub))
