"""The part of the cost model the port reaches (copied from
``repro/core/costmodel.py``, the JAX package).

- ``full_act_bytes_per_token``: ``parallel/plans.py::resolve_plan`` sizes
  train-shape microbatches with it;
- ``Hardware`` with an ``H100`` entry: the training meter's MFU divides by
  its peak, chip_smoke.py's kernel bounds by its peak and its HBM rate, and
  ``parallel/runner.py::resolve_cell`` sizes the offload ratios with its
  peak and its host-link rate (DESIGN.md §5.2, §10);
- the offload planner's unit of account: ``tagged_bytes_per_token``,
  ``chunk_act_bytes`` and ``BWD_RATIO`` (rows move uncompressed: the codecs
  are ROADMAP Queue 1 item 6);
- ``count_active_params``, the N of MFU's 6 N T, over a tree of torch
  tensors or, before any parameter exists, over a ``ModelDef``'s shapes.

The solver inputs of the reference cost model come with the slices that use
them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import tree

ACT_ITEMSIZE = 2  # bf16 activations

# backward/forward FLOPs split of the lumped 6N train convention (2N fwd,
# 4N bwd): the D2H hiding window of §5.2 is the *forward* compute of the
# next chunk, so offload planning divides lumped chunk times by (1 + this)
BWD_RATIO = 2.0


@dataclass(frozen=True)
class Hardware:
    peak_flops_bf16: float   # per chip
    hbm_bw: float            # bytes/s per chip
    d2h_bw: float            # bytes/s of the host offload link, each way


# H100 SXM, the port's card.  Data-sheet values (dense bf16 tensor-core
# peak, HBM3 rate, PCIe Gen5 x16 at 64 GB/s each way), not measured on the
# card; they assume its full 700 W power limit.  chip_smoke.py prints the
# pinned copy rates it measures beside d2h_bw and leaves the constant as is.
H100 = Hardware(peak_flops_bf16=989e12, hbm_bw=3.35e12, d2h_bw=64e9)


def full_act_bytes_per_token(cfg) -> float:
    """The lumped ~34·d bytes/token/layer estimate of the *entire* per-layer
    activation set (the classic transformer accounting) — used for
    microbatch sizing (parallel/plans.py), where transient untagged
    tensors count too.  The offload planner budgets the tagged subset
    (``tagged_bytes_per_token``) instead."""
    return 34 * cfg.d_model * ACT_ITEMSIZE


def tagged_bytes_per_token(cfg) -> float:
    """Per-layer bytes/token of the *tagged* Type-1 set of the port's dense
    decoders: q, k, v after RoPE, the attention output before ``@ wo`` and
    the MLP hidden before ``@ w2`` (the tag sites of models/attention.py and
    models/layers.py), bf16."""
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = H * hd + 2 * Hkv * hd + H * hd         # q, k, v, out
    return (attn + cfg.d_ff) * ACT_ITEMSIZE


def chunk_act_bytes(cfg, lengths, *, batch: int, pp: int, sp: int,
                    grad_accum: int = 1) -> list:
    """Per-chunk, per-device tagged Type-1 activation bytes for one stage:
    every tag site sees the *local* (sequence-sharded) shard, so bytes
    divide by sp; a stage holds n_layers/pp layers; grad accumulation
    shrinks the resident microbatch."""
    per_tok = tagged_bytes_per_token(cfg) * (cfg.n_layers / pp) / sp
    b = batch / max(grad_accum, 1)
    return [per_tok * b * ln for ln in lengths]


def count_active_params(params) -> int:
    """The N of MFU = 6·N·T for the port's dense models: every parameter of
    the stage slots and the globals except the embedding table (the
    reference's ``count_active_params`` at pp = 1, dp = 1; the MFU
    convention counts non-embedding parameters).

    ``params`` is a parameter tree, or a ``ModelDef`` whose shapes are
    counted before any parameter exists (``resolve_cell`` needs N to size
    the offload ratios): its parameters are built on the meta device, which
    allocates nothing."""
    if not isinstance(params, dict):
        gen = torch.Generator()
        params = {"stages": params.init_stage_params(gen, device="meta"),
                  "globals": params.init_globals(gen, device="meta")}
    subtrees = [params["stages"]] + [sub for key, sub in params["globals"].items()
                                     if key not in ("embed", "pos")]
    return sum(leaf.numel() for sub in subtrees for leaf in tree.leaves(sub))
