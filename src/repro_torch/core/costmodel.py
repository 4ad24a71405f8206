"""The part of the cost model the port reaches (copied from
``repro/core/costmodel.py``, the JAX package).

- ``full_act_bytes_per_token``: ``parallel/plans.py::resolve_plan`` sizes
  train-shape microbatches with it;
- ``Hardware`` with an ``H100`` entry: the training meter's MFU divides by
  its peak, chip_smoke.py's kernel bounds by its peak and its HBM rate, and
  ``parallel/runner.py::resolve_cell`` sizes the offload ratios with its
  peak and its host-link rate (DESIGN.md §5.2, §10);
- the offload planner's unit of account: ``tagged_bytes_per_token``,
  ``chunk_act_bytes`` and ``BWD_RATIO``; under a codec (DESIGN.md §14)
  ``codec_itemsize`` and ``offload_wire_ratio`` (the payload crosses the
  link, ``resolve_cell`` plans α at the effective link rate) and
  ``tagged_scale_elems_per_token`` / ``chunk_scale_bytes`` (the per-row
  scales, which stay on the device);
- the optimizer-moment channel (DESIGN.md §11, §14): ``moment_bytes_per_param``,
  ``opt_state_bytes``, ``moment_bytes_from_shapes`` and
  ``moment_wire_bytes_per_param``, the closed forms the moment copies of
  ``optim/adamw.py`` are held to.  The port's moments are fp32 (its bf16
  moments would be deepseek's, not yet a model of the port), so
  ``opt_dtype`` takes "float32" alone;
- ``count_active_params``, the N of MFU's 6 N T, over a tree of torch
  tensors or, before any parameter exists, over a ``ModelDef``'s shapes.

The solver inputs of the reference cost model come with the slices that use
them.
"""
from __future__ import annotations

import math
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


def tagged_scale_elems_per_token(cfg) -> float:
    """Per-layer *scale elements* per token of the compressed channel
    (DESIGN.md §14): one fp32 scale per trailing-axis row of each tag site,
    q [B,T,H,hd] -> H, k / v [B,T,Hkv,hd] -> Hkv each, the attention output
    [B,T,H*hd] -> 1 and the MLP hidden [B,T,d_ff] -> 1."""
    return float(cfg.n_heads + 2 * cfg.n_kv_heads + 1 + 1)


SCALE_ITEMSIZE = 4  # per-row scales are fp32


def codec_itemsize(offload_dtype: str = "none") -> int:
    """Wire bytes per element of the off-row payload under a codec
    (ACT_ITEMSIZE uncompressed)."""
    if offload_dtype in (None, "none"):
        return ACT_ITEMSIZE
    if offload_dtype not in ("fp8", "int8"):
        raise ValueError(f"unknown offload codec {offload_dtype!r}")
    return 1


def offload_wire_ratio(offload_dtype: str = "none") -> float:
    """Link bytes of the compressed off rows over their raw bytes: the
    scales stay on the device, so the ratio is the itemsize ratio."""
    return codec_itemsize(offload_dtype) / ACT_ITEMSIZE


def chunk_scale_bytes(cfg, lengths, *, batch: int, pp: int, sp: int,
                      grad_accum: int = 1, offload_dtype: str = "none") -> list:
    """Per-chunk, per-device bytes of the device-resident codec scales of
    the whole tagged set (zero uncompressed); the caller scales them by the
    chunk's α as it does the off rows."""
    if offload_dtype in (None, "none"):
        return [0.0 for _ in lengths]
    per_tok = (tagged_scale_elems_per_token(cfg) * SCALE_ITEMSIZE
               * (cfg.n_layers / pp) / sp)
    b = batch / max(grad_accum, 1)
    return [per_tok * b * ln for ln in lengths]


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


# ---------------------------------------------------------------------------
# Optimizer-state (AdamW moment) bytes
# ---------------------------------------------------------------------------

_OPT_ITEMSIZE = {"float32": 4}


def moment_bytes_per_param(opt_dtype="float32") -> float:
    """AdamW first and second moment bytes per parameter."""
    return 2.0 * _OPT_ITEMSIZE[opt_dtype]


def opt_state_bytes(n_params: int, opt_dtype="float32") -> float:
    """AdamW moment bytes of ``n_params`` parameters: what one update's
    moment copies move each way with fp32 moments in host memory."""
    return n_params * moment_bytes_per_param(opt_dtype)


def moment_bytes_from_shapes(shapes, opt_dtype="float32",
                             moments_dtype: str = "none") -> float:
    """Host-resident moment bytes of these leaf shapes, which one update
    also copies each way: the closed form above uncompressed; under a codec
    1 payload byte per element plus one fp32 scale per trailing-axis row,
    for each of m and v (the moment channel's scales live on the host)."""
    n = sum(math.prod(s) for s in shapes)
    if moments_dtype in (None, "none"):
        return opt_state_bytes(n, opt_dtype)
    if moments_dtype not in ("fp8", "int8"):
        raise ValueError(f"unknown offload codec {moments_dtype!r}")
    rows = sum(math.prod(s[:-1]) for s in shapes)
    return 2.0 * (n * 1 + rows * SCALE_ITEMSIZE)


def moment_wire_bytes_per_param(opt_dtype="float32", moments_dtype: str = "none",
                                *, row_len: int = 1024) -> float:
    """Per-parameter bytes of one update's moment round trip each way for a
    parameter count (no shapes): compressed, 1 payload byte plus the scale
    bytes amortized over a ``row_len``-long trailing axis."""
    if moments_dtype in (None, "none"):
        return moment_bytes_per_param(opt_dtype)
    if moments_dtype not in ("fp8", "int8"):
        raise ValueError(f"unknown offload codec {moments_dtype!r}")
    return 2.0 * (1.0 + SCALE_ITEMSIZE / max(1, row_len))


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
