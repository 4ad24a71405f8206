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
  tensors or, before any parameter exists, over a ``ModelDef``'s shapes;
- the solver's and simulator's inputs (DESIGN.md §3, §15): the attention
  FLOPs and backward bytes, ``effective_bwd_ratio``, the 6 N / 2 N
  convention, ``chunk_time_est``, the KV-cache and ring-hop bytes and
  ``stage_attn_demand``, with ``Hardware``'s link, memory and launch fields.
  The port defines the H100 alone; a test that replays the reference's TPU
  traces builds its ``Hardware`` from the reference's numbers.
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
    name: str
    peak_flops_bf16: float      # per chip
    hbm_bw: float               # bytes/s per chip
    ici_bw: float               # bytes/s of one chip-to-chip link, each way
    d2h_bw: float               # bytes/s of the host offload link, each way
    hbm_bytes: float            # device memory per chip
    host_bytes_per_chip: float  # host memory the offload may fill, per chip
    kernel_launch_us: float     # per-op overhead of tiny chunks (§3.3)


# H100 SXM, the port's card.  The rates assume its full 700 W power limit;
# none of them is read back from the card by the planner.
H100 = Hardware(
    name="h100-sxm",
    peak_flops_bf16=989e12,     # data sheet: dense bf16 tensor-core peak
    hbm_bw=3.35e12,             # data sheet: HBM3
    ici_bw=450e9,               # data sheet: NVLink 4, 900 GB/s both ways together
    # data sheet: PCIe Gen5 x16 at 64 GB/s each way; chip_smoke.py prints the
    # pinned copy rates it measures (55.3-55.4 GB/s D2H, PERF.md §6) beside it
    d2h_bw=64e9,
    hbm_bytes=80e9,             # data sheet: 80 GB HBM3
    # tools/chip_host_probe.py: the H100 machine's host holds 101 GiB
    host_bytes_per_chip=101 * 2**30,
    # the reference's planning constant for one launch's overhead; not
    # measured on the card
    kernel_launch_us=3.0,
)

# The recompute-based flash backward (kernels/flash_attention.py) runs five
# products over each score tile (QK^T recompute, dV = P^T dO, dP = dO V^T,
# dQ = dS K, dK = dS^T Q) against the forward's two (QK^T, PV), so the
# attention share of a chunk's FLOPs has a bwd/fwd ratio of 5/2, not the
# matmul convention's 4N/2N = 2.  effective_bwd_ratio blends the two by the
# attention fraction of forward compute.
ATTN_BWD_RATIO = 2.5


def attn_flops(batch: int, seq: int, n_heads: int, hd: int,
               *, causal: bool = True, kv_len: int = None) -> float:
    """QK^T + AV flops for one layer's attention (fwd)."""
    kv = kv_len if kv_len is not None else seq
    pairs = batch * seq * kv * (0.5 if causal and kv == seq else 1.0)
    return 4 * pairs * n_heads * hd


def attn_bwd_flops(batch: int, seq: int, n_heads: int, hd: int,
                   *, causal: bool = True, kv_len: int = None) -> float:
    """dq/dk/dv matmul flops for one layer's attention backward
    (recompute-based flash: 5 products over the score tiles)."""
    return ATTN_BWD_RATIO * attn_flops(batch, seq, n_heads, hd,
                                       causal=causal, kv_len=kv_len)


def attn_bwd_bytes(batch: int, seq_q: int, kv_len: int, n_heads: int,
                   n_kv_heads: int, hd_k: int, hd_v: int,
                   *, io_bytes: int = 2) -> float:
    """Device-memory traffic of the two backward grids (dq pass + dkv pass):
    each streams q, k, v, dO and the (m, dl) row stats once and writes its
    own gradients.  Nothing S×S is ever resident: the score/probability
    tiles are recomputed from the saved max statistic."""
    q_b = batch * seq_q * n_heads * hd_k * io_bytes
    do_b = batch * seq_q * n_heads * hd_v * 4          # dO/o are fp32
    kv_b = batch * kv_len * n_kv_heads * (hd_k + hd_v) * io_bytes
    stats = 2 * batch * seq_q * n_heads * 4            # m + dl rows, fp32
    reads = 2 * (q_b + do_b + kv_b + stats)
    # dq + dk/dv are emitted fp32 by the kernels (the caller downcasts)
    writes = (q_b + kv_b) * 4 // io_bytes
    return reads + writes


def effective_bwd_ratio(attn_frac: float) -> float:
    """Lumped bwd/fwd time ratio for a chunk whose forward FLOPs are
    `attn_frac` attention: matmuls follow the 4N/2N = 2 convention, the
    recompute-based attention backward costs 2.5x its forward."""
    attn_frac = min(1.0, max(0.0, attn_frac))
    return BWD_RATIO * (1.0 - attn_frac) + ATTN_BWD_RATIO * attn_frac


def model_flops_per_token(n_params: int, *, train: bool) -> float:
    """The 6·N (train) / 2·N (inference) matmul convention."""
    return (6 if train else 2) * n_params


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


def chunk_time_est(flops: float, bytes_moved: float, hw: Hardware,
                   n_ops: int = 1) -> float:
    """Roofline-max execution time + kernel overheads (Fig. 7 shape)."""
    return max(flops / hw.peak_flops_bf16, bytes_moved / hw.hbm_bw) \
        + n_ops * hw.kernel_launch_us * 1e-6


# ---------------------------------------------------------------------------
# Ring-distributed attention (DESIGN.md §15): KV bytes per hop, the
# causality hop schedule, and the per-stage device-memory demand of each
# attn_mode
# ---------------------------------------------------------------------------


def kv_bytes_per_token(cfg, itemsize: int = ACT_ITEMSIZE) -> float:
    """Bytes/token/layer of the position-tagged KV cache rows (k + v; the
    MLA cache stores the shared latent [c_kv | k_rope] once: v aliases k,
    so the latent width counts a single time)."""
    if cfg.mla is not None:
        return (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * itemsize
    return 2 * cfg.n_kv_heads * cfg.hd * itemsize


def kv_block_bytes(cfg, block_tokens: int,
                   itemsize: int = ACT_ITEMSIZE) -> float:
    """Device bytes of one paged-KV block on one rank for one layer:
    ``block_tokens`` logical cache slots, each holding one token's k + v
    rows."""
    return block_tokens * kv_bytes_per_token(cfg, itemsize)


def kv_pool_bytes(cfg, n_blocks: int, block_tokens: int, n_layers: int,
                  itemsize: int = ACT_ITEMSIZE) -> float:
    """Per-rank device bytes of the whole paged KV pool: every layer owns
    ``n_blocks`` blocks."""
    return n_blocks * kv_block_bytes(cfg, block_tokens, itemsize) * n_layers


def ring_hop_bytes(cfg, kv_tokens_local: float, batch: int) -> float:
    """Wire bytes one rank sends per ring hop for one layer's attention:
    its resident KV block (batch x local tokens x kv rows) plus the int32
    position tags that travel with it (the tags are batch-invariant)."""
    return (batch * kv_tokens_local * kv_bytes_per_token(cfg)
            + kv_tokens_local * 4)


def ring_hop_fractions(sp: int, *, causal: bool = True,
                       layout: str = "zigzag") -> list:
    """Per-hop compute fraction (of one full KV block against the local
    queries) that the *slowest* rank must execute: the lock-step cost of
    hop h is the max over ranks, because the next hop is a barrier.

    block-contiguous layout: under causal masking rank sp−1's queries see
    every arriving block in full, so each hop costs a whole block: sum = sp.
    zigzag (striped) layout: each rank owns an interleaved mix of early and
    late positions, so every arriving block is ~half visible everywhere and
    per-hop cost balances at 1/2 (+1/(2·sp) on the self hop for the
    unskippable diagonal tiles): sum ≈ (sp+1)/2, the causal discount.
    Non-causal attention has no skippable pairs in either layout."""
    if sp <= 1:
        return [1.0]
    if not causal or layout == "block":
        return [1.0] * sp
    if layout != "zigzag":
        raise ValueError(f"unknown ring layout {layout!r}")
    return [0.5 + 0.5 / sp] + [0.5] * (sp - 1)


def stage_attn_demand(cfg, *, seq_len: int, batch: int, sp: int, pp: int,
                      mode: str, n_params: int = None) -> dict:
    """Per-device memory demand (bytes) of running attention over a
    ``seq_len``-token visible context under each attn_mode, the §15 memory
    model that decides which modes a cell can admit:

      params          the parameter shard (bf16, over the stage grid and the
                      model axis);
      kv_cache        the position-tagged cache one stage keeps through the
                      whole sequence: the full visible KV under "local", 1/sp
                      of it for every distributed mode;
      attn_transient  the largest per-layer working set one attention call
                      holds on top of the cache: the gathered full KV
                      (gather_kv), two blocks (resident + in flight) for the
                      ring, one remote query/merge-buffer shard for gather_q,
                      nothing for local.
    """
    if mode not in ("local", "gather_q", "gather_kv", "auto", "ring"):
        raise ValueError(f"unknown attn_mode {mode!r}")
    row = kv_bytes_per_token(cfg)
    layers = cfg.n_layers / pp
    params = (n_params * ACT_ITEMSIZE / (pp * sp)) if n_params else 0.0
    if mode == "local":
        kv_cache = batch * seq_len * row * layers
        transient = 0.0
    else:
        kv_cache = batch * (seq_len / sp) * row * layers
        if mode == "gather_kv":
            transient = batch * seq_len * row
        elif mode == "ring":
            transient = 2.0 * batch * (seq_len / sp) * row
        else:  # gather_q / auto: the remote query shard + merge buffers
            transient = batch * (seq_len / sp) * row
    total = params + kv_cache + transient
    return {"params": params, "kv_cache": kv_cache,
            "attn_transient": transient, "total": total}
