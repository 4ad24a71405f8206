"""Dense slot program and the stage engine (port of ``repro/models/transformer.py``).

A model is a sequence of uniform slots (one dense layer each here).  The
reference scans the slots under SPPO's checkpoint policy.  The port runs
them as a plain loop with remat "none": autograd keeps every residual, which
is the reference's ``checkpoint_block(remat="none")``.  SPPO's named-save
policy ("sppo") and full recompute ("full") come with the executed-offload
slice and raise until then.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.models import attention as A
from repro_torch.models import layers as L


class ChunkMeta(NamedTuple):
    q_pos: Any           # [T] int32 global positions of the chunk (decode: [1])
    cache_off: int       # cache slot of the chunk's first token
    kv_view: Optional[int]  # visible cache length after the append (decode: None = all)
    rope: Any            # layers.rope_tables(q_pos, ...): shared by every layer


def _res(x, delta, gate):
    """Gated residual add — ghost slots (gate = 0) become identity.  The
    gate is a structural constant (pipeline padding), not trainable: no
    gradient reaches it.  It is 0 or 1, so the fused x + gate * delta rounds
    as x + delta does."""
    return torch.addcmul(x, gate.detach().to(x.dtype), delta)


def dense_slot(cfg, p, s, x, meta: ChunkMeta):
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    a, kv = A.gqa_self_attention(h, p["attn"], cfg, s["kv"], meta.q_pos,
                                 meta.cache_off, meta.kv_view, meta.rope)
    x = _res(x, a, p["gate"])
    h2 = L.apply_norm(x, p["ln2"], cfg.norm)
    m = L.mlp(h2, p["mlp"], cfg.act)
    x = _res(x, m, p["gate"])
    return x, {"kv": kv}


def stage_apply(cfg, stage_params, state, x, meta: ChunkMeta, *,
                remat: str = "none"):
    """Run a stack of slots on one chunk.  ``stage_params`` and ``state`` are
    lists with one entry per slot; the caches are updated in place.
    Returns (x, state)."""
    if remat != "none":
        raise NotImplementedError(
            f"remat={remat!r}: the port keeps every residual (remat 'none'); "
            "SPPO's named-save policy and full recompute come with executed "
            "offload (ROADMAP Queue 1, item 5)")
    for i, (p, s) in enumerate(zip(stage_params, state)):
        x, state[i] = dense_slot(cfg, p, s, x, meta)
    return x, state
