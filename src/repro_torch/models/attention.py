"""GQA attention blocks over the position-tagged KV cache (port of
``repro/models/attention.py``, single-device path).

The cache is position-tagged: every slot carries its global token position
(PAD = 2**30 for empty slots), so causality across prefill chunks and decode
steps is the same kernel call with different positions.  At sp = 1 the
reference's cross-shard merge multiplies by exp(m - m) = 1 and is the
identity, so attention is one ``attention_partial`` call and a normalize.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

PAD = 2**30


class KVCache(NamedTuple):
    """Position-tagged KV cache (one layer)."""

    k: torch.Tensor     # [B, S_loc, Hkv, hd_k]
    v: torch.Tensor     # [B, S_loc, Hkv, hd_v]
    pos: torch.Tensor   # [S_loc] int32 global positions (PAD = empty)


def init_cache(batch: int, s_local: int, h_kv: int, hd_k: int, hd_v: int,
               dtype, device) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, s_local, h_kv, hd_k), dtype=dtype, device=device),
        v=torch.zeros((batch, s_local, h_kv, hd_v), dtype=dtype, device=device),
        pos=torch.full((s_local,), PAD, dtype=torch.int32, device=device),
    )


def cache_append(cache: KVCache, k_new, v_new, pos_new, offset: int) -> KVCache:
    """Write a chunk's KV at slot ``offset``.  The write is in place (the
    reference returns an updated copy): the cache buffer is the largest
    activation state of serving and is never copied."""
    t = k_new.shape[1]
    cache.k[:, offset:offset + t] = k_new.to(cache.k.dtype)
    cache.v[:, offset:offset + t] = v_new.to(cache.v.dtype)
    cache.pos[offset:offset + t] = pos_new.to(torch.int32)
    return cache


def dist_attention(q, k_loc, v_loc, q_pos, kv_pos, *, causal=True, scale=None,
                   kv_view=None):
    """q: [B, Tq, H, hd]; k_loc/v_loc/kv_pos: the cache.  ``kv_view`` is the
    number of leading cache slots to attend over (a strided prefix view, no
    copy; None = the whole buffer).  Returns [B, Tq, H, hd_v] in q's dtype."""
    if kv_view is not None:
        k_loc, v_loc, kv_pos = (k_loc[:, :kv_view], v_loc[:, :kv_view],
                                kv_pos[:kv_view])
    o, m, l = kops.attention_partial(q, k_loc, v_loc, q_pos, kv_pos,
                                     causal=causal, scale=scale)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _proj(x, w, b):
    """x @ w (+ b): one fused matmul-and-bias where there is a bias."""
    return x @ w if b is None else torch.addmm(b, x.flatten(0, -2), w).view(
        *x.shape[:-1], w.shape[1])


def gqa_self_attention(x, p, cfg, cache: KVCache, q_pos, cache_offset: int,
                       kv_view, rope):
    """x: [B, T, d]; q_pos: [T] global positions of the tokens, whose KV
    lands at slot ``cache_offset``; they attend the first ``kv_view`` slots
    (a prefill chunk) or, with ``kv_view=None``, the whole buffer, empty
    slots masked by their PAD position (a decode step, T = 1: at sp = 1 this
    is the reference's ``gqa_decode_attention``).  ``rope`` is
    ``layers.rope_tables`` of q_pos.  Returns (attn_out [B, T, d], cache)."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _proj(x, p["wq"], p.get("bq")).view(B, T, H, hd)
    k = _proj(x, p["wk"], p.get("bk")).view(B, T, Hkv, hd)
    v = _proj(x, p["wv"], p.get("bv")).view(B, T, Hkv, hd)
    # q and k share positions: one rotation of both
    q, k = L.rotate(torch.cat([q, k], dim=2), *rope).split([H, Hkv], dim=2)
    cache = cache_append(cache, k, v, q_pos, cache_offset)
    out = dist_attention(q, cache.k, cache.v, q_pos, cache.pos, causal=True,
                         kv_view=kv_view)
    return out.reshape(B, T, H * hd) @ p["wo"], cache
