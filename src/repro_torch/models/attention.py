"""GQA attention blocks over the position-tagged KV cache (port of
``repro/models/attention.py``, single-device path).

The cache is position-tagged: every slot carries its global token position
(PAD = 2**30 for empty slots), so causality across prefill chunks and decode
steps is the same kernel call with different positions.  At sp = 1 the
reference's cross-shard merge multiplies by exp(m - m) = 1 and is the
identity, so attention is one ``attention_partial`` call and a normalize.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L

PAD = 2**30


class KVCache(NamedTuple):
    """Position-tagged KV cache (one layer)."""

    k: torch.Tensor     # [B, S_loc, Hkv, hd_k]
    v: torch.Tensor     # [B, S_loc, Hkv, hd_v]
    pos: torch.Tensor   # [S_loc] int32 global positions (PAD = empty)
    # training only: the (k, v) of every chunk appended so far, in slot
    # order; None for a serving cache
    chunks: Optional[list] = None


def init_cache(batch: int, s_local: int, h_kv: int, hd_k: int, hd_v: int,
               dtype, device, *, train: bool = False) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, s_local, h_kv, hd_k), dtype=dtype, device=device),
        v=torch.zeros((batch, s_local, h_kv, hd_v), dtype=dtype, device=device),
        pos=torch.full((s_local,), PAD, dtype=torch.int32, device=device),
        chunks=[] if train else None,
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
                   kv_view=None, q_start=None):
    """q: [B, Tq, H, hd]; k_loc/v_loc/kv_pos: the cache.  ``kv_view`` is the
    number of leading cache slots to attend over (a strided prefix view, no
    copy; None = the whole buffer).  ``q_start``: optional [B, Tq] int32
    document window of a packed batch: each query sees only the slots with
    kv_pos >= its document's start (PAD_START on padding rows).  Returns [B,
    Tq, H, hd_v] in q's dtype."""
    if kv_view is not None:
        k_loc, v_loc, kv_pos = (k_loc[:, :kv_view], v_loc[:, :kv_view],
                                kv_pos[:kv_view])
    o, m, l = kops.attention_partial(q, k_loc, v_loc, q_pos, kv_pos,
                                     causal=causal, scale=scale, q_start=q_start)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


class _ChunkAttention(torch.autograd.Function):
    """One chunk's queries against the cache prefix that holds every chunk
    so far, differentiable in q and in each chunk's (k, v).

    ``apply(q, q_pos, q_start, cache, kv_view, causal, k_0, ..., k_c, v_0,
    ..., v_c)`` writes chunk c's k, v and positions into the buffer (the
    other chunks are there already), runs the partial attention on the
    prefix view ``[:kv_view]`` under the chunk's document window
    ``q_start`` ([B, T] int32, or None) and returns (o, m, l).  The
    backward splits the view's dk, dv by chunk length; autograd sums each
    chunk's share over every later chunk that attended it.  Nothing is
    copied: the buffer holds O(S) K/V per layer, as in serving.
    """

    @staticmethod
    def forward(ctx, q, q_pos, q_start, cache, kv_view, causal, *kvs):
        n = len(kvs) // 2
        k_c, v_c = kvs[n - 1], kvs[-1]
        lengths = [k.shape[1] for k in kvs[:n]]
        if sum(lengths) != kv_view:
            raise ValueError(f"chunk lengths {lengths} do not fill the view "
                             f"of {kv_view} slots")
        off = kv_view - lengths[-1]
        cache.k[:, off:kv_view] = k_c
        cache.v[:, off:kv_view] = v_c
        cache.pos[off:kv_view] = q_pos
        scale = 1.0 / (q.shape[-1] ** 0.5)
        k, v, pos = cache.k[:, :kv_view], cache.v[:, :kv_view], cache.pos[:kv_view]
        o, m, l = fa.partial_forward(q, k, v, q_pos, pos, q_start, causal=causal,
                                     scale=scale)
        # the window is the chunk's own slice, not part of the shared buffer
        ctx.save_for_backward(q, q_pos, m, q_start)
        # The buffer is kept on ctx, not saved: later chunks write it in place,
        # which would fail save_for_backward's version check, but they write
        # only slots >= kv_view, so this view reads back unchanged.
        ctx.cache, ctx.kv_view, ctx.lengths = cache, kv_view, lengths
        ctx.opts = dict(causal=causal, scale=scale)
        ctx.mark_non_differentiable(m)
        return o, m, l

    @staticmethod
    def backward(ctx, do, _dm, dl):
        q, q_pos, m, q_start = ctx.saved_tensors
        c, n = ctx.cache, ctx.kv_view
        dq, dk, dv = fa.partial_backward(q, c.k[:, :n], c.v[:, :n], q_pos,
                                         c.pos[:n], q_start, do, m, dl, **ctx.opts)
        dks = [d.to(c.k.dtype) for d in dk.split(ctx.lengths, dim=1)]
        dvs = [d.to(c.v.dtype) for d in dv.split(ctx.lengths, dim=1)]
        return (dq.to(q.dtype), None, None, None, None, None, *dks, *dvs)


def chunk_attention(q, k, v, q_pos, cache: KVCache, cache_offset: int,
                    kv_view: int, *, causal=True, q_start=None):
    """Training counterpart of ``cache_append`` + ``dist_attention``: appends
    the chunk's (k, v) to the cache's chunk list and attends the first
    ``kv_view`` slots through ``_ChunkAttention``, under the document window
    ``q_start`` where given.  The chunks must tile the slots in order: this
    chunk lands at ``cache_offset = kv_view - T``."""
    if cache_offset != kv_view - k.shape[1]:
        raise ValueError(f"a training chunk of {k.shape[1]} tokens at slot "
                         f"{cache_offset} must end the view of {kv_view} slots")
    cache.chunks.append((k.to(cache.k.dtype), v.to(cache.v.dtype)))
    ks, vs = zip(*cache.chunks)
    qs = None if q_start is None else q_start.to(torch.int32)
    o, _, l = _ChunkAttention.apply(q, q_pos.to(torch.int32), qs, cache, kv_view,
                                    causal, *ks, *vs)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _proj(x, w, b):
    """x @ w (+ b): one fused matmul-and-bias where there is a bias."""
    return x @ w if b is None else torch.addmm(b, x.flatten(0, -2), w).view(
        *x.shape[:-1], w.shape[1])


def _qkv(x, p, cfg, rope):
    """q, k after RoPE and v of x [B, T, d], [B, T, heads, hd] each."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _proj(x, p["wq"], p.get("bq")).view(B, T, H, hd)
    k = _proj(x, p["wk"], p.get("bk")).view(B, T, Hkv, hd)
    v = _proj(x, p["wv"], p.get("bv")).view(B, T, Hkv, hd)
    # q and k share positions: one rotation of both
    q, k = L.rotate(torch.cat([q, k], dim=2), *rope).split([H, Hkv], dim=2)
    return q, k, v


class _SavedQKV(torch.autograd.Function):
    """``_qkv`` in a replay that has its outputs saved (remat "sppo"): the
    forward returns the saved q, k, v and runs neither the projections nor
    RoPE; the backward is theirs, from the saved input and weights.

    ``apply(rope, x, wq, wk, wv, bq, bk, bv, q, k, v)``; a bias may be None.
    """

    @staticmethod
    def forward(ctx, rope, x, wq, wk, wv, bq, bk, bv, q, k, v):
        ctx.rope, ctx.bias = rope, (bq is not None, bk is not None, bv is not None)
        ctx.save_for_backward(x, wq, wk, wv)
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, *ws = ctx.saved_tensors
        cos, sin, rot = ctx.rope
        # RoPE rotates each pair by its angle: its VJP rotates back
        dq, dk = L.rotate(torch.cat([dq, dk], dim=2), cos, -sin, rot).split(
            [dq.shape[2], dk.shape[2]], dim=2)
        x2 = x.reshape(-1, x.shape[-1])
        gs = [g.reshape(x2.shape[0], -1) for g in (dq, dk, dv)]
        gq, gk, gv = (g @ w.t() for g, w in zip(gs, ws))
        # summed in the order autograd sums them through _qkv (the last
        # projection's first), so the replay rounds as "full" and "none" do
        dx = (gv + gk + gq).view_as(x)
        dws = [x2.t() @ g for g in gs]
        dbs = [g.sum(0) if has else None for g, has in zip(gs, ctx.bias)]
        return (None, dx, *dws, *dbs, None, None, None)


def gqa_self_attention(x, p, cfg, cache: KVCache, q_pos, cache_offset: int,
                       kv_view, rope, *, name_tag=None, q_start=None):
    """x: [B, T, d]; q_pos: [T] global positions of the tokens, whose KV
    lands at slot ``cache_offset``; they attend the first ``kv_view`` slots
    (a prefill chunk) or, with ``kv_view=None``, the whole buffer, empty
    slots masked by their PAD position (a decode step, T = 1: at sp = 1 this
    is the reference's ``gqa_decode_attention``).  ``rope`` is
    ``layers.rope_tables`` of q_pos.  ``q_start``: the [B, T] document
    window of a packed batch, or None.  A training cache (``chunks`` set)
    attends through ``chunk_attention``.  ``name_tag``, where given, is
    applied to q, k and v after RoPE and to the attention output before
    ``@ wo``: the tag sites of SPPO's offload (core/offload.py), as in the
    reference.  A replay's tag (``replay`` true) hands out the saved q, k
    and v, which are then not recomputed.  Returns (attn_out [B, T, d],
    cache)."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if name_tag is not None and name_tag.replay:
        saved = [name_tag.take((B, T, h, hd), x.dtype) for h in (H, Hkv, Hkv)]
        q, k, v = _SavedQKV.apply(rope, x, p["wq"], p["wk"], p["wv"], p.get("bq"),
                                  p.get("bk"), p.get("bv"), *saved)
    else:
        q, k, v = _qkv(x, p, cfg, rope)
        if name_tag is not None:
            q, k, v = name_tag(q), name_tag(k), name_tag(v)
    if cache.chunks is not None:
        out = chunk_attention(q, k, v, q_pos, cache, cache_offset, kv_view,
                              q_start=q_start)
        out = out.reshape(B, T, H * hd)
        if name_tag is not None:
            out = name_tag(out)
        return out @ p["wo"], cache
    cache = cache_append(cache, k, v, q_pos, cache_offset)
    out = dist_attention(q, cache.k, cache.v, q_pos, cache.pos, causal=True,
                         kv_view=kv_view, q_start=q_start).reshape(B, T, H * hd)
    if name_tag is not None:
        out = name_tag(out)
    return out @ p["wo"], cache
