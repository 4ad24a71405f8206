"""GQA and MLA attention blocks over the position-tagged KV cache (port of
``repro/models/attention.py``).

The cache is position-tagged: every slot carries its global token position
(PAD = 2**30 for empty slots), so causality across prefill chunks and decode
steps is the same kernel call with different positions.  At sp = 1
attention is one ``attention_partial`` call and a normalize.

At sp > 1 (DESIGN.md §4) the activations and the cache are sequence-sharded
over the model axis (``parallel/ctx.py``): model rank r holds rows ``[off +
r * T / sp, off + (r + 1) * T / sp)`` of a chunk at ``off`` and their K/V
at its cache slots ``[off / sp, (off + T) / sp)``, so its slots ascend with
gaps and, gathered over the ranks, do not ascend at all.  Nothing here
assumes contiguous positions: the kernels read every slot's position.  The
plan's ``attn_mode`` picks the schedule (reference ``attention.py:71-145``):

- "gather_q" (the default): all-gather the chunk's queries, their positions
  and document windows, attend the local cache shard, and merge the
  partial softmax statistics: a gradient-frozen max over the model group,
  rescaled o and l reduce-scattered back to each rank's rows (o in bf16
  under ``merge_bf16``);
- "gather_kv": all-gather the local K/V shard and its positions; each rank
  then attends its own queries with no merge;
- "auto": the reference's byte count between the two (never "ring");
- "ring": rotate the local K/V shard and its positions around the model
  group, one partial a hop, folded in canonical source order
  (``parallel/ring.py``, DESIGN.md §15): its forward holds two KV blocks
  at a time, never the gathered view (a differentiated call keeps each
  hop's block for the kernels' backward, as the reference's autodiff
  does); a training chunk rotates its cache view, the concatenation of
  every chunk's K/V so far (a re-run MSP chunk's view is the truncated
  one, on every model rank alike);
- "local": sp = 1 only.  At sp = 1 every mode is one partial and a
  normalize.

Decode (DESIGN.md §16) feeds one token a step, replicated on every model
rank.  ``gqa_decode_attention`` writes it to the static cache's striped
slot (token S + i on model rank i % sp at slot S / sp + i // sp; the caller
passes the slot, or None on the ranks that do not own it) and
``gqa_paged_decode_attention`` to the paged pool (``runtime/kvpool.py``)
through the block table; both attend each rank's whole cache with the
partial kernel and merge the partials over the model group with a max and
two sums (``_merge_replicated``), since every rank holds every query.

MLA (deepseek-v3, reference ``attention.py:332-408``) runs in the absorbed
form: the LoRA queries' nope part times ``w_uk`` and the roped part make
q_eff [B, T, H, dc + dr], the latent [c_kv | k_rope] is k_eff [B, T, 1, dc
+ dr], the one KV "head" every query head attends, and v is the view
``k_eff[..., :dc]`` of the same tensor (of the same cache buffer), never a
copy, so the kernels read the latent once for both; the scale is 1 / sqrt(dn
+ dr), and the values are up-projected per head by ``w_uv`` after the
attention.  The tag sites are q_eff, k_eff and o_v.  MLA runs at sp = 1
(``parallel/runner.py::resolve_cell`` refuses more).

Cross-attention (the VLM's image layers, whisper's decoder; reference
``attention.py:411-438``): ``make_cross_kv`` projects the context (stub
patches, or whisper's encoder output) to K/V once a pass, each slot at its
index as position and PAD past the valid count, and ``cross_attention``
attends a chunk's or a decode step's queries to it with causal=False, the
same partial kernel; the tag sites are its q and output, never the
chunk-invariant K/V.  At sp = 1 only.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.parallel import ring
from repro_torch.parallel.ctx import SINGLE

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


def init_latent_cache(batch: int, s_local: int, dc: int, dr: int, dtype, device, *,
                      train: bool = False) -> KVCache:
    """MLA's cache (reference ``init_slot_state``'s MLA branch): the latent
    [c_kv | k_rope] of each slot, [B, S_loc, 1, dc + dr], as k, and v the
    view of its first dc columns (the reference keeps a [B, 1, 1, 1]
    placeholder and attends ``kv[..., :dc]``)."""
    k = torch.zeros((batch, s_local, 1, dc + dr), dtype=dtype, device=device)
    return KVCache(k=k, v=k[..., :dc],
                   pos=torch.full((s_local,), PAD, dtype=torch.int32, device=device),
                   chunks=[] if train else None)


def cache_append(cache: KVCache, k_new, v_new, pos_new, offset: int) -> KVCache:
    """Write a chunk's KV at slot ``offset``.  The write is in place (the
    reference returns an updated copy): the cache buffer is the largest
    activation state of serving and is never copied."""
    t = k_new.shape[1]
    cache.k[:, offset:offset + t] = k_new.to(cache.k.dtype)
    cache.v[:, offset:offset + t] = v_new.to(cache.v.dtype)
    cache.pos[offset:offset + t] = pos_new.to(torch.int32)
    return cache


def _pick_mode(ctx, q, k_loc, kv_view) -> str:
    """The plan's schedule at sp > 1; "auto" is the reference's byte count:
    gathering the KV shard moves ~(k + v) bytes, the gather-q merge q (bf16)
    and o (fp32), so narrow GQA caches of short chunks gather KV (it never
    picks the ring, as the reference's does not)."""
    if ctx.sp == 1:
        return "local"
    if ctx.attn_mode != "auto":
        return ctx.attn_mode
    _, Tq, H, hdk = q.shape
    kv_len = kv_view if kv_view is not None else k_loc.shape[1]
    kv_bytes = 2 * kv_len * k_loc.shape[2] * k_loc.shape[-1] * 2
    q_bytes = Tq * H * hdk * (2 + 4)
    return "gather_kv" if kv_bytes < q_bytes else "gather_q"


def _merge(o, m, l, ctx):
    """The gather-q merge of every rank's partial (o, m, l) over the chunk's
    queries: the max's pmax (gradient-frozen), o and l rescaled by exp(m -
    max) and reduce-scattered to each rank's query rows, normalized."""
    m = m.detach()
    alpha = torch.exp(m - ctx.pmax_model(m))
    o_s = o * alpha[..., None]
    if ctx.merge_bf16:
        o_s = o_s.to(torch.bfloat16)
    o = ctx.reduce_scatter_model(o_s, axis=1).float()
    l = ctx.reduce_scatter_model(l * alpha, axis=1)
    return o / l.clamp_min(1e-30)[..., None]


def _merge_replicated(o, m, l, ctx):
    """The decode merge (reference ``attention.py:226-233``): every model
    rank holds the same queries, so the rescaled o and l are summed, not
    reduce-scattered; normalized.  At sp = 1 the normalize alone (the
    rescale by exp(0) would change no bit)."""
    if ctx.sp > 1:
        m = m.detach()
        alpha = torch.exp(m - ctx.pmax_model(m))
        o = ctx.psum_model(o * alpha[..., None])
        l = ctx.psum_model(l * alpha)
    return o / l.clamp_min(1e-30)[..., None]


def _gather_queries(q, q_pos, q_start, ctx):
    """Under gather_q, the chunk's queries of every rank (differentiable)
    with their positions and document windows."""
    qp = ctx.gather(q_pos, q_pos.dim() - 1)
    qs = None if q_start is None else ctx.gather(q_start, 1)
    return ctx.all_gather_model(q, axis=1), qp, qs


def dist_attention(q, k_loc, v_loc, q_pos, kv_pos, ctx=SINGLE, *, causal=True, scale=None,
                   kv_view=None, q_start=None):
    """q: [B, Tq, H, hd] this rank's queries; k_loc/v_loc/kv_pos: its cache
    shard.  ``kv_view`` is the number of leading cache slots to attend over
    (a strided prefix view, no copy; None = the whole buffer).  ``q_start``:
    optional [B, Tq] int32 document window of a packed batch: each query
    sees only the slots with kv_pos >= its document's start (PAD_START on
    padding rows).  At sp > 1 the schedule is ``ctx``'s (module docstring).
    Returns [B, Tq, H, hd_v] in q's dtype."""
    if kv_view is not None:
        k_loc, v_loc, kv_pos = (k_loc[:, :kv_view], v_loc[:, :kv_view],
                                kv_pos[:kv_view])
    mode = _pick_mode(ctx, q, k_loc, kv_view)
    if mode == "ring":
        # q, q_pos and q_start are query-side and stay; the shard rotates
        return ring.ring_attention(q, k_loc, v_loc, q_pos, kv_pos, ctx, causal=causal,
                                   scale=scale, q_start=q_start)
    if mode == "gather_q":
        q_full, qp, qs = _gather_queries(q, q_pos, q_start, ctx)
        o, m, l = kops.attention_partial(q_full, k_loc, v_loc, qp, kv_pos, causal=causal,
                                         scale=scale, q_start=qs)
        return _merge(o, m, l, ctx).to(q.dtype)
    if mode == "gather_kv":
        k_loc, v_loc = ctx.all_gather_model(k_loc, axis=1), ctx.all_gather_model(v_loc, axis=1)
        kv_pos = ctx.gather(kv_pos, 0)
    o, m, l = kops.attention_partial(q, k_loc, v_loc, q_pos, kv_pos,
                                     causal=causal, scale=scale, q_start=q_start)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


class _ChunkAttention(torch.autograd.Function):
    """One chunk's queries against the cache prefix that holds every chunk
    so far, differentiable in q and in each chunk's (k, v).

    ``apply(q, q_pos, q_start, kv_pos, cache, kv_view, causal, gather, scale,
    k_0, ..., k_c, v_0, ..., v_c)`` writes chunk c's k, v and their positions
    ``kv_pos`` into the buffer (the other chunks are there already), runs
    the partial attention of the queries at ``q_pos`` on the prefix view
    ``[:kv_view]`` under the document window ``q_start`` ([B, Tq] int32, or
    None), at ``scale`` (None: 1 / sqrt(hd_k)), and returns (o, m, l).  An
    MLA cache's v is a view of its k, and each chunk's v a view of its k:
    the v write then rewrites the same elements, and autograd adds each
    chunk's dv into its k's gradient through the view.  With ``gather`` (a model-axis context,
    the gather_kv schedule) the view is first all-gathered over the model
    group, with its positions, and the backward reduce-scatters its dk, dv
    back to this rank's slots.  The backward splits the view's dk, dv by
    chunk length; autograd sums each chunk's share over every later chunk
    that attended it.  Nothing of the local buffer is copied: it holds O(S /
    sp) K/V per layer, as in serving.
    """

    @staticmethod
    def forward(ctx, q, q_pos, q_start, kv_pos, cache, kv_view, causal, gather, scale, *kvs):
        n = len(kvs) // 2
        k_c, v_c = kvs[n - 1], kvs[-1]
        lengths = [k.shape[1] for k in kvs[:n]]
        if sum(lengths) != kv_view:
            raise ValueError(f"chunk lengths {lengths} do not fill the view "
                             f"of {kv_view} slots")
        off = kv_view - lengths[-1]
        cache.k[:, off:kv_view] = k_c
        cache.v[:, off:kv_view] = v_c
        cache.pos[off:kv_view] = kv_pos
        if scale is None:
            scale = 1.0 / (q.shape[-1] ** 0.5)
        k, v, pos = cache.k[:, :kv_view], cache.v[:, :kv_view], cache.pos[:kv_view]
        ctx.gathered = None
        if gather is not None:
            k, v, pos = gather.gather(k, 1), gather.gather(v, 1), gather.gather(pos, 0)
            ctx.gathered = (k, v, pos)
        o, m, l = fa.partial_forward(q, k, v, q_pos, pos, q_start, causal=causal,
                                     scale=scale)
        # the window is the chunk's own slice, not part of the shared buffer
        ctx.save_for_backward(q, q_pos, m, q_start)
        # The buffer is kept on ctx, not saved: later chunks write it in place,
        # which would fail save_for_backward's version check, but they write
        # only slots >= kv_view, so this view reads back unchanged.
        ctx.cache, ctx.kv_view, ctx.lengths, ctx.gather = cache, kv_view, lengths, gather
        ctx.opts = dict(causal=causal, scale=scale)
        ctx.mark_non_differentiable(m)
        return o, m, l

    @staticmethod
    def backward(ctx, do, _dm, dl):
        q, q_pos, m, q_start = ctx.saved_tensors
        c, n = ctx.cache, ctx.kv_view
        k, v, pos = ctx.gathered or (c.k[:, :n], c.v[:, :n], c.pos[:n])
        ctx.gathered = None
        dq, dk, dv = fa.partial_backward(q, k, v, q_pos, pos, q_start, do, m, dl, **ctx.opts)
        if ctx.gather is not None:
            dk, dv = ctx.gather.scatter_sum(dk, 1), ctx.gather.scatter_sum(dv, 1)
        dks = [d.to(c.k.dtype) for d in dk.split(ctx.lengths, dim=1)]
        dvs = [d.to(c.v.dtype) for d in dv.split(ctx.lengths, dim=1)]
        return (dq.to(q.dtype), None, None, None, None, None, None, None, None, *dks, *dvs)


def truncate_chunks(cache: KVCache, offset: int) -> None:
    """Drop the training cache's chunk entries at or past slot ``offset``,
    which must be a chunk boundary.  A chunk that runs again, as an MSP ramp
    sub-event re-runs its whole chunk (DESIGN.md §2), then replaces its
    entry instead of appending a second one; its rewrite of the buffer is
    bitwise the values already there, as the reference's idempotent cache
    write is."""
    end, keep = 0, 0
    for k, _ in cache.chunks:
        if end >= offset:
            break
        end, keep = end + k.shape[1], keep + 1
    if end != offset:
        raise ValueError(f"slot {offset} is not a chunk boundary of the training "
                         f"cache (chunks {[k.shape[1] for k, _ in cache.chunks]})")
    del cache.chunks[keep:]


def chunk_attention(q, k, v, q_pos, cache: KVCache, cache_offset: int,
                    kv_view: int, *, causal=True, q_start=None, ctx=SINGLE, scale=None):
    """Training counterpart of ``cache_append`` + ``dist_attention``: puts
    the chunk's (k, v) in the cache's chunk list, after the chunks that end
    at ``cache_offset`` (``truncate_chunks``: a re-run chunk replaces its
    entry), and attends the first ``kv_view`` slots through
    ``_ChunkAttention``, under the document window ``q_start`` where given.
    The chunks must tile the slots in order: this chunk lands at
    ``cache_offset = kv_view - T``.  At sp > 1 the cache is this rank's
    shard and the schedule ``ctx``'s (module docstring); the ring rotates
    the view's K/V, the chunks concatenated (differentiable in each), with
    the positions written to the buffer's slots.  ``scale``: the scores'
    (None: 1 / sqrt(hd_k))."""
    if cache_offset != kv_view - k.shape[1]:
        raise ValueError(f"a training chunk of {k.shape[1]} tokens at slot "
                         f"{cache_offset} must end the view of {kv_view} slots")
    truncate_chunks(cache, cache_offset)
    cache.chunks.append((k.to(cache.k.dtype), v.to(cache.v.dtype)))
    ks, vs = zip(*cache.chunks)
    q_pos = q_pos.to(torch.int32)
    qs = None if q_start is None else q_start.to(torch.int32)
    mode = _pick_mode(ctx, q, cache.k, kv_view)
    if mode == "ring":
        cache.pos[cache_offset:kv_view] = q_pos
        k_view, v_view = (torch.cat(ts, dim=1) if len(ts) > 1 else ts[0] for ts in (ks, vs))
        return ring.ring_attention(q, k_view, v_view, q_pos, cache.pos[:kv_view].clone(), ctx,
                                   causal=causal, scale=scale, q_start=qs)
    if mode == "gather_q":
        q_full, qp, qs_full = _gather_queries(q, q_pos, qs, ctx)
        o, m, l = _ChunkAttention.apply(q_full, qp, qs_full, q_pos, cache, kv_view, causal,
                                        None, scale, *ks, *vs)
        return _merge(o, m, l, ctx).to(q.dtype)
    o, _, l = _ChunkAttention.apply(q, q_pos, qs, q_pos, cache, kv_view, causal,
                                    ctx if mode == "gather_kv" else None, scale, *ks, *vs)
    return (o / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def _proj(x, w, b):
    """x @ w (+ b): one fused matmul-and-bias where there is a bias."""
    return x @ w if b is None else torch.addmm(b, x.flatten(0, -2), w).view(
        *x.shape[:-1], w.shape[1])


def _qkv(x, p, cfg, rope):
    """q, k after RoPE and v of x [B, T, d], [B, T, heads, hd] each
    (``rope`` None: a model without RoPE, whisper's learned positions)."""
    B, T, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _proj(x, p["wq"], p.get("bq")).view(B, T, H, hd)
    k = _proj(x, p["wk"], p.get("bk")).view(B, T, Hkv, hd)
    v = _proj(x, p["wv"], p.get("bv")).view(B, T, Hkv, hd)
    if rope is not None:
        # q and k share positions: one rotation of both
        q, k = L.rotate(torch.cat([q, k], dim=2), *rope).split([H, Hkv], dim=2)
    return q, k, v


class _SavedQKV(torch.autograd.Function):
    """``_qkv`` in a replay that has its outputs saved (remat "sppo"): the
    forward returns the saved q, k, v and runs neither the projections nor
    RoPE; the backward is theirs, from the saved input and weights.

    ``apply(rope, x, wq, wk, wv, bq, bk, bv, q, k, v)``; a bias may be None,
    and ``rope`` None where the model has no RoPE.
    """

    @staticmethod
    def forward(ctx, rope, x, wq, wk, wv, bq, bk, bv, q, k, v):
        ctx.rope, ctx.bias = rope, (bq is not None, bk is not None, bv is not None)
        ctx.save_for_backward(x, wq, wk, wv)
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        x, *ws = ctx.saved_tensors
        if ctx.rope is not None:
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
                       kv_view, rope, *, name_tag=None, q_start=None, ctx=SINGLE):
    """x: [B, T, d]; q_pos: [T] global positions of the tokens, whose KV
    lands at slot ``cache_offset``; they attend the first ``kv_view`` slots
    (a prefill or training chunk; decode attends through
    ``gqa_decode_attention``).  ``rope`` is
    ``layers.rope_tables`` of q_pos.  ``q_start``: the [B, T] document
    window of a packed batch, or None.  A training cache (``chunks`` set)
    attends through ``chunk_attention``.  ``name_tag``, where given, is
    applied to q, k and v after RoPE and to the attention output before
    ``@ wo``: the tag sites of SPPO's offload (core/offload.py), as in the
    reference.  A replay's tag (``replay`` true) hands out the saved q, k
    and v, which are then not recomputed.  At sp > 1 x, q_pos and q_start
    are this model rank's rows and ``cache`` its shard (``ctx``, module
    docstring).  Returns (attn_out [B, T, d], cache)."""
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
                              q_start=q_start, ctx=ctx)
        out = out.reshape(B, T, H * hd)
        if name_tag is not None:
            out = name_tag(out)
        return out @ p["wo"], cache
    cache = cache_append(cache, k, v, q_pos, cache_offset)
    out = dist_attention(q, cache.k, cache.v, q_pos, cache.pos, ctx, causal=True,
                         kv_view=kv_view, q_start=q_start).reshape(B, T, H * hd)
    if name_tag is not None:
        out = name_tag(out)
    return out @ p["wo"], cache


def gqa_decode_attention(x, p, cfg, cache: KVCache, q_pos, write_slot, rope, *, ctx=SINGLE):
    """One decode token against the static cache (reference
    ``gqa_decode_attention``).  x: [B, 1, d], the same on every model rank;
    q_pos: [1] its global position; ``write_slot``: this rank's cache slot
    for its K/V, or None where another model rank owns the token (the
    striped layout: the caller knows the rank and the position on the host,
    so a rank that does not own it writes nothing, where the reference writes
    the old value back).  Attends the rank's whole buffer, PAD slots masked,
    and merges over the model group.  Returns (attn_out [B, 1, d], cache)."""
    B = x.shape[0]
    q, k, v = _qkv(x, p, cfg, rope)
    if write_slot is not None:
        cache = cache_append(cache, k, v, q_pos, write_slot)
    o, m, l = kops.attention_partial(q, cache.k, cache.v, q_pos, cache.pos, causal=True)
    out = _merge_replicated(o, m, l, ctx).to(x.dtype)
    return out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"], cache


class PooledKV(NamedTuple):
    """Paged KV pool (one layer, one rank; reference ``PooledKV``): the
    physical slots every request shares through its block table, and the
    sink (``runtime/kvpool.py``).  No batch dim and no positions: logical
    slot j has the rank's static position ``pos_map[j]`` for every
    request."""

    k: torch.Tensor     # [P_loc + SINK_SLOTS, Hkv, hd]
    v: torch.Tensor     # [P_loc + SINK_SLOTS, Hkv, hd]


class PagedMeta(NamedTuple):
    """One paged decode step's routing (reference ``PagedMeta``), computed
    once a step for every layer by ``paged_meta``.

    q_pos is per request: row b feeds its token at global position q_pos[b]
    (0 marks an inactive row: it writes to the sink, and the scheduler
    drops its output).  ``write`` is each row's physical write slot, the
    sink where the reference's write drops; ``gather`` each row's physical
    slot of every logical slot, in logical order (an unallocated block reads
    block 0, masked because its pos_map position is past the row's horizon).
    """

    q_pos: torch.Tensor    # [B] int32
    pos_map: torch.Tensor  # [L_loc] int32 this rank's static positions
    write: torch.Tensor    # [B] int64
    gather: torch.Tensor   # [B, L_loc] int64


def paged_meta(q_pos, btab, pos_map, *, base: int, s_bucket: int, block_tokens: int,
               sp: int, rank: int, p_loc: int) -> PagedMeta:
    """The reference's routing of ``gqa_paged_decode_attention``
    (``attention.py:293-311``) as tensors on q_pos's device, with no host
    sync.  q_pos [B] int; btab [B, max_blocks] int (-1 = unallocated);
    pos_map [L_loc] int.  Decode token d = q_pos - s_bucket (< 0: none) is
    written on rank d % sp at logical slot base + d // sp through the block
    table; every other row's write goes to the sink slot ``p_loc``."""
    bt, l_loc = block_tokens, pos_map.shape[0]
    q_pos = q_pos.to(torch.int32)
    btab = btab.long()
    d = q_pos.long() - s_bucket
    mine = (d >= 0) & (d % sp == rank)
    j_w = (base + torch.div(d, sp, rounding_mode="floor")).clamp(0, l_loc - 1)
    blk = btab.gather(1, (j_w // bt)[:, None])[:, 0]
    write = torch.where(mine & (blk >= 0), blk * bt + j_w % bt, p_loc)
    jlog = torch.arange(l_loc, device=btab.device)
    gather = btab[:, jlog // bt].clamp_min(0) * bt + jlog % bt
    return PagedMeta(q_pos=q_pos, pos_map=pos_map.to(torch.int32), write=write, gather=gather)


def gqa_paged_decode_attention(x, p, cfg, pool: PooledKV, pg: PagedMeta, rope, *, ctx=SINGLE):
    """One decode token a request against the paged pool (reference
    ``gqa_paged_decode_attention``).  x: [B, 1, d]; each row at its own
    position ``pg.q_pos[b]`` (``rope`` its tables, [B, 1]).  Each row's K/V
    goes to its striped slot through its block table (``pg.write``; the
    sink where it writes nothing); then each row's logical slots are
    gathered in logical order, [B, L_loc, Hkv, hd] (the static cache's
    order: a request decodes as it would alone, whatever blocks it holds),
    attended with per-row q_pos [B, 1] over the rank's shared pos_map, and
    merged over the model group.  Returns (attn_out [B, 1, d], pool)."""
    B = x.shape[0]
    q, k, v = _qkv(x, p, cfg, rope)
    pool.k[pg.write] = k[:, 0].to(pool.k.dtype)
    pool.v[pg.write] = v[:, 0].to(pool.v.dtype)
    k_g, v_g = pool.k[pg.gather], pool.v[pg.gather]
    o, m, l = kops.attention_partial(q, k_g, v_g, pg.q_pos[:, None], pg.pos_map, causal=True)
    out = _merge_replicated(o, m, l, ctx).to(x.dtype)
    return out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"], pool


# ---------------------------------------------------------------------------
# Cross-attention (the VLM's image layers, whisper's decoder): chunk-invariant K/V
# ---------------------------------------------------------------------------


def _check_cross_ctx(ctx):
    if ctx.sp > 1:
        raise NotImplementedError("cross-attention at sp > 1 (the context sharded over the "
                                  "model axis) comes with ROADMAP Queue 1 item 7")


def cross_attention(x, p, cfg, xkv, *, name_tag=None, ctx=SINGLE):
    """x: [B, T, d] a chunk's (or a decode step's) rows; ``xkv`` the
    context's K/V from ``make_cross_kv`` ({"k", "v": [B, N_ctx, Hkv, hd],
    "pos": [N_ctx]}), the same for every chunk.  Bidirectional over the
    context: the partial attention with causal=False and q_pos zeros
    (unread), PAD slots masked (reference ``attention.py:411-427``).  No
    bias on q, as in the reference (whisper's ``xattn`` biases go unread).
    ``name_tag`` tags q and the attention output before ``@ wo``, the
    reference's sites; a replay tag puts the staged rows in place of the
    recomputed q.  Returns [B, T, d]."""
    _check_cross_ctx(ctx)
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    q = (x @ p["wq"]).view(B, T, H, hd)
    if name_tag is not None:
        q = name_tag(q)
    q_pos = torch.zeros((T,), dtype=torch.int32, device=x.device)
    out = dist_attention(q, xkv["k"], xkv["v"], q_pos, xkv["pos"], ctx,
                         causal=False).reshape(B, T, H * hd)
    if name_tag is not None:
        out = name_tag(out)
    return out @ p["wo"]


def make_cross_kv(context, p, cfg, n_valid: int, *, ctx=SINGLE):
    """The cross-attention K/V of ``context`` [B, N_ctx, d] (stub patch or
    frame embeddings, or whisper's encoder output): k and v by the slot's
    ``xattn`` projections, no bias, each slot at its index as position and
    PAD past ``n_valid`` (reference ``attention.py:429-438``).  Computed
    once a run, outside the chunks; every chunk reads it."""
    _check_cross_ctx(ctx)
    B, N, _ = context.shape
    Hkv, hd = cfg.n_kv_heads, cfg.hd
    idx = torch.arange(N, dtype=torch.int32, device=context.device)
    return {"k": (context @ p["wk"]).view(B, N, Hkv, hd),
            "v": (context @ p["wv"]).view(B, N, Hkv, hd),
            "pos": torch.where(idx < n_valid, idx, PAD).to(torch.int32)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3 multi-head latent attention), absorbed form
# ---------------------------------------------------------------------------


def mla_scale(cfg) -> float:
    """The scores' scale: 1 / sqrt(nope + rope head dims), not of q_eff's."""
    return 1.0 / ((cfg.mla.nope_head_dim + cfg.mla.rope_head_dim) ** 0.5)


def _mla_qk(x, p, cfg, rope):
    """q_eff [B, T, H, dc + dr] and k_eff [B, T, 1, dc + dr] of x [B, T, d]
    (reference ``attention.py:345-362``): the LoRA queries split into nope
    and rope parts, the latent's RMSNormed c_kv and its k_rope, RoPE (tables
    ``rope`` of the rope head dim) on both rope parts, q's nope part
    absorbed through ``w_uk``."""
    m = cfg.mla
    B, T, _ = x.shape
    H = cfg.n_heads
    dn, dc = m.nope_head_dim, m.kv_lora_rank
    cq = L.rms_norm(x @ p["wq_a"], p["q_norm"])
    q = (cq @ p["wq_b"]).view(B, T, H, -1)
    ckv = x @ p["wkv_a"]
    c_kv = L.rms_norm(ckv[..., :dc], p["kv_norm"])
    q_rope = L.rotate(q[..., dn:], *rope)
    k_rope = L.rotate(ckv[..., None, dc:], *rope)
    q_abs = torch.einsum("bthn,hnc->bthc", q[..., :dn], p["w_uk"])
    return torch.cat([q_abs, q_rope], dim=-1), torch.cat([c_kv[:, :, None, :], k_rope], dim=-1)


def _mla_out(out, p, cfg, name_tag):
    """The attention output [B, T, H, dc] up-projected per head by
    ``w_uv`` (o_v, a tag site), then ``wo``: [B, T, d]."""
    B, T, H, _ = out.shape
    o_v = torch.einsum("bthc,hcv->bthv", out, p["w_uv"])
    if name_tag is not None:
        o_v = name_tag(o_v)
    return o_v.reshape(B, T, H * cfg.mla.v_head_dim) @ p["wo"]


def _check_mla_ctx(ctx):
    if ctx.sp > 1:
        raise NotImplementedError("MLA at sp > 1 (the latent's model-axis shards, ring and "
                                  "gather modes) comes with ROADMAP Queue 1 item 7")


def _latent_append(cache: KVCache, k_new, pos_new, offset: int) -> KVCache:
    """Write a chunk's latent at slot ``offset`` (v is its view)."""
    t = k_new.shape[1]
    cache.k[:, offset:offset + t] = k_new.to(cache.k.dtype)
    cache.pos[offset:offset + t] = pos_new.to(torch.int32)
    return cache


def mla_attention(x, p, cfg, cache: KVCache, q_pos, cache_offset: int, kv_view, rope, *,
                  name_tag=None, q_start=None, ctx=SINGLE):
    """A prefill or training chunk of MLA (reference ``mla_attention``,
    decode=False), as ``gqa_self_attention`` takes a GQA one: x [B, T, d]
    at positions q_pos whose latent lands at slot ``cache_offset``,
    attending the first ``kv_view`` slots with v the latent's first dc
    columns (a view); a training cache attends through
    ``chunk_attention``.  ``rope``: ``layers.rope_tables`` of q_pos at the
    rope head dim.  ``name_tag`` tags q_eff, k_eff and o_v.  Returns
    (attn_out [B, T, d], cache)."""
    _check_mla_ctx(ctx)
    dc = cfg.mla.kv_lora_rank
    q_eff, k_eff = _mla_qk(x, p, cfg, rope)
    if name_tag is not None:
        q_eff, k_eff = name_tag(q_eff), name_tag(k_eff)
    scale = mla_scale(cfg)
    if cache.chunks is not None:
        out = chunk_attention(q_eff, k_eff, k_eff[..., :dc], q_pos, cache, cache_offset,
                              kv_view, q_start=q_start, ctx=ctx, scale=scale)
    else:
        cache = _latent_append(cache, k_eff, q_pos, cache_offset)
        out = dist_attention(q_eff, cache.k, cache.v, q_pos, cache.pos, ctx, causal=True,
                             scale=scale, kv_view=kv_view, q_start=q_start)
    return _mla_out(out, p, cfg, name_tag), cache


def mla_decode_attention(x, p, cfg, cache: KVCache, q_pos, write_slot, rope, *, ctx=SINGLE):
    """One MLA decode token (reference ``mla_attention``, decode=True): its
    latent written at ``write_slot`` (None: nothing written), the whole
    latent cache attended, PAD slots masked.  Returns (attn_out [B, 1, d],
    cache)."""
    _check_mla_ctx(ctx)
    q_eff, k_eff = _mla_qk(x, p, cfg, rope)
    if write_slot is not None:
        cache = _latent_append(cache, k_eff, q_pos, write_slot)
    o, m, l = kops.attention_partial(q_eff, cache.k, cache.v, q_pos, cache.pos, causal=True,
                                     scale=mla_scale(cfg))
    out = _merge_replicated(o, m, l, ctx).to(x.dtype)
    return _mla_out(out, p, cfg, None), cache
