"""Mixture-of-Experts with expert parallelism over the model axis (port of
``repro/models/moe.py``).

Token-choice top-k routing with capacity-bounded all-to-all dispatch, as in
the reference:

1. route the rank's tokens in fp32 (the router is replicated: it is small);
2. place each token copy in a send buffer [sp, C, d] by destination rank
   (C the capacity of a source-destination pair);
3. all-to-all over the model axis (``Ctx.all_to_all_model``), the expert
   ids beside the rows;
4. place the received rows in per-expert capacity buffers [E_loc, Ce, d]
   and run the rank's experts as one batched matmul per weight stack;
5. the inverse all-to-all, and the top-k returns combined with their
   renormalized router weights.

Copies past a capacity are dropped (the capacity-factor semantics); the
positions come from integer cumsums in flat (token-major, k-minor) order,
so the drop set and the expert ids are the reference's.  DeepSeek's shared
experts run densely on the rank's rows.  The Switch load-balancing loss
(E · Σ f_e P_e over the rank's tokens) is returned beside the output.

Where torch departs from jnp, the port is explicit:

- jnp promotes ``bf16 @ fp32`` to fp32; torch refuses a mixed matmul, so
  the rows are cast to fp32 for the router;
- jnp clamps an out-of-range gather and the reference multiplies the
  result by its keep mask; here the dropped copies' positions are clamped
  to the last row before the gather (``index_select`` of flat rows) and
  masked the same way, and the scatters keep the reference's trash row
  (``C + 1``, ``Ce + 1`` rows, the last sliced off);
- the reference combines with ``y.at[flat_tok].add``; every token has
  exactly K consecutive copies, so the port sums a [n, K, d] view over K
  (no atomic scatter on the card, so two runs are bitwise alike), and
  takes ``xt[flat_tok]`` as an expand, whose backward is a sum over K.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel.ctx import SINGLE


def moe_dims(cfg, sp: int):
    """(E, E_loc): the experts and those of one model rank."""
    E = cfg.moe.num_experts
    if E % sp:
        raise ValueError(f"experts {E} must divide over the model axis {sp}")
    return E, E // sp


def capacities(cfg, n_tok: int, sp: int):
    """(C, Ce): the send buffer's rows per destination rank and the expert
    buffer's rows per local expert, for ``n_tok`` tokens a rank (reference
    ``moe.py:62, 78``)."""
    moe = cfg.moe
    _, E_loc = moe_dims(cfg, sp)
    C = max(1, math.ceil(n_tok * moe.top_k / sp * moe.capacity_factor))
    Ce = max(1, math.ceil(sp * C / E_loc * moe.capacity_factor))
    return C, Ce


def _slot_in_bucket(bucket, n_buckets: int, valid=None):
    """Each entry's position among the earlier entries of its bucket, in
    flat order (the reference's ``sum(cumsum(one_hot) * one_hot) - 1``);
    entries with ``valid`` False count in no bucket.  The one-hot is laid
    out [bucket, entry], so the cumsum runs along its contiguous dim: along
    the outer dim of [entry, bucket] the card scans the entries one after
    the other (3 ms at granite's train chunk, PERF.md §6)."""
    one = F.one_hot(bucket, n_buckets).T
    if valid is not None:
        one = one * valid[None, :]
    one = one.contiguous()
    return (one.cumsum(1) * one).sum(0) - 1


def _rows(t, index):
    """Rows ``index`` of ``t`` flattened to [rows, d]: ``index_select``,
    whose backward adds each row's cotangent in parallel.  The dropped
    copies' clamped indices meet a kept row, but their cotangents are exact
    zeros (the keep mask), so the sums are bitwise those of any order;
    advanced indexing's backward instead accumulates the rows of one index
    in sequence (3 ms a call at granite's train chunk, PERF.md §6)."""
    return t.reshape(-1, t.shape[-1]).index_select(0, index)


def route(xt, router, cfg):
    """fp32 routing of xt [n, d]: (top_p [n, K] renormalized, top_e [n, K]
    int64, aux)."""
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, K, dim=-1, sorted=True)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    # Switch aux loss: E * sum_e f_e P_e (f_e: the share of tokens routed
    # to e, counted once a copy)
    f_e = F.one_hot(top_e.reshape(-1), E).sum(dim=0).float() / xt.shape[0]
    aux = E * (f_e * probs.mean(dim=0)).sum()
    return top_p, top_e, aux


def moe_block(x, p, cfg, ctx=SINGLE, *, name_tag=None):
    """x: [B, T_loc, d] this rank's rows (its sequence shard, or at decode
    every rank's same rows).  Returns (y [B, T_loc, d], aux)."""
    moe = cfg.moe
    B, Tl, d = x.shape
    sp = ctx.sp
    E, E_loc = moe_dims(cfg, sp)
    K = moe.top_k
    n = B * Tl
    xt = x.reshape(n, d)
    top_p, top_e, aux = route(xt, p["router"], cfg)

    # ---- level 1: send buffers by destination rank
    flat_e = top_e.reshape(-1)                                    # [n K]
    flat_w = top_p.reshape(n, K, 1)
    C, Ce = capacities(cfg, n, sp)
    dst = flat_e // E_loc
    pos = _slot_in_bucket(dst, sp)
    keep = pos < C
    dst_c = torch.where(keep, dst, sp - 1)
    pos_c = torch.where(keep, pos, C)                             # C: the trash row
    copies = xt[:, None, :].expand(n, K, d).reshape(n * K, d)
    send = x.new_zeros((sp, C + 1, d)).index_put((dst_c, pos_c), copies)[:, :C]
    eid = torch.where(keep, flat_e % E_loc, -1).to(torch.int32)
    send_eid = torch.full((sp, C + 1), -1, dtype=torch.int32,
                          device=x.device).index_put((dst_c, pos_c), eid)[:, :C]

    # ---- the all-to-all over the model axis
    recv = ctx.all_to_all_model(send, 0, 0)
    recv_eid = ctx.all_to_all_model(send_eid.contiguous(), 0, 0)
    rt = recv.reshape(sp * C, d)
    re = recv_eid.reshape(sp * C).long()

    # ---- level 2: per-expert capacity buffers
    valid = re >= 0
    e2 = torch.where(valid, re, 0)
    pos2 = torch.where(valid, _slot_in_bucket(e2, E_loc, valid), Ce)
    keep2 = (pos2 < Ce) & valid
    eid_c = torch.where(keep2, e2, 0)
    pos2_c = torch.where(keep2, pos2, Ce)
    rows = torch.where(keep2[:, None], rt, 0)
    buf = x.new_zeros((E_loc, Ce + 1, d)).index_put((eid_c, pos2_c), rows)[:, :Ce]

    # ---- the rank's experts, one batched matmul per weight stack
    h = F.silu(torch.bmm(buf, p["w1"])) * torch.bmm(buf, p["w3"])
    if name_tag is not None:
        h = name_tag(h)
    out = torch.bmm(h, p["w2"])                                   # [E_loc, Ce, d]

    # ---- back, the inverse all-to-all, the weighted combine
    back = _rows(out, eid_c * Ce + pos2_c.clamp(max=Ce - 1)) * keep2[:, None].to(out.dtype)
    ret = ctx.all_to_all_model(back.reshape(sp, C, d), 0, 0)
    got = _rows(ret, dst_c * C + pos_c.clamp(max=C - 1)) * keep[:, None].to(ret.dtype)
    y = (got.reshape(n, K, d).float() * flat_w).sum(dim=1).to(x.dtype)

    # ---- shared experts (dense, deepseek)
    if moe.n_shared_experts:
        hs = F.silu(xt @ p["ws1"]) * (xt @ p["ws3"])
        if name_tag is not None:
            # tagged as [B, T_loc, sf]: the offload splits its token axis
            hs = name_tag(hs.view(B, Tl, -1)).reshape(n, -1)
        y = y + hs @ p["ws2"]
    return y.reshape(B, Tl, d), aux
