"""Plain PyTorch versions of the attention kernel (port of ``repro/kernels/ref.py``).

``attention_partial_ref`` is the CPU execution path of the models and the
version the Hopper forward kernel (kernels/flash_attention.py) is held
against on the card; ``attention_partial_bwd_ref`` is the same for the two
backward kernels.  Both are blockwise: the full score matrix is never
materialized.

Partial-softmax convention (flash-decoding style): given queries and a *local*
KV shard, return
    m   = row max of masked scores                  [B, Tq, H]   (fp32)
    l   = sum exp(s - m)                            [B, Tq, H]   (fp32)
    o   = sum exp(s - m) * V  (un-normalized)       [B, Tq, H, hd_v] (fp32)
so shards merge exactly: with M = max_r m_r,
    out = sum_r exp(m_r - M) o_r / sum_r exp(m_r - M) l_r.
A KV slot at kv_pos[j] is visible to query i iff kv_pos[j] != PAD_POS, and
q_pos[i] >= kv_pos[j] when causal, and kv_pos[j] >= q_start[i].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

PAD_POS = 2**30
NEG_INF = -1e30


def _rows(x, B: int, Tq: int):
    """[Tq] or [B, Tq] int positions -> [B, Tq]."""
    return x[None, :].expand(B, Tq) if x.dim() == 1 else x


def _visible(q_pos, kv_pos, q_start, causal: bool):
    """[B, Tq, 1, 1, S] visibility mask (q_pos/q_start [B, Tq], kv_pos [S])."""
    kp = kv_pos[None, None, None, None, :]
    valid = kp != PAD_POS
    if causal:
        valid = valid & (q_pos[:, :, None, None, None] >= kp)
    if q_start is not None:
        valid = valid & (kp >= q_start[:, :, None, None, None])
    return valid


def attention_partial_ref(q, k, v, q_pos, kv_pos, *, causal=True, scale=None,
                          block_k=512, q_start=None):
    """q: [B,Tq,H,hd_k]; k: [B,S,Hkv,hd_k]; v: [B,S,Hkv,hd_v];
    q_pos: [B,Tq] or [Tq] int; kv_pos: [S] int (PAD_POS = empty slot);
    q_start: optional [B,Tq] or [Tq] int segment window.

    Returns (o [B,Tq,H,hd_v] fp32 un-normalized, m [B,Tq,H] fp32, l [B,Tq,H] fp32).
    """
    B, Tq, H, hdk = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / (hdk ** 0.5)
    q_pos = _rows(q_pos, B, Tq)
    if q_start is not None:
        q_start = _rows(q_start, B, Tq)

    # pad S to a block multiple (padding slots carry PAD_POS: never visible)
    nb = max(1, -(-S // block_k))
    Sp = nb * block_k
    if Sp != S:
        k = F.pad(k, (0, 0, 0, 0, 0, Sp - S))
        v = F.pad(v, (0, 0, 0, 0, 0, Sp - S))
        kv_pos = F.pad(kv_pos, (0, Sp - S), value=PAD_POS)

    qf = q.float().reshape(B, Tq, Hkv, G, hdk)
    m = torch.full((B, Tq, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Tq, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Tq, Hkv, G, hdv), dtype=torch.float32,
                      device=q.device)
    for j in range(nb):
        sl = slice(j * block_k, (j + 1) * block_k)
        kblk, vblk = k[:, sl].float(), v[:, sl].float()
        s = torch.einsum("btkgh,bskh->btkgs", qf, kblk) * scale
        s = s.masked_fill(~_visible(q_pos, kv_pos[sl], q_start, causal),
                          NEG_INF)
        # the max statistic is gradient-frozen: it cancels exactly in o / l
        m_new = torch.maximum(m, s.amax(dim=-1)).detach()
        # guard fully-masked rows (m_new == NEG_INF): exp(NEG_INF - NEG_INF)=1
        safe = m_new > NEG_INF / 2
        alpha = torch.where(safe, torch.exp(m - m_new), 0.0)
        p = torch.where(safe[..., None], torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("btkgs,bskv->btkgv", p,
                                                    vblk)
        m = m_new
    return (acc.reshape(B, Tq, H, hdv), m.reshape(B, Tq, H),
            l.reshape(B, Tq, H))


def attention_partial_bwd_ref(q, k, v, q_pos, kv_pos, q_start, do, m, dl, *,
                              causal=True, scale=None, block_k=512):
    """Backward of ``attention_partial_ref`` given the cotangents (do, dl) of
    its (o, l) outputs and its saved max statistic m: the plain version of the
    two backward kernels (reference ``_recompute_p_ds`` / ``_bwd_impl``).

    Block by block over the KV range: p = exp(s - m) recomputed from the
    saved m (a constant: the max statistic is gradient-frozen, so its
    cotangent dm is dropped), dS = p * (do . v^T + dl), then
    dq += dS . k * scale, dk = dS^T . q * scale and dv = p^T . do, the
    G grouped heads summed into their KV head.  (o, l) are un-normalized,
    so there is no D = rowsum(do * o) term.  Fully masked rows (m = -1e30)
    have o = l = 0 whatever the inputs, and their cotangents may be inf or
    NaN (the downstream 1/l), so do and dl are zeroed there first.

    Returns fp32 (dq [B,Tq,H,hd_k], dk [B,S,Hkv,hd_k], dv [B,S,Hkv,hd_v]).
    """
    B, Tq, H, hdk = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    hdv = v.shape[-1]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / (hdk ** 0.5)
    q_pos = _rows(q_pos, B, Tq)
    if q_start is not None:
        q_start = _rows(q_start, B, Tq)
    live = m > NEG_INF / 2
    do = torch.where(live[..., None], do.float(), 0.0)
    dl = torch.where(live, dl.float(), 0.0)

    qf = q.float().reshape(B, Tq, Hkv, G, hdk)
    dof = do.reshape(B, Tq, Hkv, G, hdv)
    mr = m.reshape(B, Tq, Hkv, G)[..., None]
    dlr = dl.reshape(B, Tq, Hkv, G)[..., None]
    safe = mr > NEG_INF / 2
    dq = torch.zeros_like(qf)
    dk = torch.empty((B, S, Hkv, hdk), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, S, Hkv, hdv), dtype=torch.float32, device=q.device)
    for j in range(0, max(S, 1), block_k):
        sl = slice(j, min(S, j + block_k))
        kblk, vblk = k[:, sl].float(), v[:, sl].float()
        s = torch.einsum("btkgh,bskh->btkgs", qf, kblk) * scale
        s = s.masked_fill(~_visible(q_pos, kv_pos[sl], q_start, causal),
                          NEG_INF)
        p = torch.where(safe, torch.exp(s - mr), 0.0)
        ds = p * (torch.einsum("btkgv,bskv->btkgs", dof, vblk) + dlr)
        dq += torch.einsum("btkgs,bskh->btkgh", ds, kblk) * scale
        dk[:, sl] = torch.einsum("btkgs,btkgh->bskh", ds, qf) * scale
        dv[:, sl] = torch.einsum("btkgs,btkgv->bskv", p, dof)
    return dq.reshape(B, Tq, H, hdk), dk, dv


def merge_partials(parts):
    """Merge a list of (o, m, l) partials (single-device oracle for the
    cross-shard merge); the max statistics are gradient-frozen."""
    ms = torch.stack([p[1].detach() for p in parts])
    m = ms.amax(dim=0)
    o = sum(p[0] * torch.exp(p[1].detach() - m)[:, :, :, None] for p in parts)
    l = sum(p[2] * torch.exp(p[1].detach() - m) for p in parts)
    return o, m, l


def normalize(o, l):
    return o / l.clamp_min(1e-30)[:, :, :, None]


def mha_reference(q, k, v, q_pos, kv_pos, *, causal=True, scale=None,
                  q_start=None):
    """Naive full attention (small shapes only) — oracle for the oracle."""
    B, Tq, H, hdk = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / (hdk ** 0.5)
    q_pos = _rows(q_pos, B, Tq)
    if q_start is not None:
        q_start = _rows(q_start, B, Tq)
    qf = q.float().reshape(B, Tq, Hkv, G, hdk)
    s = torch.einsum("btkgh,bskh->btkgs", qf, k.float()) * scale
    valid = _visible(q_pos, kv_pos, q_start, causal)
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1)
    p = torch.where((~valid).all(dim=-1, keepdim=True), 0.0, p)
    o = torch.einsum("btkgs,bskv->btkgv", p, v.float())
    return o.reshape(B, Tq, H, v.shape[-1])
