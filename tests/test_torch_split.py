"""The split-bf16 arithmetic of the tensor-core kernels, emulated on the CPU.

The tensor-core backward (src/repro_torch/kernels/csrc/flash_partial_bwd_tc.cu)
feeds every fp32 operand of the attention backward (dO, p, dS) to bf16 MMAs
as bf16 terms, hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
and sums each term's products in fp32; p^T . dO keeps the cross terms
i + j < terms.  ``bwd_split`` does the same arithmetic with torch on the CPU
(a product of two bf16 values is exact in fp32, so an fp32 einsum of the
terms is what the MMAs compute, up to the order of the sums).  With numpy
inputs from a seed (G = 7, hd 128, a causal mask with PAD slots and one dead
row whose cotangents are NaN), three terms match the port's plain backward
within 1e-6 x max |plain|, a tenth of the card's 1e-5 tolerance; two terms
err by ~4e-6, 0.4 of it, and one term (plain bf16 operands) by ~2e-3, 200x
over it.  The
three-term scheme also matches the reference's Pallas backward (interpret
mode) at the reference's fp32 gradient tolerance.

The tensor-core forward (csrc/flash_partial_tc.cu) computes s = q . k^T from
the bf16 inputs (exact products), and o += p . v with the fp32 p = exp(s - m)
split the same way, tile by 64-slot tile: each tile's products start from
zero and are added into o after the online rescale o *= exp(m_prev - m_new);
l sums the fp32 p.  ``fwd_split`` does that arithmetic, and is held to the
port's plain forward (three terms within 1e-6 of the normalized output, two
within the card's 1e-5, one over it) and, with three terms, to the
reference's Pallas forward in interpret mode at the reference's fp32
tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_partial as jflash
from repro_torch.kernels import ref

from _torch_cases import PAD

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

NEG_INF = -1e30
KERNEL_TOL = 1e-5   # chip_smoke.py and tests/test_torch_cuda.py: kernel vs plain
# the largest error (x max |plain|) each number of terms is held to
SPLIT_TOL = {3: 1e-6, 2: KERNEL_TOL}


def split(x, terms):
    """x as `terms` bf16 values (returned in fp32), largest first."""
    out = []
    for _ in range(terms):
        hi = x.to(torch.bfloat16).float()
        out.append(hi)
        x = x - hi
    return out


def bwd_split(q, k, v, q_pos, kv_pos, q_start, do, m, dl, terms, *, causal=True):
    """The tensor-core kernels' backward with `terms` bf16 terms for each
    fp32 operand: (dq, dk, dv) in fp32, shaped as attention_partial_bwd_ref's."""
    B, Tq, H, hdk = q.shape
    S, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    G, scale = H // Hkv, 1.0 / hdk ** 0.5
    live = m > NEG_INF / 2
    do = torch.where(live[..., None], do, 0.0)        # before the split: NaN reaches no term
    dl = torch.where(live, dl, 0.0)
    qf, kf, vf = q.float().reshape(B, Tq, Hkv, G, hdk), k.float(), v.float()
    do_t = [t.reshape(B, Tq, Hkv, G, hdv) for t in split(do, terms)]
    mr = m.reshape(B, Tq, Hkv, G)[..., None]
    dlr = dl.reshape(B, Tq, Hkv, G)[..., None]
    s = torch.einsum("btkgh,bskh->btkgs", qf, kf) * scale
    vis = ref._visible(ref._rows(q_pos, B, Tq), kv_pos,
                       None if q_start is None else ref._rows(q_start, B, Tq), causal)
    p = torch.where(vis & (mr > NEG_INF / 2), torch.exp(s - mr), 0.0)
    dp = sum(torch.einsum("btkgv,bskv->btkgs", t, vf) for t in do_t)
    ds = p * (dp + dlr)
    ds_t, p_t = split(ds, terms), split(p, terms)
    dq = sum(torch.einsum("btkgs,bskh->btkgh", t, kf) for t in ds_t) * scale
    dk = sum(torch.einsum("btkgs,btkgh->bskh", t, qf) for t in ds_t) * scale
    dv = sum(torch.einsum("btkgs,btkgv->bskv", p_t[i], do_t[j])
             for i in range(terms) for j in range(terms) if i + j < terms)
    return dq.reshape(B, Tq, H, hdk), dk, dv


def _case(nan_dead=True):
    """bf16 q, k, v (G = 7, hd 128), fp32 cotangents, causal positions with
    PAD slots and a q_start window that leaves row (1, 0) dead."""
    B, Tq, S, Hkv, G, hd = 2, 24, 80, 2, 7, 128
    rng = np.random.default_rng(13)
    q, k, v = (rng.standard_normal(s, np.float32) for s in
               ((B, Tq, Hkv * G, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    do = rng.standard_normal((B, Tq, Hkv * G, hd), np.float32)
    dl = rng.standard_normal((B, Tq, Hkv * G), np.float32)
    q_pos = np.arange(Tq, dtype=np.int32) + S - Tq
    kv_pos = np.arange(S, dtype=np.int32)
    kv_pos[-5:] = PAD
    q_start = np.zeros((B, Tq), np.int32)
    q_start[1, 0] = PAD                               # sees nothing: a dead row
    if nan_dead:
        do[1, 0], dl[1, 0] = np.nan, np.nan
    return (q, k, v), do, dl, q_pos, kv_pos, q_start


def _torch_inputs(arrays, do, dl, q_pos, kv_pos, q_start):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    qp, kp, qs = (torch.from_numpy(x) for x in (q_pos, kv_pos, q_start))
    _, m, _ = ref.attention_partial_ref(q, k, v, qp, kp, q_start=qs)
    assert bool((m[1, 0] == NEG_INF).all()) and int((m == NEG_INF).sum()) == m.shape[2]
    return q, k, v, qp, kp, qs, torch.from_numpy(do), m, torch.from_numpy(dl)


def _rel_errors(got, want):
    return {name: ((a - b).abs().max() / b.abs().max()).item()
            for name, a, b in zip(("dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_split_terms_against_plain_backward(terms):
    q, k, v, qp, kp, qs, do, m, dl = _torch_inputs(*_case())
    want = ref.attention_partial_bwd_ref(q, k, v, qp, kp, qs, do, m, dl)
    got = bwd_split(q, k, v, qp, kp, qs, do, m, dl, terms)
    for g in got:
        assert torch.isfinite(g).all()
    assert (got[0][1, 0] == 0).all()                  # the dead row's dq is exact
    err = _rel_errors(got, want)
    if terms == 1:     # bf16 operands: the reason for the split
        assert min(err.values()) > 100 * KERNEL_TOL, err
    else:
        assert max(err.values()) <= SPLIT_TOL[terms], err
    if terms == 2:     # inside the tolerance, but well above the three-term bound
        assert max(err.values()) > SPLIT_TOL[3], err


def test_three_terms_match_the_reference_pallas_backward():
    """The three-term arithmetic against jax.vjp of the reference's Pallas
    kernels (interpret mode) on the same numpy inputs (rounded to bf16 on
    both sides), at the reference's fp32 gradient tolerance
    (tests/test_kernel_grads.py)."""
    arrays, do, dl, q_pos, kv_pos, q_start = _case(nan_dead=False)
    # fp32 holding the bf16 values, so the reference's gradients stay fp32
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16).astype(jnp.float32) for a in arrays)

    def f(q, k, v):
        return jflash(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos), block_q=16,
                      block_k=16, interpret=True, q_start=jnp.asarray(q_start))

    out, vjp = jax.vjp(f, jq, jk, jv)
    want = vjp((jnp.asarray(do), jnp.zeros_like(out[1]), jnp.asarray(dl)))
    q, k, v, qp, kp, qs, do_t, m, dl_t = _torch_inputs(arrays, do, dl, q_pos, kv_pos, q_start)
    got = bwd_split(q, k, v, qp, kp, qs, do_t, m, dl_t, 3)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# The forward
# ---------------------------------------------------------------------------

BLOCK_K = 64   # KV slots per tile of the tensor-core forward (csrc kBlockK)
# the largest |normalized o - plain| each number of terms is held to
FWD_SPLIT_TOL = {3: 1e-6, 2: KERNEL_TOL}


def fwd_split(q, k, v, q_pos, kv_pos, q_start, terms, *, causal=True):
    """The tensor-core forward with p split into `terms` bf16 terms: the
    un-normalized (o, m, l) in fp32, shaped as attention_partial_ref's."""
    B, Tq, H, hdk = q.shape
    S, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    G, scale = H // Hkv, 1.0 / hdk ** 0.5
    qf, kf, vf = q.float().reshape(B, Tq, Hkv, G, hdk), k.float(), v.float()
    vis = ref._visible(ref._rows(q_pos, B, Tq), kv_pos,
                       None if q_start is None else ref._rows(q_start, B, Tq), causal)
    s = torch.einsum("btkgh,bskh->btkgs", qf, kf) * scale
    s = torch.where(vis, s, NEG_INF)
    m = torch.full((B, Tq, Hkv, G), NEG_INF)
    l = torch.zeros((B, Tq, Hkv, G))
    o = torch.zeros((B, Tq, Hkv, G, hdv))
    for j in range(0, S, BLOCK_K):
        st, vt = s[..., j:j + BLOCK_K], vf[:, j:j + BLOCK_K]
        m_new = torch.maximum(m, st.amax(dim=-1))
        safe = m_new > NEG_INF / 2
        alpha = torch.where(safe, torch.exp(m - m_new), 0.0)
        p = torch.where(safe[..., None], torch.exp(st - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + sum(torch.einsum("btkgs,bskv->btkgv", t, vt)
                                       for t in split(p, terms))
        m = m_new
    return o.reshape(B, Tq, H, hdv), m.reshape(B, Tq, H), l.reshape(B, Tq, H)


def _fwd_case():
    """bf16 q, k, v (G = 7, hd 128) over 150 slots (three tiles, the last
    ragged), causal positions with PAD slots, a q_start window on batch row 0
    and a dead row (1, 0): numpy arrays and positions."""
    B, Tq, S, Hkv, G, hd = 2, 24, 150, 2, 7, 128
    rng = np.random.default_rng(17)
    arrays = tuple(rng.standard_normal(s, np.float32) for s in
                   ((B, Tq, Hkv * G, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)))
    q_pos = np.arange(Tq, dtype=np.int32) + S - Tq
    kv_pos = np.arange(S, dtype=np.int32)
    kv_pos[-7:] = PAD
    q_start = np.zeros((B, Tq), np.int32)
    q_start[0, 12:] = 60                             # a document starting at slot 60
    q_start[1, 0] = PAD                              # sees nothing: a dead row
    return arrays, q_pos, kv_pos, q_start


def _fwd_torch_inputs(arrays, q_pos, kv_pos, q_start):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    return (q, k, v, *(torch.from_numpy(x) for x in (q_pos, kv_pos, q_start)))


@pytest.mark.parametrize("terms", [1, 2, 3])
def test_fwd_split_terms_against_plain_forward(terms):
    q, k, v, qp, kp, qs = _fwd_torch_inputs(*_fwd_case())
    o2, m2, l2 = ref.attention_partial_ref(q, k, v, qp, kp, q_start=qs)
    o1, m1, l1 = fwd_split(q, k, v, qp, kp, qs, terms)
    dead = m2 == NEG_INF
    assert int(dead.sum()) == q.shape[2] and bool(dead[1, 0].all())
    # dead rows are exact whatever the terms: o = l = 0, m = -1e30
    assert (o1[dead] == 0).all() and (l1[dead] == 0).all() and (m1[dead] == NEG_INF).all()
    assert (m1 - m2)[~dead].abs().max().item() <= 1e-6
    assert (l1 - l2)[~dead].abs().max().item() <= 1e-6 * l2.max().item()   # l from the fp32 p
    err = (ref.normalize(o1, l1) - ref.normalize(o2, l2)).abs().max().item()
    if terms == 1:     # bf16 p: the reason for the split
        assert err > KERNEL_TOL, err
    else:
        assert err <= FWD_SPLIT_TOL[terms], err
    if terms == 2:     # inside the tolerance, but above the three-term bound
        assert err > FWD_SPLIT_TOL[3], err


def test_fwd_three_terms_match_the_reference_pallas_forward():
    """The three-term forward against the reference's Pallas forward
    (interpret mode) on the same numpy inputs (rounded to bf16 on both
    sides, held in fp32 there), at the reference's fp32 tolerance
    (tests/test_kernels.py)."""
    arrays, q_pos, kv_pos, q_start = _fwd_case()
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16).astype(jnp.float32) for a in arrays)
    jo, jm, jl = jflash(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), block_q=16,
                        block_k=16, interpret=True, q_start=jnp.asarray(q_start))
    q, k, v, qp, kp, qs = _fwd_torch_inputs(arrays, q_pos, kv_pos, q_start)
    o, m, l = fwd_split(q, k, v, qp, kp, qs, 3)
    want_o = np.asarray(jo, np.float32) / np.maximum(np.asarray(jl, np.float32), 1e-30)[..., None]
    np.testing.assert_allclose(ref.normalize(o, l).numpy(), want_o, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm, np.float32), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl, np.float32), rtol=1e-5, atol=1e-5)
