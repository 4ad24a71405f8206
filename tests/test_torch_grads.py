"""The port's attention backward against the JAX reference, on the CPU.

The same numpy inputs and cotangents (do, dl) go through ``jax.vjp`` of the
reference's ``flash_attention_partial(..., interpret=True)`` (the Pallas
forward and its two backward kernels, in interpret mode) and through the
port's plain backward ``attention_partial_bwd_ref`` and its
``FlashPartial`` Function (which runs the plain versions on CPU tensors).
The grid is ``tests/test_kernel_grads.py``'s SHAPES (ragged sizes, PAD
slots, decode) x G in {1, 4, 7, 8} x causal / non-causal x fp32 / bf16, held
to that file's tolerances (1e-4 fp32, 6e-2 bf16); dl is random and nonzero,
so its term is exercised.  Fully masked rows given NaN cotangents must give
exact zeros, and FlashPartial must agree with autograd of the plain forward
at 1e-5 in fp32.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_partial as jflash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

from _torch_cases import (PAD, SWEEP, WINDOW_DEAD, sweep_case, to_np,
                          to_torch, window_case)

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

SHAPES = [  # tests/test_kernel_grads.py: (Tq, S, n_pad_slots, q_off)
    (16, 32, 0, 16),
    (17, 33, 5, 8),
    (1, 40, 8, 30),
    (8, 24, 3, 13),
]
TOL = {"float32": 1e-4, "bfloat16": 6e-2}   # tests/test_kernel_grads.py
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _case(shape_idx, G, seed):
    Tq, S, n_pad, q_off = SHAPES[shape_idx]
    Hkv = 2 if G < 8 else 1
    H, hd = G * Hkv, 16
    rng = np.random.default_rng(seed)
    arrays = tuple(rng.standard_normal(s, np.float32) for s in
                   ((1, Tq, H, hd), (1, S, Hkv, hd), (1, S, Hkv, hd)))
    do = rng.standard_normal((1, Tq, H, hd), np.float32)
    dl = rng.standard_normal((1, Tq, H), np.float32)
    q_pos = np.arange(Tq, dtype=np.int32) + q_off
    kv_pos = np.arange(S, dtype=np.int32)
    kv_pos[S - n_pad:] = PAD
    return arrays, do, dl, q_pos, kv_pos


def _jax_vjp(arrays, do, dl, q_pos, kv_pos, q_start, causal, dtype):
    """(o, m, l) and (dq, dk, dv) of the Pallas path, interpret mode."""
    q, k, v = (jnp.asarray(a, JDT[dtype]) for a in arrays)
    qs = None if q_start is None else jnp.asarray(q_start)

    @jax.jit
    def run(q, k, v, do, dl):
        def f(q, k, v):
            return jflash(q, k, v, jnp.asarray(q_pos), jnp.asarray(kv_pos),
                          causal=causal, block_q=16, block_k=16,
                          interpret=True, q_start=qs)

        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp((do, jnp.zeros_like(out[1]), dl))

    out, grads = run(q, k, v, jnp.asarray(do), jnp.asarray(dl))
    return [np.asarray(x, np.float32) for x in out], [np.asarray(g, np.float32) for g in grads]


def _port(arrays, do, dl, q_pos, kv_pos, q_start, causal, dtype):
    """The port's plain backward given the plain forward's m, and the
    FlashPartial Function's grads for the same cotangents."""
    q, k, v = to_torch(arrays, dtype)
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    qs = None if q_start is None else torch.from_numpy(q_start)
    do_t, dl_t = torch.from_numpy(do), torch.from_numpy(dl)
    _, m, _ = ref.attention_partial_ref(q, k, v, qp, kp, causal=causal,
                                        block_k=16, q_start=qs)
    plain = ref.attention_partial_bwd_ref(q, k, v, qp, kp, qs, do_t, m, dl_t,
                                          causal=causal, block_k=16)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, _, l = ops.attention_partial(*leaves, qp, kp, causal=causal,
                                    block_k=16, q_start=qs)
    fn = torch.autograd.grad((o, l), leaves, (do_t, dl_t))
    for g, t in zip(fn, (q, k, v)):
        assert g.dtype == t.dtype
    return [to_np(g) for g in plain], [to_np(g) for g in fn]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("shape_idx", range(len(SHAPES)))
def test_bwd_matches_pallas_interpret(shape_idx, G, causal, dtype):
    arrays, do, dl, q_pos, kv_pos = _case(shape_idx, G, seed=10 * shape_idx + G)
    _, want = _jax_vjp(arrays, do, dl, q_pos, kv_pos, None, causal, dtype)
    plain, fn = _port(arrays, do, dl, q_pos, kv_pos, None, causal, dtype)
    tol = TOL[dtype]
    for name, w, a, b in zip(("dq", "dk", "dv"), want, plain, fn):
        np.testing.assert_allclose(a, w, rtol=tol, atol=tol, err_msg=f"{name}: plain")
        np.testing.assert_allclose(b, w, rtol=tol, atol=tol, err_msg=f"{name}: FlashPartial")


@functools.lru_cache(maxsize=None)
def _window(nan_dead: bool):
    arrays, q_pos, kv_pos, q_start = window_case()
    rng = np.random.default_rng(3)
    B, Tq, H, hd = arrays[0].shape
    do = rng.standard_normal((B, Tq, H, hd), np.float32)
    dl = rng.standard_normal((B, Tq, H), np.float32)
    if nan_dead:
        do[WINDOW_DEAD] = np.nan
        dl[WINDOW_DEAD] = np.nan
    return arrays, do, dl, q_pos, kv_pos, q_start


def test_bwd_qstart_window_matches_pallas_interpret():
    case = _window(False)
    _, want = _jax_vjp(*case, True, "float32")
    plain, fn = _port(*case, True, "float32")
    for name, w, a, b in zip(("dq", "dk", "dv"), want, plain, fn):
        np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-4, err_msg=f"{name}: plain")
        np.testing.assert_allclose(b, w, rtol=1e-4, atol=1e-4, err_msg=f"{name}: FlashPartial")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dead_rows_with_nan_cotangents_give_exact_zeros(dtype):
    """Fully masked rows (m = -1e30) with NaN do and dl: their dq is exactly
    0, nothing is NaN, and dk / dv equal those of zero cotangents there; the
    Pallas path agrees."""
    nan_case, clean = _window(True), _window(False)
    plain, fn = _port(*nan_case, True, dtype)
    zeroed = list(clean)
    zeroed[1], zeroed[2] = nan_case[1].copy(), nan_case[2].copy()
    zeroed[1][WINDOW_DEAD], zeroed[2][WINDOW_DEAD] = 0.0, 0.0
    for grads, grads0 in zip((plain, fn), _port(*zeroed, True, dtype)):
        for g in grads:
            assert np.isfinite(g).all()
        assert (grads[0][WINDOW_DEAD] == 0).all()
        for g, g0 in zip(grads[1:], grads0[1:]):
            np.testing.assert_array_equal(g, g0)
    _, want = _jax_vjp(*nan_case, True, dtype)
    for w, a in zip(want, plain):
        np.testing.assert_allclose(a, w, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("B,Tq,S,H,Hkv,hd,hv,causal,qoff,dtype",
                         [c for c in SWEEP if c[-1] == "float32"])
def test_flash_partial_matches_autograd_of_plain_forward(B, Tq, S, H, Hkv, hd,
                                                         hv, causal, qoff, dtype):
    """The Function's backward (attention_partial_bwd_ref on the CPU) against
    autograd through the blockwise plain forward, at 1e-5 in fp32."""
    arrays, q_pos, kv_pos = sweep_case(B, Tq, S, H, Hkv, hd, hv, qoff)
    rng = np.random.default_rng(7)
    do = torch.from_numpy(rng.standard_normal((B, Tq, H, hv), np.float32))
    dl = torch.from_numpy(rng.standard_normal((B, Tq, H), np.float32))
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    grads = []
    for fn in (lambda *a: fa.FlashPartial.apply(*a, qp, kp, None, causal, None, 16),
               lambda *a: ref.attention_partial_ref(*a, qp, kp, causal=causal, block_k=16)):
        leaves = [t.requires_grad_() for t in to_torch(arrays, dtype)]
        o, _, l = fn(*leaves)
        grads.append(torch.autograd.grad((o, l), leaves, (do, dl)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=1e-5, atol=1e-5)


def test_flash_partial_positions_get_no_gradient_and_m_is_frozen():
    arrays, q_pos, kv_pos = sweep_case(*SWEEP[1][:7], SWEEP[1][8])
    q, k, v = [t.requires_grad_() for t in to_torch(arrays, "float32")]
    o, m, l = ops.attention_partial(q, k, v, torch.from_numpy(q_pos),
                                    torch.from_numpy(kv_pos))
    assert not m.requires_grad and o.requires_grad and l.requires_grad
    # a loss that reads only o: dl = None reaches the backward as zeros
    gq, = torch.autograd.grad(o.sum(), [q])
    assert torch.isfinite(gq).all()


def test_attention_partial_takes_the_function_only_when_a_gradient_is_wanted():
    """With q, k or v requiring a gradient (and grad mode on) the call goes
    through FlashPartial; otherwise (serving) it is the plain forward call,
    with the same outputs and no graph."""
    arrays, q_pos, kv_pos = sweep_case(*SWEEP[1][:7], SWEEP[1][8])
    qp, kp = torch.from_numpy(q_pos), torch.from_numpy(kv_pos)
    q, k, v = to_torch(arrays, "float32")
    plain = ops.attention_partial(q, k, v, qp, kp)
    assert all(t.grad_fn is None for t in plain)
    with_grad = ops.attention_partial(q, k.requires_grad_(), v, qp, kp)
    assert type(with_grad[0].grad_fn).__name__ == "FlashPartialBackward"
    with torch.no_grad():
        no_grad = ops.attention_partial(q, k, v, qp, kp)
    assert no_grad[0].grad_fn is None
    for a, b, c in zip(plain, with_grad, no_grad):
        assert torch.equal(a, b.detach()) and torch.equal(a, c)
