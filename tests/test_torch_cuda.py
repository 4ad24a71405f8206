"""The Hopper attention kernels (forward, and the dq and dk/dv backward)
against their plain PyTorch versions, on the card.

Every test here needs a CUDA card: it is marked ``cuda`` and skips without
one.  The file imports no JAX, since the machine with the card has none, and
the repo's conftest imports JAX, so on that machine run it as

  PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The kernel and its plain version both compute in fp32 from the same inputs,
bf16 ones upcast exactly, so they differ only in the order of fp32 sums:
both dtypes are held to 1e-5.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

from _torch_cases import (SWEEP, WINDOW_DEAD, inputs, sweep_case, to_np,
                          to_torch, window_case)

TOL = 1e-5  # kernel vs plain version, fp32 and bf16 inputs alike


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain version at full precision
    return torch.device("cuda")


def _check_kernel(arrays, dtype, q_pos, kv_pos, device, q_start=None, **kw):
    q, k, v = to_torch(arrays, dtype, device)
    qp = torch.from_numpy(q_pos).to(device)
    kp = torch.from_numpy(kv_pos).to(device)
    qs = None if q_start is None else torch.from_numpy(q_start).to(device)
    n0 = fa.launches
    got = ops.attention_partial(q, k, v, qp, kp, q_start=qs, **kw)
    assert fa.launches == n0 + 1
    want = ref.attention_partial_ref(q, k, v, qp, kp, q_start=qs, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(ref.normalize(got[0], got[2])),
                               to_np(ref.normalize(want[0], want[2])), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(got[1]), to_np(want[1]), rtol=TOL, atol=TOL)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,S,H,Hkv,hd,hv,causal,qoff,dtype", SWEEP)
def test_kernel_matches_plain(cuda_device, B, Tq, S, H, Hkv, hd, hv, causal,
                              qoff, dtype):
    arrays, q_pos, kv_pos = sweep_case(B, Tq, S, H, Hkv, hd, hv, qoff)
    _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,S,H,Hkv,hd,hv,dtype", [
    (2, 5, 77, 14, 2, 24, 8, "float32"),      # small head dims, hd_k != hd_v
    (2, 3, 70, 14, 2, 40, 24, "bfloat16"),
    (1, 1, 2000, 14, 2, 128, 128, "float32"),  # decode over 32 KV splits
    (4, 1, 2176, 28, 4, 128, 128, "bfloat16"),  # the serve path's decode step
])
def test_kernel_load_paths_and_splits(cuda_device, B, Tq, S, H, Hkv, hd, hv, dtype):
    arrays = inputs(B, Tq, S, H, Hkv, hd, hv, seed=11)
    q_pos = np.arange(Tq, dtype=np.int32) + S - Tq
    kv_pos = np.arange(S, dtype=np.int32)
    _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device)


@pytest.mark.cuda
def test_kernel_window_and_dead_rows_exact(cuda_device):
    arrays, q_pos, kv_pos, q_start = window_case()
    o, m, l = _check_kernel(arrays, "float32", q_pos, kv_pos, cuda_device,
                            q_start=q_start)
    dead = torch.from_numpy(WINDOW_DEAD).to(cuda_device)
    assert (o[dead] == 0).all() and (l[dead] == 0).all()
    assert (m[dead] == -1e30).all()


@pytest.mark.cuda
def test_kernel_takes_strided_cache_view(cuda_device):
    """A prefix view of a cache buffer (batch stride = buffer length) needs
    no copy: the kernel takes the strides."""
    B, Tq, S_buf, S, H, Hkv, hd = 2, 24, 96, 70, 14, 2, 128
    q, k_buf, v_buf = to_torch(inputs(B, Tq, S_buf, H, Hkv, hd, hd, seed=9),
                               "bfloat16", cuda_device)
    k, v = k_buf[:, :S], v_buf[:, :S]
    assert not k.is_contiguous()
    q_pos = torch.arange(Tq, dtype=torch.int32, device=cuda_device) + S - Tq
    kv_pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    o1, m1, l1 = fa.flash_attention_partial(q, k, v, q_pos, kv_pos)
    o2, m2, l2 = ref.attention_partial_ref(q, k.contiguous(), v.contiguous(),
                                           q_pos, kv_pos)
    np.testing.assert_allclose(to_np(ref.normalize(o1, l1)),
                               to_np(ref.normalize(o2, l2)), rtol=TOL, atol=TOL)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 4, 2, 256, device=cuda_device)
    pos = torch.arange(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_partial(q, q, q, pos, pos)
    with pytest.raises(TypeError, match="unsupported dtype"):
        h = q[..., :64].half()
        fa.flash_attention_partial(h, h, h, pos, pos)
    with pytest.raises(ValueError, match="16-byte"):   # hd 18: not whole vectors
        x = q[..., :18].contiguous()
        fa.flash_attention_partial(x, x, x, pos, pos)
    with pytest.raises(ValueError, match="16-byte"):   # base off by one element
        x = torch.zeros(1 + 4 * 2 * 32, device=cuda_device)[1:].view(1, 4, 2, 32)
        fa.flash_attention_partial(x, x, x, pos, pos)


# ---------------------------------------------------------------------------
# The backward kernels (dq, dk/dv) against attention_partial_bwd_ref.  Both
# sides compute in fp32 from the same inputs; each gradient is held to
# 1e-5 x max |plain gradient| (its sums run over up to S or G x Tq terms).
# ---------------------------------------------------------------------------


def _check_bwd(arrays, dtype, q_pos, kv_pos, device, q_start=None, causal=True,
               dead=None, seed=3):
    q, k, v = to_torch(arrays, dtype, device)
    qp = torch.as_tensor(q_pos).to(device)
    kp = torch.as_tensor(kv_pos).to(device)
    qs = None if q_start is None else torch.as_tensor(q_start).to(device)
    B, Tq, H, _ = q.shape
    rng = np.random.default_rng(seed)
    do = torch.from_numpy(rng.standard_normal((B, Tq, H, v.shape[-1]), np.float32)).to(device)
    dl = torch.from_numpy(rng.standard_normal((B, Tq, H), np.float32)).to(device)
    if dead is not None:  # fully masked rows get NaN cotangents
        do[dead], dl[dead] = float("nan"), float("nan")
    _, m, _ = ref.attention_partial_ref(q, k, v, qp, kp, causal=causal, q_start=qs)
    n_dq, n_dkv = fa.bwd_dq_launches, fa.bwd_dkv_launches
    got = fa.flash_attention_partial_bwd(q, k, v, qp, kp, do, m, dl, causal=causal,
                                         q_start=qs)
    assert (fa.bwd_dq_launches, fa.bwd_dkv_launches) == (n_dq + 1, n_dkv + 1)
    want = ref.attention_partial_bwd_ref(q, k, v, qp, kp, qs, do, m, dl, causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        assert err <= TOL * max(1.0, b.abs().max().item()), f"{name}: err {err}"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,S,H,Hkv,hd,hv,causal,qoff,dtype", SWEEP)
def test_bwd_kernels_match_plain(cuda_device, B, Tq, S, H, Hkv, hd, hv, causal,
                                 qoff, dtype):
    arrays, q_pos, kv_pos = sweep_case(B, Tq, S, H, Hkv, hd, hv, qoff)
    _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, causal=causal)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_kernels_group_sizes_and_ragged(cuda_device, G, dtype):
    """G query heads per KV head folded into the rows (G = 7: no power of
    two), ragged Tq and S over several tiles, hd_k != hd_v, PAD slots."""
    Hkv = 2 if G < 8 else 1
    arrays = inputs(2, 37, 150, G * Hkv, Hkv, 64, 32, seed=G)
    q_pos = np.arange(37, dtype=np.int32) + 113
    kv_pos = np.arange(150, dtype=np.int32)
    kv_pos[-6:] = 2**30
    _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device)


@pytest.mark.cuda
def test_bwd_kernels_window_and_dead_rows_exact(cuda_device):
    arrays, q_pos, kv_pos, q_start = window_case()
    dead = torch.from_numpy(WINDOW_DEAD).to(cuda_device)
    dq, dk, dv = _check_bwd(arrays, "float32", q_pos, kv_pos, cuda_device,
                            q_start=q_start, dead=dead)
    assert (dq[dead] == 0).all()


@pytest.mark.cuda
def test_bwd_kernels_take_strided_cache_view(cuda_device):
    B, Tq, S_buf, S, H, Hkv, hd = 2, 24, 96, 70, 14, 2, 128
    q, k_buf, v_buf = to_torch(inputs(B, Tq, S_buf, H, Hkv, hd, hd, seed=9),
                               "bfloat16", cuda_device)
    k, v = k_buf[:, :S], v_buf[:, :S]
    assert not k.is_contiguous()
    q_pos = torch.arange(Tq, dtype=torch.int32, device=cuda_device) + S - Tq
    kv_pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    do = torch.randn(B, Tq, H, hd, device=cuda_device)
    dl = torch.randn(B, Tq, H, device=cuda_device)
    _, m, _ = ref.attention_partial_ref(q, k, v, q_pos, kv_pos)
    got = fa.flash_attention_partial_bwd(q, k, v, q_pos, kv_pos, do, m, dl)
    want = ref.attention_partial_bwd_ref(q, k.contiguous(), v.contiguous(), q_pos,
                                         kv_pos, None, do, m, dl)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL * max(1.0, b.abs().max().item())


@pytest.mark.cuda
def test_flash_partial_function_runs_the_kernels(cuda_device):
    """ops.attention_partial on CUDA tensors: forward and backward are the
    kernels (one launch each), and the grads equal the kernels' own."""
    arrays, q_pos, kv_pos = sweep_case(*SWEEP[3][:7], SWEEP[3][8])
    q, k, v = [t.requires_grad_() for t in to_torch(arrays, "bfloat16", cuda_device)]
    qp, kp = torch.from_numpy(q_pos).to(cuda_device), torch.from_numpy(kv_pos).to(cuda_device)
    before = fa.counts()
    o, m, l = ops.attention_partial(q, k, v, qp, kp)
    do, dl = torch.randn_like(o), torch.randn_like(l)
    grads = torch.autograd.grad((o, l), (q, k, v), (do, dl))
    after = fa.counts()
    assert {n: after[n] - before[n] for n in after} == {"fwd": 1, "merge": 0, "bwd_dq": 1,
                                                         "bwd_dkv": 1}
    want = fa.flash_attention_partial_bwd(q.detach(), k.detach(), v.detach(), qp, kp, do, m, dl)
    for g, w, t in zip(grads, want, (q, k, v)):
        assert g.dtype == t.dtype
        assert torch.equal(g, w.to(t.dtype))


@pytest.mark.cuda
def test_bwd_kernels_reject_what_they_do_not_take(cuda_device):
    q = torch.zeros(1, 4, 2, 32, device=cuda_device)
    pos = torch.arange(4, dtype=torch.int32, device=cuda_device)
    m, dl, do = torch.zeros(1, 4, 2, device=cuda_device), torch.zeros(1, 4, 2, device=cuda_device), q
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_partial_bwd(q.cpu(), q.cpu(), q.cpu(), pos.cpu(), pos.cpu(),
                                       do.cpu(), m.cpu(), dl.cpu())
    with pytest.raises(ValueError, match="16-byte"):   # q's base off by one element
        x = torch.zeros(1 + 4 * 2 * 32, device=cuda_device)[1:].view(1, 4, 2, 32)
        fa.flash_attention_partial_bwd(x, q, q, pos, pos, do, m, dl)
    with pytest.raises(ValueError, match="dl must be"):
        fa.flash_attention_partial_bwd(q, q, q, pos, pos, do, m, dl[:, :3])
    with pytest.raises(ValueError, match="head dims"):
        w = torch.zeros(1, 4, 2, 256, device=cuda_device)
        fa.flash_attention_partial_bwd(w, w, w, pos, pos, w, m, dl)
