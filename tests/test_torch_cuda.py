"""The Hopper attention kernel against its plain PyTorch version, on the card.

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
