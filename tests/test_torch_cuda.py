"""The Hopper attention kernels (the forward and the dq and dk/dv backward,
each on the tensor cores for bf16 and on the CUDA cores for fp32) against
their plain PyTorch versions, on the card; the executed activation
offload on the card (its rows in pinned host memory, its copies on a stream
of their own, the device memory it frees, offload on ≡ off through the
kernels); AdamW's moments through pinned host memory (bitwise the
on-device update), the codec's torch ops (bitwise the CPU's), the
embedding's deterministic backward; the kernels at a packed chunk (per-row
document windows, dead padding rows) and at the group sizes of glm4-9b,
nemotron-4-15b and starcoder2-3b (G = 16, 6, 12), and a packed step
equal to its pad-to-max oracle through the kernels.

Every test here needs a CUDA card: it is marked ``cuda`` and skips without
one.  The file imports no JAX, since the machine with the card has none, and
the repo's conftest imports JAX, so on that machine run it as

  PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The kernel and its plain version both compute in fp32 from the same inputs,
bf16 ones upcast exactly, so they differ only in the order of fp32 sums:
both dtypes are held to 1e-5.  The tensor-core kernels split each fp32
operand (the forward's p, the backward's dO, p and dS) into three bf16 terms
(24 bits), and are held to the same 1e-5.  bf16 inputs run both kernels of a
kind: the tensor cores (the dtype's default) and the CUDA cores (which fp32
inputs take).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import offload as ofl
from repro_torch.core import tree
from repro_torch.data.pipeline import PAD_START
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.launch.serve import build_params
from repro_torch.parallel import runner
from repro_torch.runtime import hostmem

from _torch_cases import (SWEEP, WINDOW_DEAD, inputs, sweep_case, to_np,
                          to_torch, window_case)

TOL = 1e-5  # kernel vs plain version, fp32 and bf16 inputs alike


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain version at full precision
    return torch.device("cuda")


# the counters each forward kernel moves (its launch, a split's merge)
FWD_COUNTERS = {"tensor_cores": ("fwd_tc", "merged_in_kernel"), "cuda_cores": ("fwd", "merge")}


def _kernels(dtype):
    """The kernels of a kind (forward, backward pair) that take this dtype."""
    return ("tensor_cores", "cuda_cores") if dtype == "bfloat16" else ("cuda_cores",)


def _launched(before):
    return {k: n - before[k] for k, n in fa.counts().items() if n != before[k]}


def _check_kernel(arrays, dtype, q_pos, kv_pos, device, q_start=None, kernels=None, **kw):
    """One forward call against the plain version; ``kernels`` None goes
    through ops.attention_partial (the model's dispatch)."""
    q, k, v = to_torch(arrays, dtype, device)
    qp = torch.from_numpy(q_pos).to(device)
    kp = torch.from_numpy(kv_pos).to(device)
    qs = None if q_start is None else torch.from_numpy(q_start).to(device)
    before = fa.counts()
    if kernels is None:
        got = ops.attention_partial(q, k, v, qp, kp, q_start=qs, **kw)
    else:
        got = fa.flash_attention_partial(q, k, v, qp, kp, q_start=qs, kernels=kernels, **kw)
    launch, merge = FWD_COUNTERS[kernels or _kernels(dtype)[0]]
    moved = _launched(before)
    assert moved[launch] == 1 and set(moved) <= {launch, merge}, moved
    want = ref.attention_partial_ref(q, k, v, qp, kp, q_start=qs, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(to_np(ref.normalize(got[0], got[2])),
                               to_np(ref.normalize(want[0], want[2])), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(got[1]), to_np(want[1]), rtol=TOL, atol=TOL)
    return got


# every SWEEP shape in its own dtype with each forward that takes it, and in
# bf16 on the tensor cores
FWD_SWEEP = sorted({(*case[:9], dtype, kernels) for case in SWEEP
                    for dtype in (case[9], "bfloat16") for kernels in _kernels(dtype)})


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,S,H,Hkv,hd,hv,causal,qoff,dtype,kernels", FWD_SWEEP)
def test_kernel_matches_plain(cuda_device, B, Tq, S, H, Hkv, hd, hv, causal,
                              qoff, dtype, kernels):
    arrays, q_pos, kv_pos = sweep_case(B, Tq, S, H, Hkv, hd, hv, qoff)
    _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, causal=causal, kernels=kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,S,H,Hkv,hd,hv,dtype,kernels", sorted({
    (*case, dtype, kernels) for case in [
        (2, 5, 77, 14, 2, 24, 8),        # small head dims, hd_k != hd_v
        (2, 3, 70, 14, 2, 40, 24),
        (1, 1, 2000, 14, 2, 128, 128),   # decode over 32 KV splits
        (4, 1, 2176, 28, 4, 128, 128),   # the serve path's decode step
    ] for dtype in ("float32", "bfloat16") for kernels in _kernels(dtype)}))
def test_kernel_load_paths_and_splits(cuda_device, B, Tq, S, H, Hkv, hd, hv, dtype, kernels):
    arrays = inputs(B, Tq, S, H, Hkv, hd, hv, seed=11)
    q_pos = np.arange(Tq, dtype=np.int32) + S - Tq
    kv_pos = np.arange(S, dtype=np.int32)
    before = fa.counts()
    _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)
    if Tq == 1:  # decode splits the KV range: merged in the launch, or by the merge kernel
        assert _launched(before)[FWD_COUNTERS[kernels][1]] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hv", [(8, 8), (16, 24), (24, 8), (32, 128), (128, 64)])
def test_fwd_tensor_cores_head_dims(cuda_device, hd, hv):
    """Head dims that are not whole 16-column steps are padded with zeros in
    shared memory and their stores masked; hd_k != hd_v either way round."""
    arrays = inputs(2, 21, 90, 14, 2, hd, hv, seed=hd + hv)
    q_pos = np.arange(21, dtype=np.int32) + 69
    _check_kernel(arrays, "bfloat16", q_pos, np.arange(90, dtype=np.int32), cuda_device,
                  kernels="tensor_cores")


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,S,H,Hkv", [(1152, 66000, 8, 8),   # 1032 KV tiles of 64 slots, unsplit
                                        (2100, 2200, 64, 1)])  # 1050 query tiles of 2 tokens
def test_fwd_tensor_cores_past_one_visibility_window(cuda_device, Tq, S, H, Hkv):
    """The tensor-core forward decides tile visibility 1024 KV tiles at a
    time: an unsplit call over more than that takes two windows; more than
    1024 query tiles are more blocks, launched longest first."""
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert fa._tc_geometry(1, Tq, S, H // Hkv, Hkv, n_sm)[2] == 1
    arrays = inputs(1, Tq, S, H, Hkv, 16, 16, seed=Tq)
    q_pos = np.arange(Tq, dtype=np.int32) + S - Tq
    _check_kernel(arrays, "bfloat16", q_pos, np.arange(S, dtype=np.int32), cuda_device,
                  kernels="tensor_cores")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernels", [(d, k) for d in ("float32", "bfloat16")
                                           for k in _kernels(d)])
def test_kernel_window_and_dead_rows_exact(cuda_device, dtype, kernels):
    arrays, q_pos, kv_pos, q_start = window_case()
    o, m, l = _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device,
                            q_start=q_start, kernels=kernels)
    dead = torch.from_numpy(WINDOW_DEAD).to(cuda_device)
    assert (o[dead] == 0).all() and (l[dead] == 0).all()
    assert (m[dead] == -1e30).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernels", _kernels("bfloat16"))
def test_split_decode_keeps_dead_rows_exact(cuda_device, kernels):
    """Two decode-like tokens per batch row over the serve path's cache,
    split over the KV range: batch row 0's second token and all of batch row
    1 see nothing (q_start = PAD), so one split group holds live and dead
    rows and another only dead ones; the merge keeps them exact."""
    PAD = 2**30
    B, Tq, S, H, Hkv, hd = 2, 2, 2176, 28, 4, 128
    arrays = inputs(B, Tq, S, H, Hkv, hd, hd, seed=21)
    q_pos = np.full((B, Tq), 2048, np.int32)
    q_start = np.array([[0, PAD], [PAD, PAD]], np.int32)
    kv_pos = np.where(np.arange(S) <= 2048, np.arange(S), PAD).astype(np.int32)
    before = fa.counts()
    o, m, l = _check_kernel(arrays, "bfloat16", q_pos, kv_pos, cuda_device,
                            q_start=q_start, kernels=kernels)
    assert _launched(before)[FWD_COUNTERS[kernels][1]] == 1
    dead = torch.from_numpy(q_start == PAD).to(cuda_device)
    assert (o[dead] == 0).all() and (l[dead] == 0).all() and (m[dead] == -1e30).all()
    assert (l[~dead] > 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernels", _kernels("bfloat16"))
def test_kernel_takes_strided_cache_view(cuda_device, kernels):
    """A prefix view of a cache buffer (batch stride = buffer length) needs
    no copy: the kernel takes the strides; q is a head slice of the fused
    q|k projection, as the training path passes it."""
    B, Tq, S_buf, S, H, Hkv, hd = 2, 24, 96, 70, 14, 2, 128
    q, k_buf, v_buf = to_torch(inputs(B, Tq, S_buf, H + Hkv, Hkv, hd, hd, seed=9),
                               "bfloat16", cuda_device)
    q, k, v = q[:, :, :H], k_buf[:, :S], v_buf[:, :S]
    assert not k.is_contiguous() and not q.is_contiguous()
    q_pos = torch.arange(Tq, dtype=torch.int32, device=cuda_device) + S - Tq
    kv_pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    o1, m1, l1 = fa.flash_attention_partial(q, k, v, q_pos, kv_pos, kernels=kernels)
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


@pytest.mark.cuda
def test_tensor_core_fwd_refuses_what_it_does_not_take(cuda_device):
    """The tensor-core forward takes bf16 only: fp32 asked of it raises (fp32
    runs on the CUDA cores), as do an unaligned q (the CUDA-core forward
    takes one), more query heads per KV head than a block holds and an
    unknown kernel; nothing is launched, and nothing falls back."""
    pos = torch.arange(4, dtype=torch.int32, device=cuda_device)
    q = torch.zeros(1, 4, 2, 32, device=cuda_device)
    b = q.bfloat16()
    before = fa.counts()
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_partial(q, q, q, pos, pos, kernels="tensor_cores")
    with pytest.raises(ValueError, match="kernels must be"):
        fa.flash_attention_partial(b, b, b, pos, pos, kernels="wgmma")
    with pytest.raises(ValueError, match="16-byte"):   # q's base off by one element
        x = torch.zeros(1 + 4 * 2 * 32, device=cuda_device, dtype=torch.bfloat16)[1:].view(1, 4, 2, 32)
        fa.flash_attention_partial(x, b, b, pos, pos)
    with pytest.raises(ValueError, match="G <="):      # 72 heads on one KV head
        w = torch.zeros(1, 4, 72, 32, device=cuda_device, dtype=torch.bfloat16)
        fa.flash_attention_partial(w, b[:, :, :1], b[:, :, :1], pos, pos)
    assert fa.counts() == before


# ---------------------------------------------------------------------------
# The backward kernels (dq, dk/dv) against attention_partial_bwd_ref.  Both
# sides compute in fp32 from the same inputs; each gradient is held to
# 1e-5 x max |plain gradient| (its sums run over up to S or G x Tq terms).
# bf16 inputs run both pairs: the tensor-core kernels (the dtype's default)
# and the CUDA-core ones (which fp32 inputs take).
# ---------------------------------------------------------------------------

PAIR_COUNTERS = {"tensor_cores": ("bwd_dq_tc", "bwd_dkv_tc"), "cuda_cores": ("bwd_dq", "bwd_dkv")}


def _check_bwd(arrays, dtype, q_pos, kv_pos, device, q_start=None, causal=True,
               dead=None, seed=3, kernels=None):
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
    before = fa.counts()
    got = fa.flash_attention_partial_bwd(q, k, v, qp, kp, do, m, dl, causal=causal,
                                         q_start=qs, kernels=kernels)
    pair = kernels or ("tensor_cores" if dtype == "bfloat16" else "cuda_cores")
    assert _launched(before) == {key: 1 for key in PAIR_COUNTERS[pair]}
    want = ref.attention_partial_bwd_ref(q, k, v, qp, kp, qs, do, m, dl, causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        assert err <= TOL * max(1.0, b.abs().max().item()), f"{name}: err {err}"
    return got


# every SWEEP shape in its own dtype with each pair that takes it, and in
# bf16 on the tensor cores
BWD_SWEEP = sorted({(*case[:9], dtype, pair) for case in SWEEP
                    for dtype in (case[9], "bfloat16") for pair in _kernels(dtype)})


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,S,H,Hkv,hd,hv,causal,qoff,dtype,kernels", BWD_SWEEP)
def test_bwd_kernels_match_plain(cuda_device, B, Tq, S, H, Hkv, hd, hv, causal,
                                 qoff, dtype, kernels):
    arrays, q_pos, kv_pos = sweep_case(B, Tq, S, H, Hkv, hd, hv, qoff)
    _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, causal=causal, kernels=kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4, 7, 8])
@pytest.mark.parametrize("dtype,kernels", [(d, k) for d in ("float32", "bfloat16")
                                           for k in _kernels(d)])
def test_bwd_kernels_group_sizes_and_ragged(cuda_device, G, dtype, kernels):
    """G query heads per KV head folded into the rows (G = 7: no power of
    two), ragged Tq and S over several tiles, hd_k != hd_v, PAD slots."""
    Hkv = 2 if G < 8 else 1
    arrays = inputs(2, 37, 150, G * Hkv, Hkv, 64, 32, seed=G)
    q_pos = np.arange(37, dtype=np.int32) + 113
    kv_pos = np.arange(150, dtype=np.int32)
    kv_pos[-6:] = 2**30
    _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hv", [(8, 8), (16, 24), (24, 8), (32, 128), (128, 64)])
def test_bwd_tensor_cores_head_dims(cuda_device, hd, hv):
    """Head dims that are not whole 16-column steps are padded with zeros in
    shared memory and their stores masked; hd_k != hd_v either way round."""
    arrays = inputs(2, 21, 90, 14, 2, hd, hv, seed=hd + hv)
    q_pos = np.arange(21, dtype=np.int32) + 69
    _check_bwd(arrays, "bfloat16", q_pos, np.arange(90, dtype=np.int32), cuda_device,
               kernels="tensor_cores")


@pytest.mark.cuda
@pytest.mark.parametrize("Tq,S,G", [(4700, 4760, 7),    # 1029 query tiles of 32 rows
                                    (8, 66000, 4)])     # 1032 KV tiles of 64 slots
def test_bwd_tensor_cores_past_one_visibility_window(cuda_device, Tq, S, G):
    """The tensor-core kernels decide tile visibility 1024 tiles at a time:
    more query tiles (dk/dv) or KV tiles (dq) than that take two windows."""
    arrays = inputs(1, Tq, S, G, 1, 32, 16, seed=Tq)
    q_pos = np.arange(Tq, dtype=np.int32) + S - Tq
    _check_bwd(arrays, "bfloat16", q_pos, np.arange(S, dtype=np.int32), cuda_device,
               kernels="tensor_cores")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernels", [(d, k) for d in ("float32", "bfloat16")
                                           for k in _kernels(d)])
def test_bwd_kernels_window_and_dead_rows_exact(cuda_device, dtype, kernels):
    arrays, q_pos, kv_pos, q_start = window_case()
    dead = torch.from_numpy(WINDOW_DEAD).to(cuda_device)
    dq, dk, dv = _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device,
                            q_start=q_start, dead=dead, kernels=kernels)
    assert (dq[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernels", _kernels("bfloat16"))
def test_bwd_kernels_take_strided_cache_view(cuda_device, kernels):
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
    got = fa.flash_attention_partial_bwd(q, k, v, q_pos, kv_pos, do, m, dl, kernels=kernels)
    want = ref.attention_partial_bwd_ref(q, k.contiguous(), v.contiguous(), q_pos,
                                         kv_pos, None, do, m, dl)
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= TOL * max(1.0, b.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernels", [(d, k) for d in ("float32", "bfloat16")
                                           for k in _kernels(d)])
def test_bwd_kernels_take_unaligned_do(cuda_device, dtype, kernels):
    """A contiguous fp32 do whose base is not 16-byte aligned (a view one
    element into its buffer) gives the same gradients as an aligned copy."""
    B, Tq, S, H, Hkv, hd = 1, 12, 40, 14, 2, 64
    q, k, v = to_torch(inputs(B, Tq, S, H, Hkv, hd, hd, seed=5), dtype, cuda_device)
    pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    buf = torch.randn(1 + B * Tq * H * hd, device=cuda_device)
    do = buf[1:].view(B, Tq, H, hd)
    assert do.is_contiguous() and do.data_ptr() % 16
    dl = torch.randn(B, Tq, H, device=cuda_device)
    _, m, _ = ref.attention_partial_ref(q, k, v, pos[S - Tq:], pos)
    got = fa.flash_attention_partial_bwd(q, k, v, pos[S - Tq:], pos, do, m, dl, kernels=kernels)
    want = fa.flash_attention_partial_bwd(q, k, v, pos[S - Tq:], pos, do.clone(), m, dl,
                                          kernels=kernels)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_partial_function_runs_the_kernels(cuda_device, dtype):
    """ops.attention_partial on CUDA tensors: forward and backward are the
    kernels (one launch each; bf16 moves only the tensor-core kernels'
    counters, fp32 only the CUDA-core ones), and the grads equal the
    kernels' own."""
    arrays, q_pos, kv_pos = sweep_case(*SWEEP[3][:7], SWEEP[3][8])
    q, k, v = [t.requires_grad_() for t in to_torch(arrays, dtype, cuda_device)]
    qp, kp = torch.from_numpy(q_pos).to(cuda_device), torch.from_numpy(kv_pos).to(cuda_device)
    before = fa.counts()
    o, m, l = ops.attention_partial(q, k, v, qp, kp)
    do, dl = torch.randn_like(o), torch.randn_like(l)
    grads = torch.autograd.grad((o, l), (q, k, v), (do, dl))
    kind = "tensor_cores" if dtype == "bfloat16" else "cuda_cores"
    assert _launched(before) == {FWD_COUNTERS[kind][0]: 1,
                                 **{key: 1 for key in PAIR_COUNTERS[kind]}}
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


@pytest.mark.cuda
def test_tensor_core_bwd_refuses_what_it_does_not_take(cuda_device):
    """The tensor-core pair takes bf16 only: fp32 asked of it raises (fp32
    runs on the CUDA cores), as do head dims over 128, misaligned views and
    an unknown pair; nothing is launched."""
    pos = torch.arange(4, dtype=torch.int32, device=cuda_device)
    m, dl = torch.zeros(1, 4, 2, device=cuda_device), torch.zeros(1, 4, 2, device=cuda_device)
    q = torch.zeros(1, 4, 2, 32, device=cuda_device)
    before = fa.counts()
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_partial_bwd(q, q, q, pos, pos, q, m, dl, kernels="tensor_cores")
    with pytest.raises(ValueError, match="kernels must be"):
        fa.flash_attention_partial_bwd(q.bfloat16(), q.bfloat16(), q.bfloat16(), pos, pos, q,
                                       m, dl, kernels="wgmma")
    with pytest.raises(ValueError, match="head dims"):
        w = torch.zeros(1, 4, 2, 256, device=cuda_device, dtype=torch.bfloat16)
        fa.flash_attention_partial_bwd(w, w, w, pos, pos, w.float(), m, dl)
    with pytest.raises(ValueError, match="16-byte"):   # q's base off by one element
        x = torch.zeros(1 + 4 * 2 * 32, device=cuda_device, dtype=torch.bfloat16)[1:].view(1, 4, 2, 32)
        fa.flash_attention_partial_bwd(x, q.bfloat16(), q.bfloat16(), pos, pos, q, m, dl)
    assert fa.counts() == before


# ---------------------------------------------------------------------------
# the executed activation offload on the card
# ---------------------------------------------------------------------------

OFFLOAD_ALPHAS = (1.0, 0.7, 0.5, 0.0)


def _offload_cell(seq=512, batch=2, alphas=OFFLOAD_ALPHAS, dtype=torch.float32, **ov):
    cell = runner.resolve_cell(get_config("qwen2-7b").reduced(),
                               ShapeConfig("t", seq, batch, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=4, grad_accum=1,
                                              partition="length", **ov), dtype=dtype)
    return cell if alphas is None else dataclasses.replace(cell, alphas=tuple(alphas))


def _offload_batch(cell, device):
    gen = torch.Generator(device=device).manual_seed(3)
    tokens = torch.randint(0, cell.cfg.vocab_size, (cell.shape.global_batch,
                                                    cell.shape.seq_len),
                           generator=gen, device=device)
    return tokens, torch.roll(tokens, -1, dims=1)


@pytest.mark.cuda
@pytest.mark.parametrize("prefetch", ["ahead", "sync"])
def test_offload_on_equals_off_through_the_kernels(cuda_device, prefetch):
    """fp32 through the CUDA-core kernels: offload on at OFFLOAD_ALPHAS
    (remat "sppo", the replay re-running the kernels) gives remat "none"'s
    loss and every gradient within 1e-5, and moves the closed form's bytes
    each way."""
    off = _offload_cell(alphas=None, offload=False, remat="none")
    on = _offload_cell(offload=True, prefetch=prefetch)
    params = build_params(off, cuda_device, seed=0)
    tokens, labels = _offload_batch(off, cuda_device)
    l0, g0 = runner.loss_and_grads(off, params, tokens, labels)
    hostmem.reset_counts()
    before = fa.counts()
    l1, g1 = runner.loss_and_grads(on, params, tokens, labels)
    torch.cuda.synchronize()
    moved = _launched(before)
    # forward, its replay: two forward launches per layer and chunk
    assert moved["fwd"] == 2 * 2 * 4 and moved["bwd_dq"] == moved["bwd_dkv"] == 2 * 4
    np.testing.assert_allclose(float(l1), float(l0), rtol=0, atol=TOL)
    for (path, a), b in zip(tree.items(g1), tree.leaves(g0)):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=TOL, err_msg=path)
    elems = cm.tagged_bytes_per_token(on.cfg) // cm.ACT_ITEMSIZE
    want = sum(ofl.split_rows(ln, a) * 2 * elems * 4 * 2
               for ln, a in zip(on.sched.lengths, on.alphas))
    counts = hostmem.counts()
    assert counts["d2h_bytes"] == counts["h2d_bytes"] == want
    assert counts["d2h_pinned"] == counts["d2h"] > 0


def _forward(cell, params, tokens, labels):
    """One training forward (the graph kept, no backward); returns the
    run_pipeline dict."""
    with torch.enable_grad():
        leaves = tree.map_(lambda t: t.detach().requires_grad_(t.is_floating_point()
                                                               and t.dim() > 0), params)
        return runner.run_pipeline(cell, leaves["stages"], leaves["globals"], tokens,
                                   labels, with_loss=True)


@pytest.mark.cuda
def test_offloaded_rows_live_in_pinned_host_memory(cuda_device):
    cell = _offload_cell(dtype=torch.bfloat16, offload=True)
    params = build_params(cell, cuda_device, seed=0)
    out = _forward(cell, params, *_offload_batch(cell, cuda_device))
    rows = [s for staged in out["link"].host.values() for s in staged]
    assert len(rows) == 5 * 2 * 3                 # 5 tag sites, 2 layers, 3 chunks offload
    for s in rows:
        s.event.synchronize()
        assert s.tensor.device.type == "cpu" and s.tensor.is_pinned()
        assert s.device.type == "cuda"


@pytest.mark.cuda
def test_copies_run_on_a_stream_of_their_own(cuda_device):
    """A D2H issued before the compute stream is held busy completes while
    it still is: the copy ran on another stream."""
    t = torch.randn(8 << 20, device=cuda_device)
    torch.cuda.synchronize()
    staged = hostmem.to_host(t, 0)
    torch.cuda._sleep(2_000_000_000)            # ~1 s on the compute stream
    staged.event.synchronize()
    assert not torch.cuda.current_stream().query()
    assert hostmem.copy_stream(cuda_device) != torch.cuda.current_stream()
    torch.cuda.synchronize()
    assert torch.equal(staged.tensor, t.cpu())
    back = hostmem.to_device(staged, 0)
    assert torch.equal(hostmem.wait(back), t)


@pytest.mark.cuda
def test_offload_frees_the_device_memory_it_moves(cuda_device):
    """After the forward, α = 1 on every chunk holds less device memory than
    α = 0 by at least 90 % of the bytes it sent to host."""
    held, sent = {}, {}
    for alpha in (0.0, 1.0):
        cell = _offload_cell(seq=2048, alphas=(alpha,) * 4, dtype=torch.bfloat16,
                             offload=True)
        params = build_params(cell, cuda_device, seed=0)
        batch = _offload_batch(cell, cuda_device)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda_device)
        hostmem.reset_counts()
        out = _forward(cell, params, *batch)
        torch.cuda.synchronize()
        torch.empty(1, device=cuda_device)      # the allocator settles freed copy sources
        held[alpha] = torch.cuda.memory_allocated(cuda_device) - base
        sent[alpha] = hostmem.counts()["d2h_bytes"]
        del out
    assert sent[0.0] == 0 and sent[1.0] > 0
    assert held[0.0] - held[1.0] >= 0.9 * sent[1.0], (held, sent)


# ---------------------------------------------------------------------------
# AdamW's moments in pinned host memory, the codec, the embedding's backward
# ---------------------------------------------------------------------------


def _moment_case(device):
    gen = torch.Generator(device="cpu").manual_seed(11)
    shapes = {"w": (96, 640), "o": (640, 96), "b": (640,), "s": ()}
    params = {k: torch.randn(s, generator=gen).to(device) for k, s in shapes.items()}
    grads = [{k: (3.0 * torch.randn(s, generator=gen)).to(device) for k, s in shapes.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.cuda
def test_moment_round_trip_through_pinned_memory_is_bitwise(cuda_device):
    """Three updates with the moments in pinned host memory equal three with
    them on the device bitwise (parameters, m and v); every host moment is
    pinned, every D2H lands in a pinned buffer, and the copies move the
    closed form's bytes each way.  Under a codec the host pairs are pinned
    too."""
    from repro_torch.optim import adamw

    params, grads = _moment_case(cuda_device)
    p_on = {k: v.clone() for k, v in params.items()}
    p_off = {k: v.clone() for k, v in params.items()}
    s_on = adamw.init_state(p_on, offload_moments=True)
    s_off = adamw.init_state(p_off)
    hostmem.reset_counts()
    for g in grads:
        p_on, s_on, _ = adamw.apply_update(p_on, g, s_on, lr=1e-2, offload_moments=True)
        p_off, s_off, _ = adamw.apply_update(p_off, g, s_off, lr=1e-2)
    torch.cuda.synchronize()
    for k in params:
        assert torch.equal(p_on[k], p_off[k])
        assert s_on.m[k].device.type == "cpu" and s_on.m[k].is_pinned()
        assert torch.equal(s_on.m[k], s_off.m[k].cpu()) and torch.equal(s_on.v[k], s_off.v[k].cpu())
    c = hostmem.counts()
    want = 3 * cm.opt_state_bytes(sum(t.numel() for t in params.values()))
    assert c["moment_h2d_bytes"] == c["moment_d2h_bytes"] == want
    assert c["moment_d2h_pinned"] == c["moment_d2h"] == 3 * 2 * len(params)
    for codec in ("fp8", "int8"):
        state = adamw.init_state(p_on, offload_moments=True, moments_dtype=codec)
        adamw.apply_update(p_on, grads[0], state, lr=1e-2, offload_moments=True,
                           moments_dtype=codec)
        torch.cuda.synchronize()
        assert all(t.is_pinned() for t in tree.leaves([state.m, state.v]))


@pytest.mark.cuda
def test_codec_on_the_card_matches_the_cpu_bitwise(cuda_device):
    """The codec's torch ops on the card give the CPU's payload, scale and
    reconstruction bit for bit, fp32 and bf16, subnormal scales included."""
    gen = torch.Generator(device="cpu").manual_seed(5)
    decades = 10.0 ** torch.arange(-3, 3).repeat_interleave(4)[:, None]
    cases = [torch.randn(24, 64, generator=gen) * decades,
             torch.randn(2, 7, 4, 16, generator=gen),
             torch.full((3, 16), float(np.finfo(np.float32).tiny)),
             torch.zeros(2, 8), torch.tensor(-2.5)]
    for codec in ("fp8", "int8"):
        for x in cases:
            for dtype in (torch.float32, torch.bfloat16):
                xc = x.to(dtype)
                p, s = hostmem.quantize(xc, codec)
                pd, sd = hostmem.quantize(xc.to(cuda_device), codec)
                assert torch.equal(pd.cpu().view(torch.int8), p.view(torch.int8))
                assert torch.equal(sd.cpu(), s)
                assert torch.equal(hostmem.dequantize(pd, sd, codec, dtype).cpu(),
                                   hostmem.dequantize(p, s, codec, dtype))


@pytest.mark.cuda
def test_embedding_backward_is_deterministic(cuda_device):
    """Two calls on the same ids (Zipfian, so ids repeat) give bitwise the
    same table gradient; ids outside the table give zero rows and add
    nothing to the row they are clamped to."""
    from repro_torch.models import layers as L

    V, d, T = 4096, 256, 8192
    rng = np.random.default_rng(0)
    ids = np.minimum(rng.zipf(1.2, size=(2, T)), V - 2).astype(np.int32)
    ids[0, :7] = [-1, V, V + 5, -3, V + 100, -1, V]
    ids = torch.from_numpy(ids).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.randn(V, d, device=cuda_device, generator=gen).to(torch.bfloat16)
    gout = torch.randn(2, T, d, device=cuda_device, generator=gen).to(torch.bfloat16)

    def grad():
        t = table.detach().requires_grad_()
        out = L.embed_tokens(ids, t)
        assert (out[0, :7] == 0).all()
        return torch.autograd.grad(out, t, gout)[0]

    first = grad()
    assert all(torch.equal(first, grad()) for _ in range(4))
    assert (first[V - 1] == 0).all()           # only masked ids clamp to it
    assert (first[ids[0, 7:].long()] != 0).any()


# ---------------------------------------------------------------------------
# packed variable-length batches (DESIGN.md §13) and the configs' group sizes
# ---------------------------------------------------------------------------


def _packed_chunk(seed=7):
    """A packed chunk: 3 rows of 512 tokens from a seeded Zipf corpus, the
    last chunk of 4 (Tq = 128 over a 512-slot view) with its [3, Tq]
    doc_start window; the padding tail's queries are dead."""
    from repro_torch.data import pipeline as dpipe

    docs = dpipe.sample_corpus(24, vocab_size=256, seed=seed, dist="zipf", mean_len=64,
                               max_len=400)
    pb = dpipe.pack_documents(docs, 512)
    assert pb.tokens.shape[0] == 3
    B, Tq, S = 3, 128, 512
    q_start = np.ascontiguousarray(pb.doc_start[:, S - Tq:])
    return (inputs(B, Tq, S, 28, 4, 128, 128, seed=seed), np.arange(S - Tq, S, dtype=np.int32),
            np.arange(S, dtype=np.int32), q_start)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernels", [(d, k) for d in ("float32", "bfloat16")
                                           for k in _kernels(d)])
def test_kernels_at_a_packed_chunk(cuda_device, dtype, kernels):
    """The forward and the backward pair at a packed chunk's shape (3 rows,
    G = 7, hd 128, per-row document windows), dead padding rows exact."""
    arrays, q_pos, kv_pos, q_start = _packed_chunk()
    dead_np = q_start == PAD_START
    assert dead_np.any()
    dead = torch.from_numpy(dead_np).to(cuda_device)
    o, m, l = _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, q_start=q_start,
                            kernels=kernels)
    assert (o[dead] == 0).all() and (l[dead] == 0).all() and (m[dead] == -1e30).all()
    dq, _, _ = _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, q_start=q_start,
                          dead=dead, kernels=kernels)
    assert (dq[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("G,Hkv", [(16, 2), (6, 8), (12, 2)])   # glm4, nemotron, starcoder2
@pytest.mark.parametrize("dtype,kernels", [(d, k) for d in ("float32", "bfloat16")
                                           for k in _kernels(d)])
def test_kernels_at_the_configs_group_sizes(cuda_device, G, Hkv, dtype, kernels):
    """G = 16, 6, 12 with hd 128, ragged Tq and S over several tiles, PAD
    slots: forward and backward against the plain versions."""
    Tq, S = 203, 461
    arrays = inputs(2, Tq, S, G * Hkv, Hkv, 128, 128, seed=G)
    q_pos = np.arange(Tq, dtype=np.int32) + S - Tq - 5
    kv_pos = np.arange(S, dtype=np.int32)
    kv_pos[-5:] = 2**30
    _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)
    _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)


@pytest.mark.cuda
def test_packed_step_equals_pad_to_max_through_the_kernels(cuda_device):
    """fp32 through the CUDA-core kernels, the default plan (chunk 0
    offloading every row): packed rows and the pad-to-max oracle (one
    document a row at its packed offsets) give the same loss and gradients
    within 1e-5; every launch takes the document windows."""
    from repro_torch.data import pipeline as dpipe

    cfg = get_config("qwen2-7b").reduced()
    docs = dpipe.sample_corpus(10, vocab_size=cfg.vocab_size, seed=3, dist="zipf", mean_len=48,
                               max_len=200)
    packed = dpipe.pack_documents(docs, 256)
    oracle = dpipe.pad_to_max(docs, 256, at_packed_offsets=packed)
    lens = [len(d) for d in docs]
    out = []
    for pb in (packed, oracle):
        cell = runner.resolve_cell(cfg, ShapeConfig("t", 256, len(pb.tokens), "train"),
                                   overrides=dict(pp=1, dp=1, n_chunks=2), dtype=torch.float32,
                                   doc_lens=lens)
        cell = dataclasses.replace(cell, alphas=(1.0, 0.0))
        params = build_params(cell, cuda_device, seed=0)
        before = fa.counts()
        out.append(runner.loss_and_grads(cell, params, *(torch.from_numpy(a).to(cuda_device)
                                                         for a in (pb.tokens, pb.labels,
                                                                   pb.doc_start))))
        moved = _launched(before)
        assert moved["fwd"] == 2 * 2 * 2 and moved["bwd_dq"] == moved["bwd_dkv"] == 2 * 2
    (lp, gp), (lo, go) = out
    np.testing.assert_allclose(float(lp), float(lo), rtol=0, atol=TOL)
    for (path, a), b in zip(tree.items(gp), tree.leaves(go)):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=TOL, err_msg=path)
