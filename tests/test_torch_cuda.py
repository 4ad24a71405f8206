"""The Hopper attention kernels (the forward and the dq and dk/dv backward,
each on the tensor cores for bf16 and on the CUDA cores for fp32) against
their plain PyTorch versions, on the card; the executed activation
offload on the card (its rows in pinned host memory, its copies on a stream
of their own, the device memory it frees, offload on ≡ off through the
kernels); AdamW's moments through pinned host memory (bitwise the
on-device update), the codec's torch ops (bitwise the CPU's), the
embedding's deterministic backward; the kernels at a packed chunk (per-row
document windows, dead padding rows) and at the group sizes of glm4-9b,
nemotron-4-15b and starcoder2-3b (G = 16, 6, 12), a packed step equal
to its pad-to-max oracle through the kernels, and the pipeline at pp = 2 as
two ranks sharing the card over gloo against pp = 1; the paged serving
step's kernel call (per-row positions over gathered slots) and its writes
(the striped slot or the sink, nothing else); the kernels at
granite-moe-1b-a400m's heads (hd 64, G = 2, its decode step) and its
expert block on the card against the CPU; the wide tensor-core kernels at
deepseek-v3's MLA widths (hd_k 576, hd_v 512, G = 128, v a view of the
latent k) and the CUDA-core pair's refusal of them; the narrow kernels at
zamba2-7b's shared attention block (hd 112, G = 1) and the reduced rwkv6-3b and
zamba2-7b steps on the card against the CPU; the narrow kernels non-causal at
llama-3.2-vision-11b's cross layer and whisper-tiny's encoder and cross
layer, and both reduced models' steps on the card against the CPU.

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

from _torch_cases import (SWEEP, WINDOW_DEAD, inputs, set_cross_gates, sweep_case,
                          to_np, to_torch, window_case)

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
    with pytest.raises(ValueError, match="G <="):      # 136 heads on one KV head
        w = torch.zeros(1, 4, 136, 32, device=cuda_device, dtype=torch.bfloat16)
        fa.flash_attention_partial(w, b[:, :, :1], b[:, :, :1], pos, pos)
    with pytest.raises(ValueError, match="hd_k <= 576"):   # past the wide kernels' head dim
        w = torch.zeros(1, 4, 2, 640, device=cuda_device, dtype=torch.bfloat16)
        fa.flash_attention_partial(w, w, w, pos, pos)
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
    runs on the CUDA cores), as do head dims over the wide kernels' 576 /
    512, misaligned views and an unknown pair; nothing is launched."""
    pos = torch.arange(4, dtype=torch.int32, device=cuda_device)
    m, dl = torch.zeros(1, 4, 2, device=cuda_device), torch.zeros(1, 4, 2, device=cuda_device)
    q = torch.zeros(1, 4, 2, 32, device=cuda_device)
    before = fa.counts()
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_attention_partial_bwd(q, q, q, pos, pos, q, m, dl, kernels="tensor_cores")
    with pytest.raises(ValueError, match="kernels must be"):
        fa.flash_attention_partial_bwd(q.bfloat16(), q.bfloat16(), q.bfloat16(), pos, pos, q,
                                       m, dl, kernels="wgmma")
    with pytest.raises(ValueError, match="hd_k <= 576"):
        w = torch.zeros(1, 4, 2, 640, device=cuda_device, dtype=torch.bfloat16)
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


@pytest.mark.cuda
def test_pipeline_pp2_on_one_card_over_gloo_equals_pp1(cuda_device):
    """pp = 2 as two ranks (processes) sharing the card over gloo, their
    hand-offs and reductions staged through pinned host memory, fp32 reduced
    qwen2-7b under the default plan: each rank's loss and every gradient of
    its stage and the globals within 1e-4 relative L2 of pp = 1's on the
    card (the CUDA-core kernels either way; equal chunks).  The ranks run
    tests/_torch_pipeline_workers.py."""
    import _torch_pipeline_workers as W
    from repro_torch.launch import mesh
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("qwen2-7b").reduced()
    S, B, N = 512, 2, 4
    gen = torch.Generator().manual_seed(0)
    mdef = build_model(cfg)
    params = {"stages": mdef.init_stage_params(gen, torch.float32, "cpu"),
              "globals": mdef.init_globals(gen, torch.float32, "cpu")}

    def stack(slots):
        if isinstance(slots[0], dict):
            return {k: stack([s[k] for s in slots]) for k in slots[0]}
        return np.stack([s.numpy() for s in slots]).astype(np.float32)

    params_np = {"stages": stack(params["stages"]),
                 "globals": tree.map_(lambda t: t.numpy(), params["globals"])}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    cell = runner.resolve_cell(cfg, ShapeConfig("t", S, B, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=N, partition="length",
                                              grad_accum=1), dtype=torch.float32)
    on_card = tree.map_(lambda t: t.cuda(), params)
    loss1, grads1 = runner.loss_and_grads(cell, on_card, torch.from_numpy(tokens).cuda(),
                                          torch.from_numpy(labels).cuda())
    want = {path: g.cpu() for path, g in tree.items(grads1)}
    layout = dict(dp=1, pp=2, n_chunks=N, S=S, B=B)
    ranks = mesh.spawn(W.pipeline_rank, 2, backend="gloo", device="cuda",
                       args=([("pp2", layout, {"grads"})], params_np, tokens, labels),
                       timeout_s=300.0)
    for r in (x["pp2"] for x in ranks):
        assert abs(r["loss"] - float(loss1)) <= 1e-4 * abs(float(loss1))
        for path, g in tree.items(r["grads"]):
            if path.startswith("stages/"):
                i, rest = path.split("/", 2)[1:]
                path = f"stages/{r['stage'] + int(i)}/{rest}"
            ref_g = want[path].numpy()
            norm = np.linalg.norm(ref_g)
            if norm == 0:
                assert not np.any(g), path
                continue
            assert np.linalg.norm(g - ref_g) / norm <= 1e-4, (r["rank"], path)


# the model axis's shapes (sp = 2): chunks of (256, 192, 128) rows, the
# last and the first chunk, each rank
MODEL_AXIS = sorted({(mode, c, r, dtype, kernels) for mode in ("gather_q", "gather_kv")
                     for c in (0, 2) for r in (0, 1) for dtype in ("float32", "bfloat16")
                     for kernels in _kernels(dtype)})


@pytest.mark.cuda
@pytest.mark.parametrize("mode,c,rank,dtype,kernels", MODEL_AXIS)
def test_kernels_at_the_model_axis_shapes(cuda_device, mode, c, rank, dtype, kernels):
    """The forward and the backward pair at sp = 2's shapes: gather_q, the
    chunk's queries over one rank's gapped cache shard (at chunk 0 on rank
    1 the first half of the queries sees no slot: dead rows, exact);
    gather_kv, one rank's queries over both shards concatenated, positions
    that do not ascend.  Forward within 1e-5, backward within 1e-5 x max
    |plain|."""
    from _torch_cases import model_axis_case

    arrays, q_pos, kv_pos = model_axis_case(mode, 2, (256, 192, 128), c, 2, rank, 8, 2, 64)
    o, m, l = _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)
    dead = torch.from_numpy(q_pos[:, None] < kv_pos[None, :]).all(1).to(cuda_device)
    if mode == "gather_q" and c == 0 and rank == 1:
        assert int(dead.sum()) == 128
    assert bool((o[:, dead] == 0).all() and (l[:, dead] == 0).all()
                and (m[:, dead] == -1e30).all())
    _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)


# the ring's hop shapes (sp = 2): each rank's queries of the first and the
# last chunk over each rank's shard
RING_HOPS = sorted({(c, r, kv, dtype, kernels) for c in (0, 2) for r in (0, 1) for kv in (0, 1)
                    for dtype in ("float32", "bfloat16") for kernels in _kernels(dtype)})


@pytest.mark.cuda
@pytest.mark.parametrize("c,rank,kv_rank,dtype,kernels", RING_HOPS)
def test_kernels_at_the_ring_hop_shapes(cuda_device, c, rank, kv_rank, dtype, kernels):
    """The forward and the backward pair at the ring's hops: a rank's
    queries over the gapped shard that started on ``kv_rank``.  The first
    chunk's hop of rank 0 over rank 1's block lies wholly in the queries'
    future: every row comes out exactly dead (o = l = 0, m = -1e30) and
    its NaN cotangents give zero gradients.  Forward within 1e-5, backward
    within 1e-5 x max |plain|."""
    from _torch_cases import model_axis_case

    arrays, q_pos, kv_pos = model_axis_case("ring", 2, (256, 192, 128), c, 2, rank, 8, 2, 64,
                                            kv_rank=kv_rank)
    o, m, l = _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)
    dead = torch.from_numpy(q_pos[:, None] < kv_pos[None, :]).all(1).to(cuda_device)
    if (c, rank, kv_rank) == (0, 0, 1):
        assert bool(dead.all())
    assert bool((o[:, dead] == 0).all() and (l[:, dead] == 0).all()
                and (m[:, dead] == -1e30).all())
    got = _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels,
                     dead=dead[None].expand(2, -1) if bool(dead.any()) else None)
    if bool(dead.all()):
        assert all(bool((g == 0).all()) for g in got)


def _sp2_step_over_gloo_equals_cpu(plan):
    """sp = 2 as two ranks (processes) sharing the card over gloo under
    the plan overrides ``plan`` (the default plan's otherwise), fp32
    reduced qwen2-7b: each rank's loss, and every gradient leaf gathered
    over the ranks, within 1e-4 relative L2 of the CPU's sp = 1 step.  The
    ranks run tests/_torch_model_axis_workers.py."""
    import _torch_model_axis_workers as W
    from repro_torch.launch import mesh
    from repro_torch.models.convert import gather_model_shards
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("qwen2-7b").reduced()
    S, B = 256, 2
    gen = torch.Generator().manual_seed(0)
    mdef = build_model(cfg)
    params = {"stages": mdef.init_stage_params(gen, torch.float32, "cpu"),
              "globals": mdef.init_globals(gen, torch.float32, "cpu")}

    def stack(slots):
        if isinstance(slots[0], dict):
            return {k: stack([s[k] for s in slots]) for k in slots[0]}
        return np.stack([s.numpy() for s in slots]).astype(np.float32)

    params_np = {"stages": stack(params["stages"]),
                 "globals": tree.map_(lambda t: t.numpy(), params["globals"])}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    cell = runner.resolve_cell(cfg, ShapeConfig("t", S, B, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=2, grad_accum=1),
                               dtype=torch.float32)
    loss1, grads1 = runner.loss_and_grads(cell, params, torch.from_numpy(tokens),
                                          torch.from_numpy(labels))
    want = {path: g.numpy() for path, g in tree.items(grads1)}
    job = dict(name="sp2", arch="qwen2-7b", layout=dict(sp=2, n_chunks=2, plan=plan),
               params=params_np, tokens=tokens, labels=labels)
    ranks = [r["sp2"] for r in mesh.spawn(W.layout_rank, 2, backend="gloo", device="cuda",
                                          args=([job],), timeout_s=300.0)]
    for r in ranks:
        assert abs(r["loss"] - float(loss1)) <= 1e-4 * abs(float(loss1))
    full = gather_model_shards([r["grads"] for r in sorted(ranks, key=lambda x: x["model_index"])],
                               cfg)
    for path, g in tree.items(full):
        norm = np.linalg.norm(want[path])
        if norm == 0:
            assert not np.any(g), path
            continue
        assert np.linalg.norm(g - want[path]) / norm <= 1e-4, path
    return ranks


@pytest.mark.cuda
def test_ring_sp2_on_one_card_over_gloo_equals_cpu(cuda_device):
    """The ring (``attn_mode="ring"``) at sp = 2 on one card over gloo: the
    loss and every gradient within 1e-4 of the CPU's sp = 1 step; each
    rank's hops (a layer and chunk in the seam, its replay and the
    backward) counted."""
    ranks = _sp2_step_over_gloo_equals_cpu(dict(attn_mode="ring"))
    for r in ranks:
        c = r["ctx_counts"]
        assert c["model_ppermute_calls"] == 2 * 2 * 3 and c["model_pmax_calls"] == 2, c


@pytest.mark.cuda
def test_model_axis_sp2_on_one_card_over_gloo_equals_cpu(cuda_device):
    """sp = 2 as two ranks (processes) sharing the card over gloo, every
    collective staged through pinned host memory, fp32 reduced qwen2-7b
    under the default plan: each rank's loss, and every gradient leaf
    gathered over the ranks, within 1e-4 relative L2 of the CPU's sp = 1
    step.  The ranks run tests/_torch_model_axis_workers.py."""
    import _torch_model_axis_workers as W
    from repro_torch.launch import mesh
    from repro_torch.models.convert import gather_model_shards
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("qwen2-7b").reduced()
    S, B = 256, 2
    gen = torch.Generator().manual_seed(0)
    mdef = build_model(cfg)
    params = {"stages": mdef.init_stage_params(gen, torch.float32, "cpu"),
              "globals": mdef.init_globals(gen, torch.float32, "cpu")}

    def stack(slots):
        if isinstance(slots[0], dict):
            return {k: stack([s[k] for s in slots]) for k in slots[0]}
        return np.stack([s.numpy() for s in slots]).astype(np.float32)

    params_np = {"stages": stack(params["stages"]),
                 "globals": tree.map_(lambda t: t.numpy(), params["globals"])}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    cell = runner.resolve_cell(cfg, ShapeConfig("t", S, B, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=2, grad_accum=1),
                               dtype=torch.float32)
    loss1, grads1 = runner.loss_and_grads(cell, params, torch.from_numpy(tokens),
                                          torch.from_numpy(labels))
    want = {path: g.numpy() for path, g in tree.items(grads1)}
    job = dict(name="sp2", arch="qwen2-7b", layout=dict(sp=2, n_chunks=2), params=params_np,
               tokens=tokens, labels=labels)
    ranks = [r["sp2"] for r in mesh.spawn(W.layout_rank, 2, backend="gloo", device="cuda",
                                          args=([job],), timeout_s=300.0)]
    for r in ranks:
        assert abs(r["loss"] - float(loss1)) <= 1e-4 * abs(float(loss1))
    full = gather_model_shards([r["grads"] for r in sorted(ranks, key=lambda x: x["model_index"])],
                               cfg)
    for path, g in tree.items(full):
        norm = np.linalg.norm(want[path])
        if norm == 0:
            assert not np.any(g), path
            continue
        assert np.linalg.norm(g - want[path]) / norm <= 1e-4, path


# ---------------------------------------------------------------------------
# Paged serving (DESIGN.md §16): the paged step's kernel call, the sink
# ---------------------------------------------------------------------------


def _paged_geometry(sp):
    from repro_torch.runtime import kvpool

    return kvpool.PoolGeometry(s_bucket=256, sp=sp, max_new=40, block_tokens=16, n_blocks=48,
                               n_slots=4)


@pytest.mark.cuda
@pytest.mark.parametrize("sp,rank", [(1, 0), (2, 1)])
@pytest.mark.parametrize("dtype,kernels", [("bfloat16", "tensor_cores"),
                                           ("bfloat16", "cuda_cores"), ("float32", "cuda_cores")])
def test_kernels_at_the_paged_step(cuda_device, sp, rank, dtype, kernels):
    """The paged step's call: each row at its own position ([B, 1] q_pos:
    an inactive row at 0, rows at several decode depths) over its gathered
    [B, l_loc, Hkv, hd] logical slots and the rank's shared position map,
    against the plain version."""
    from repro_torch.runtime import kvpool

    geo = _paged_geometry(sp)
    sched = dataclasses.make_dataclass("Sched", ["offsets", "lengths"])((0, 128), (128, 128))
    pos_map = kvpool.pos_map(geo, sched)[rank]
    B, H, Hkv, hd = geo.n_slots, 28, 4, 128
    arrays = inputs(B, 1, geo.l_loc, H, Hkv, hd, hd, seed=3)
    q_pos = np.array([[0], [geo.s_bucket], [geo.s_bucket + 7], [geo.s_bucket + 39]], np.int32)
    _check_kernel(arrays, dtype, q_pos, pos_map, cuda_device, kernels=kernels)


@pytest.mark.cuda
def test_paged_step_on_the_card_writes_only_its_slots_and_the_sink(cuda_device):
    """The paged step's routing and write on the card, rank 1 of sp = 2:
    the row that owns its token writes its striped slot through its block
    table, a row owned by rank 0 and an inactive row write the sink, no
    other slot changes (no device-side assert: no index past the buffer),
    and the written slot and the step's output equal the CPU's on the same
    inputs within 1e-5."""
    from repro_torch.models import attention as A
    from repro_torch.models.model_zoo import build_model
    from repro_torch.runtime import kvpool

    cfg = get_config("qwen2-7b").reduced()
    mdef = build_model(cfg)
    geo = kvpool.PoolGeometry(s_bucket=8, sp=2, max_new=4, block_tokens=2, n_blocks=9, n_slots=3)
    gen = torch.Generator().manual_seed(0)
    params = mdef.init_stage_params(gen, torch.float32, "cpu")[0]["attn"]
    pool = mdef.init_pool(geo, torch.float32, "cpu", n_slots=1)[0]["kv"]
    for t in pool:
        t.copy_(torch.randn(t.shape, generator=gen))
    x = torch.randn((3, 1, cfg.d_model), generator=gen)
    btab = torch.tensor([[0, 1, 2], [3, 4, 5], [6, -1, -1]], dtype=torch.int32)
    sched = dataclasses.make_dataclass("Sched", ["offsets", "lengths"])((0,), (8,))
    pos_map = torch.from_numpy(kvpool.pos_map(geo, sched)[1])
    q_pos = torch.tensor([geo.s_bucket + 1, geo.s_bucket + 2, 0], dtype=torch.int32)
    outs = {}
    for dev in ("cpu", cuda_device):
        p = {k: t.to(dev) for k, t in params.items()}
        pl = A.PooledKV(*(t.clone().to(dev) for t in pool))
        pg = A.paged_meta(q_pos.to(dev), btab.to(dev), pos_map.to(dev), base=geo.base,
                          s_bucket=geo.s_bucket, block_tokens=geo.block_tokens, sp=2, rank=1,
                          p_loc=geo.p_loc)
        rope = runner._rope(cfg, pg.q_pos[:, None])
        y, pl = A.gqa_paged_decode_attention(x.to(dev), p, cfg, pl, pg, rope)
        torch.cuda.synchronize()
        outs[str(dev)] = (y.cpu(), [t.cpu() for t in pl])
    y_cpu, pool_cpu = outs["cpu"]
    y_gpu, pool_gpu = outs[str(cuda_device)]
    for before, after in zip(pool, pool_gpu):
        changed = (before != after).reshape(before.shape[0], -1).any(1).nonzero()[:, 0].tolist()
        assert changed == [4, geo.p_loc], changed
    for a, b in zip(pool_cpu, pool_gpu):
        # the written slot's K/V come from the card's and the CPU's own
        # matrix products: equal to fp32 rounding, not bitwise
        np.testing.assert_allclose(b[4].numpy(), a[4].numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_gpu.numpy(), y_cpu.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# granite-moe-1b-a400m: hd 64, G = 2 (16 heads over 8 KV heads), its expert
# block on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernels", [(d, k) for d in ("float32", "bfloat16")
                                           for k in _kernels(d)])
def test_kernels_at_granite_head_dim_and_group(cuda_device, dtype, kernels):
    """hd 64 with G = 2 (granite's heads) over ragged Tq and S, PAD slots:
    the forward and the backward pair against their plain versions, and
    granite's decode step (4 rows, Tq 1 over the serve path's 2176-slot
    buffer, a PAD tail) whose KV range splits, merged in the launch or by
    the merge kernel."""
    Tq, S, Hkv = 203, 461, 8
    arrays = inputs(2, Tq, S, 2 * Hkv, Hkv, 64, 64, seed=64)
    q_pos = np.arange(Tq, dtype=np.int32) + S - Tq - 5
    kv_pos = np.arange(S, dtype=np.int32)
    kv_pos[-5:] = 2**30
    _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)
    _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)
    B, S = 4, 2176
    arrays = inputs(B, 1, S, 2 * Hkv, Hkv, 64, 64, seed=65)
    kv_pos = np.where(np.arange(S) <= 2048, np.arange(S), 2**30).astype(np.int32)
    before = fa.counts()
    _check_kernel(arrays, dtype, np.full((1,), 2048, np.int32), kv_pos, cuda_device,
                  kernels=kernels)
    assert _launched(before)[FWD_COUNTERS[kernels][1]] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_block_on_the_card_equals_the_cpu(cuda_device, cf):
    """granite's expert block at full width (fp32, 512 tokens, at its
    capacity factor and with copies dropped at 0.5) on the card against
    its CPU run: the expert ids exact, the output, the balance loss and
    every gradient within 1e-5 x max; two card runs bitwise alike."""
    from repro_torch.models import moe as M

    cfg = get_config("granite-moe-1b-a400m")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    d, E, ff = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    gen = torch.Generator().manual_seed(0)
    p = {"router": torch.randn(d, E, generator=gen) / 32,
         "w1": torch.randn(E, d, ff, generator=gen) / 32,
         "w3": torch.randn(E, d, ff, generator=gen) / 32,
         "w2": torch.randn(E, ff, d, generator=gen) / 22}
    x = torch.randn(2, 256, d, generator=gen)
    dy = torch.randn(2, 256, d, generator=gen)

    def run(device):
        pt = {k: v.detach().to(device).requires_grad_() for k, v in p.items()}
        xt = x.detach().to(device).requires_grad_()
        _, top_e, _ = M.route(xt.detach().reshape(-1, d), pt["router"].detach(), cfg)
        y, aux = M.moe_block(xt, pt, cfg)
        torch.autograd.backward([y, aux], [dy.to(device), torch.ones((), device=device)])
        return {"top_e": top_e, "y": y.detach(), "aux": aux.detach(), "dx": xt.grad,
                **{f"d{k}": v.grad for k, v in pt.items()}}

    cpu, card, again = run("cpu"), run(cuda_device), run(cuda_device)
    assert torch.equal(card["top_e"].cpu(), cpu["top_e"])
    for k, want in cpu.items():
        if k == "top_e":
            continue
        got = card[k].cpu()
        assert torch.equal(card[k], again[k]), k
        err = (got - want).abs().max().item()
        assert err <= TOL * max(1.0, want.abs().max().item()), f"{k}: {err}"


# ---------------------------------------------------------------------------
# MLA (deepseek-v3-671b): the wide tensor-core kernels
# ---------------------------------------------------------------------------

MLA_SCALE = 1 / 192 ** 0.5   # 1 / sqrt(nope + rope head dims)


def _mla_inputs(device, B, Tq, S, H, Hkv, view, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(B, Tq, H, 576, generator=g, device=device).bfloat16()
    k = torch.randn(B, S, Hkv, 576, generator=g, device=device).bfloat16()
    v = k[..., :512] if view else torch.randn(B, S, Hkv, 512, generator=g,
                                              device=device).bfloat16()
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,S,H,Hkv,view", [
    (4, 1, 2176, 128, 1, True),     # a decode step over the serving cache: split, merged
    (4, 128, 2048, 128, 1, True),   # a serving prefill chunk
    (1, 96, 640, 128, 1, True),     # a train chunk, ragged
    (2, 9, 100, 32, 2, False),      # v a tensor of its own, G = 16
])
def test_mla_kernels_match_plain(cuda_device, B, Tq, S, H, Hkv, view):
    """The wide forward and backward pair at MLA's widths against the plain
    versions: forward within 1e-5, each gradient within 1e-5 x max |plain|,
    one launch each (a split decode merges in its launch)."""
    q, k, v = _mla_inputs(cuda_device, B, Tq, S, H, Hkv, view, seed=Tq + S)
    q_pos = torch.arange(S - Tq, S, dtype=torch.int32, device=cuda_device)
    kv_pos = torch.arange(S, dtype=torch.int32, device=cuda_device)
    kv_pos[S - S // 16:] = ref.PAD_POS               # empty slots past the filled ones
    before = fa.counts()
    o, m, l = fa.flash_attention_partial(q, k, v, q_pos, kv_pos, scale=MLA_SCALE)
    moved = _launched(before)
    assert moved.pop("fwd_tc") == 1 and set(moved) <= {"merged_in_kernel"}, moved
    wo, wm, wl = ref.attention_partial_ref(q, k, v, q_pos, kv_pos, scale=MLA_SCALE)
    torch.cuda.synchronize()
    assert (ref.normalize(o, l) - ref.normalize(wo, wl)).abs().max().item() <= TOL
    assert (m - wm).abs().max().item() <= TOL
    if Tq == 1:
        return
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    do = torch.randn(B, Tq, H, 512, generator=gen, device=cuda_device)
    dl = torch.randn(B, Tq, H, generator=gen, device=cuda_device)
    before = fa.counts()
    got = fa.flash_attention_partial_bwd(q, k, v, q_pos, kv_pos, do, wm, dl, scale=MLA_SCALE)
    assert _launched(before) == {"bwd_dq_tc": 1, "bwd_dkv_tc": 1}
    want = ref.attention_partial_bwd_ref(q, k, v, q_pos, kv_pos, None, do, wm, dl,
                                         scale=MLA_SCALE)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max().item()
        assert err <= TOL * max(1.0, b.abs().max().item()), f"{name}: err {err}"


@pytest.mark.cuda
def test_mla_window_dead_rows_exact_and_nan_cotangents(cuda_device):
    """A packed window at MLA's widths: fully masked rows come back exactly
    o = l = 0, m = -1e30, and their NaN cotangents reach nothing (dq 0)."""
    q, k, v = _mla_inputs(cuda_device, 2, 8, 200, 128, 1, True, seed=3)
    q_pos = torch.tensor([[16 + i for i in range(8)], [1] + [9 + i for i in range(7)]],
                         dtype=torch.int32, device=cuda_device)
    q_start = torch.tensor([[0, 0, 4, 4, 4, 20, 20, ref.PAD_POS],
                            [0, 3, 3, 3, 9, 9, ref.PAD_POS, ref.PAD_POS]],
                           dtype=torch.int32, device=cuda_device)
    kv_pos = torch.arange(200, dtype=torch.int32, device=cuda_device) + 2
    o, m, l = fa.flash_attention_partial(q, k, v, q_pos, kv_pos, q_start=q_start, scale=MLA_SCALE)
    wo, wm, wl = ref.attention_partial_ref(q, k, v, q_pos, kv_pos, q_start=q_start,
                                           scale=MLA_SCALE)
    dead = wm[..., 0] < -1e29
    assert int(dead.sum()) == 4
    assert (o[dead] == 0).all() and (l[dead] == 0).all() and (m[dead] == -1e30).all()
    do = torch.randn(2, 8, 128, 512, device=cuda_device)
    dl = torch.randn(2, 8, 128, device=cuda_device)
    do[dead], dl[dead] = float("nan"), float("nan")
    dq, dk, dv = fa.flash_attention_partial_bwd(q, k, v, q_pos, kv_pos, do, wm, dl,
                                                q_start=q_start, scale=MLA_SCALE)
    assert (dq[dead] == 0).all() and torch.isfinite(dk).all() and torch.isfinite(dv).all()


@pytest.mark.cuda
def test_mla_widths_refused_by_the_cuda_core_kernels(cuda_device):
    """The CUDA-core pair keeps its limit of 128: fp32 (and bf16 asked of
    it) at MLA's widths raises, launching nothing."""
    q, k, v = _mla_inputs(cuda_device, 1, 2, 16, 128, 1, True, seed=0)
    pos = torch.arange(16, dtype=torch.int32, device=cuda_device)
    before = fa.counts()
    with pytest.raises(ValueError, match="CUDA-core kernels take"):
        fa.flash_attention_partial(q.float(), k.float(), k.float()[..., :512], pos[-2:], pos)
    with pytest.raises(ValueError, match="CUDA-core kernels take"):
        fa.flash_attention_partial(q, k, v, pos[-2:], pos, kernels="cuda_cores")
    assert fa.counts() == before


# ---------------------------------------------------------------------------
# the SSM family: zamba2-7b's shared attention block (hd 112, G = 1), and the
# reduced rwkv6-3b and zamba2-7b steps on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kernels", [(d, k) for d in ("float32", "bfloat16")
                                           for k in _kernels(d)])
def test_kernels_at_zamba2_head_dim_and_group(cuda_device, dtype, kernels):
    """hd 112 with G = 1 (zamba2's 32 heads, one a KV head) over ragged Tq
    and S, PAD slots: the forward and the backward pair against their plain
    versions, and the decode step (4 rows, Tq 1 over the serve path's
    2176-slot buffer, a PAD tail) whose KV range splits, merged in the
    launch or by the merge kernel."""
    Tq, S, H = 203, 461, 32
    arrays = inputs(2, Tq, S, H, H, 112, 112, seed=112)
    q_pos = np.arange(Tq, dtype=np.int32) + S - Tq - 5
    kv_pos = np.arange(S, dtype=np.int32)
    kv_pos[-5:] = 2**30
    _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)
    _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, kernels=kernels)
    B, S = 4, 2176
    arrays = inputs(B, 1, S, H, H, 112, 112, seed=113)
    kv_pos = np.where(np.arange(S) <= 2048, np.arange(S), 2**30).astype(np.int32)
    before = fa.counts()
    _check_kernel(arrays, dtype, np.full((1,), 2048, np.int32), kv_pos, cuda_device,
                  kernels=kernels)
    assert _launched(before)[FWD_COUNTERS[kernels][0]] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers", [("rwkv6-3b", 2), ("zamba2-7b", 4)])
def test_ssm_reduced_step_on_the_card_equals_the_cpu(cuda_device, arch, layers):
    """The reduced config in fp32 (2 RWKV6 layers; 2 zamba2 groups), the same
    weights, one loss-and-gradients call at S 256 in 2 chunks under the
    default plan with chunk 0 offloading every tagged row: the loss within
    1e-5 and every gradient leaf within 1e-4 relative L2 of the CPU's; the
    attention launches of zamba2's shared block (two a group and chunk, the
    chunk and its replay), none of rwkv6's; the rows through pinned host
    memory."""
    cfg = get_config(arch).reduced(n_layers=layers)
    cell = runner.resolve_cell(cfg, ShapeConfig("ssm", 256, 2, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=2), dtype=torch.float32)
    cell = dataclasses.replace(cell, alphas=(1.0, 0.0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64))
    labels = tokens.roll(-1, 1)
    params = build_params(cell, "cpu", seed=0)
    want_loss, want = runner.loss_and_grads(cell, params, tokens, labels)
    on_card = tree.map_(lambda t: t.to(cuda_device), params)
    before = fa.counts()
    hostmem.reset_counts()
    loss, got = runner.loss_and_grads(cell, on_card, tokens.to(cuda_device),
                                      labels.to(cuda_device))
    launched = _launched(before)
    groups = cell.mdef.n_slots if cfg.family == "hybrid" else 0
    assert launched.get("fwd", 0) == 4 * groups and launched.get("bwd_dq", 0) == 2 * groups
    assert launched.get("fwd_tc", 0) == 0
    copied = hostmem.counts()
    assert copied["d2h_bytes"] == copied["h2d_bytes"] > 0 and copied["d2h_pinned"] == copied["d2h"]
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for (path, g), w in zip(tree.items(got), tree.leaves(want)):
        g = g.cpu()
        assert torch.isfinite(g).all(), path
        if w.norm() > 0:
            assert ((g - w).norm() / w.norm()).item() <= 1e-4, path


# ---------------------------------------------------------------------------
# the cross-attention families: the narrow kernels non-causal at
# llama-3.2-vision-11b's cross shape and at whisper-tiny's encoder and cross
# shapes, and the reduced models' steps on the card against the CPU
# ---------------------------------------------------------------------------


XATTN_SHAPES = {  # B, Tq, S, H, Hkv, hd; q_pos zeros (unread), every slot visible
    "vlm_cross_chunk": (2, 128, 1600, 32, 8, 128),
    "vlm_cross_decode": (4, 1, 1600, 32, 8, 128),
    "whisper_encoder": (1, 1500, 1500, 6, 6, 64),
    "whisper_cross_chunk": (2, 128, 1500, 6, 6, 64),
    "whisper_cross_decode": (4, 1, 1500, 6, 6, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(XATTN_SHAPES))
@pytest.mark.parametrize("dtype,kernels", [(d, k) for d in ("float32", "bfloat16")
                                           for k in _kernels(d)])
def test_kernels_non_causal_at_the_cross_attention_shapes(cuda_device, shape, dtype, kernels):
    """causal=False at the VLM's cross layer (hd 128, G 4 over 1600
    patches) and whisper's encoder (1500 x 1500 frames, its positions as
    q_pos, 10 PAD frames past n_valid) and cross layer (hd 64, G 1 over 1500
    frames): the forward, and where Tq > 1 the backward pair, against their
    plain versions; a batch row with a PAD window is dead, exactly (its dq
    exactly 0 under NaN cotangents)."""
    PAD = 2**30
    B, Tq, S, H, Hkv, hd = XATTN_SHAPES[shape]
    arrays = inputs(B, Tq, S, H, Hkv, hd, hd, seed=sum(XATTN_SHAPES[shape]))
    kv_pos = np.arange(S, dtype=np.int32)
    q_pos = np.zeros(Tq, np.int32)
    if shape == "whisper_encoder":
        kv_pos[1490:] = PAD
        q_pos = kv_pos
    _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, causal=False, kernels=kernels)
    q_start = np.zeros((B, Tq), np.int32)
    q_start[-1, -1] = PAD
    o, m, l = _check_kernel(arrays, dtype, q_pos, kv_pos, cuda_device, q_start=q_start,
                            causal=False, kernels=kernels)
    dead = torch.from_numpy(q_start == PAD).to(cuda_device)
    assert (o[dead] == 0).all() and (l[dead] == 0).all() and (m[dead] == -1e30).all()
    assert (l[~dead] > 0).all()
    if Tq > 1:
        _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, causal=False, kernels=kernels)
        dq, _, _ = _check_bwd(arrays, dtype, q_pos, kv_pos, cuda_device, q_start=q_start,
                              causal=False, dead=dead, kernels=kernels)
        assert (dq[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_xattn_reduced_step_on_the_card_equals_the_cpu(cuda_device, arch):
    """The reduced config in fp32 (one VLM group; 2 whisper decoder and 2
    encoder layers), the VLM's cross gates set to XATTN_GATES, the same
    weights and context, one loss-and-gradients call at S 256 in 2 chunks
    under the default plan with chunk 0 offloading every tagged row: the
    loss within 1e-5 and every gradient leaf within 1e-4 relative L2 of the
    CPU's (a k bias's, zero up to rounding, relative to its layer's q
    bias's); the CUDA-core kernels launched twice a chunked attention call
    (the chunk and its replay) and once an encoder layer, the backward pair
    once each; the rows through pinned host memory."""
    cfg = get_config(arch).reduced()
    cell = runner.resolve_cell(cfg, ShapeConfig("xattn", 256, 2, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=2), dtype=torch.float32)
    cell = dataclasses.replace(cell, alphas=(1.0, 0.0))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 256)).astype(np.int64))
    labels = tokens.roll(-1, 1)
    context = torch.from_numpy(
        rng.standard_normal((2, cell.mdef.n_context(), cfg.d_model)).astype(np.float32))
    params = set_cross_gates(build_params(cell, "cpu", seed=0))
    want_loss, want = runner.loss_and_grads(cell, params, tokens, labels, context=context)
    on_card = tree.map_(lambda t: t.to(cuda_device), params)
    before = fa.counts()
    hostmem.reset_counts()
    loss, got = runner.loss_and_grads(cell, on_card, tokens.to(cuda_device),
                                      labels.to(cuda_device), context=context.to(cuda_device))
    launched = _launched(before)
    per_chunk = (cell.mdef.n_slots * (cfg.cross_attn.every + 1) if cfg.family == "vlm"
                 else 2 * cfg.n_layers)
    chunked = per_chunk * cell.sched.n
    assert launched.get("fwd", 0) == 2 * chunked + cfg.encoder_layers
    assert launched.get("bwd_dq", 0) == launched.get("bwd_dkv", 0) == chunked + cfg.encoder_layers
    assert launched.get("fwd_tc", 0) == 0
    copied = hostmem.counts()
    assert copied["d2h_bytes"] == copied["h2d_bytes"] > 0 and copied["d2h_pinned"] == copied["d2h"]
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    want = dict(tree.items(want))
    for path, g in tree.items(got):
        g, w = g.cpu(), want[path]
        assert torch.isfinite(g).all(), path
        # a k bias's gradient is zero up to rounding (it shifts every score
        # of a query alike): measured against its layer's q bias's
        n = want[path[:-2] + "bq"].norm() if path.endswith("attn/bk") else w.norm()
        if n > 0:
            assert ((g - w).norm() / n).item() <= 1e-4, path
    assert float(got["stages"][0]["xattn"]["wq"].norm()) > 0
