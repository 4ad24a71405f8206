"""The port's attention kernel path and chunk partitioner against the JAX reference.

On the CPU the port's plain ``attention_partial_ref`` is held against JAX's
``attention_partial_ref`` and against the Pallas kernel in interpret mode,
over tests/test_kernels.py's SWEEP grid, on the same numpy inputs: 1e-5 for
fp32, 2e-2 for bf16 (the reference's own tolerances).  The Hopper kernel
itself is held against the plain version on the card by test_torch_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import partition as jpart
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_partial as jflash
from repro_torch.configs.base import get_config
from repro_torch.core import partition as part
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

from _torch_cases import (SWEEP, WINDOW_DEAD, inputs, sweep_case, to_np,
                          to_torch, tol, window_case)

JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _to_jax(arrays, dtype):
    return [jnp.asarray(a, JAX_DT[dtype]) for a in arrays]


@pytest.mark.parametrize("B,Tq,S,H,Hkv,hd,hv,causal,qoff,dtype", SWEEP)
def test_ref_matches_jax_ref(B, Tq, S, H, Hkv, hd, hv, causal, qoff, dtype):
    arrays, q_pos, kv_pos = sweep_case(B, Tq, S, H, Hkv, hd, hv, qoff)
    o1, m1, l1 = jref.attention_partial_ref(*_to_jax(arrays, dtype),
                                            jnp.asarray(q_pos),
                                            jnp.asarray(kv_pos),
                                            causal=causal, block_k=16)
    o2, m2, l2 = ref.attention_partial_ref(*to_torch(arrays, dtype),
                                           torch.from_numpy(q_pos),
                                           torch.from_numpy(kv_pos),
                                           causal=causal, block_k=16)
    t = tol(dtype)
    np.testing.assert_allclose(to_np(ref.normalize(o2, l2)),
                               to_np(jref.normalize(o1, l1)), rtol=t, atol=t)
    np.testing.assert_allclose(to_np(m2), to_np(m1), rtol=t, atol=t)
    np.testing.assert_allclose(to_np(l2), to_np(l1), rtol=t, atol=t)


@pytest.mark.parametrize("B,Tq,S,H,Hkv,hd,hv,causal,qoff,dtype", SWEEP)
def test_ref_matches_jax_pallas_interpret(B, Tq, S, H, Hkv, hd, hv, causal,
                                          qoff, dtype):
    arrays, q_pos, kv_pos = sweep_case(B, Tq, S, H, Hkv, hd, hv, qoff)
    o1, m1, l1 = jflash(*_to_jax(arrays, dtype), jnp.asarray(q_pos),
                        jnp.asarray(kv_pos), causal=causal, block_q=16,
                        block_k=16, interpret=True)
    # through the dispatch: CPU tensors take the plain version
    o2, m2, l2 = ops.attention_partial(*to_torch(arrays, dtype),
                                       torch.from_numpy(q_pos),
                                       torch.from_numpy(kv_pos),
                                       causal=causal, block_k=16)
    t = tol(dtype)
    np.testing.assert_allclose(to_np(ref.normalize(o2, l2)),
                               to_np(jref.normalize(o1, l1)), rtol=t, atol=t)
    np.testing.assert_allclose(to_np(m2), to_np(m1), rtol=t, atol=t)


def test_qstart_window_and_dead_rows_exact():
    arrays, q_pos, kv_pos, q_start = window_case()
    o1, m1, l1 = jref.attention_partial_ref(
        *_to_jax(arrays, "float32"), jnp.asarray(q_pos), jnp.asarray(kv_pos),
        block_k=16, q_start=jnp.asarray(q_start))
    o2, m2, l2 = ref.attention_partial_ref(
        *to_torch(arrays, "float32"), torch.from_numpy(q_pos),
        torch.from_numpy(kv_pos), block_k=16, q_start=torch.from_numpy(q_start))
    np.testing.assert_allclose(to_np(ref.normalize(o2, l2)),
                               to_np(jref.normalize(o1, l1)), rtol=1e-5, atol=1e-5)
    # dead rows are exact: o = l = 0 and m = -1e30 in both packages
    dead = WINDOW_DEAD
    for o, m, l in ((o2, m2, l2), (o1, m1, l1)):
        o, m, l = to_np(o), to_np(m), to_np(l)
        assert (o[dead] == 0).all() and (l[dead] == 0).all()
        assert (m[dead] == np.float32(-1e30)).all()
        assert (l[~dead] > 0).all()
    want = ref.mha_reference(*to_torch(arrays, "float32"),
                             torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
                             q_start=torch.from_numpy(q_start))
    np.testing.assert_allclose(to_np(ref.normalize(o2, l2)), to_np(want),
                               rtol=1e-5, atol=1e-5)


def test_merge_partials_law():
    """KV-sharded partials merged == full attention, as in the reference."""
    B, Tq, S, H, Hkv, hd = 2, 16, 64, 4, 2, 32
    arrays = inputs(B, Tq, S, H, Hkv, hd, hd, seed=3)
    q, k, v = to_torch(arrays, "float32")
    q_pos = torch.arange(Tq, dtype=torch.int32) + (S - Tq)
    kv_pos = torch.arange(S, dtype=torch.int32)
    parts = [ref.attention_partial_ref(q, k[:, r * 16:(r + 1) * 16],
                                       v[:, r * 16:(r + 1) * 16], q_pos,
                                       kv_pos[r * 16:(r + 1) * 16], block_k=8)
             for r in range(4)]
    o, m, l = ref.merge_partials(parts)
    full = ref.mha_reference(q, k, v, q_pos, kv_pos)
    np.testing.assert_allclose(to_np(ref.normalize(o, l)), to_np(full),
                               rtol=1e-5, atol=1e-5)
    jparts = [tuple(jnp.asarray(to_np(t)) for t in p) for p in parts]
    jo, jm, jl = jref.merge_partials(jparts)
    np.testing.assert_allclose(to_np(o), to_np(jo), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(m), to_np(jm), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(l), to_np(jl), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-7b", "sppo-gpt-7b"])
def test_partition_schedules_match_jax(arch):
    for reduced in (False, True):
        tcfg, jcfg = get_config(arch), jget_config(arch)
        if reduced:
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        assert part.flops_per_token_ratio(tcfg) == jpart.flops_per_token_ratio(jcfg)
        for S in (37, 64, 320, 321, 2048, 4096, 32768):
            for n in (1, 2, 5, 16, 32):
                for mult in (1, 8, 16, 128):
                    for policy in ("flops", "length"):
                        got = part.partition(S, n, tcfg, policy, multiple=mult)
                        want = jpart.partition(S, n, jcfg, policy, multiple=mult)
                        assert (got.lengths, got.offsets, got.seq_len, got.policy) == (
                            want.lengths, want.offsets, want.seq_len, want.policy)
    # the serve CLI's plan at S = 2048: 16 chunks of 128
    sched = part.partition(2048, 2048 // 64, get_config("qwen2-7b"), "flops",
                           multiple=128)
    assert sched.lengths == (128,) * 16


@pytest.mark.parametrize("G", [1, 2, 3, 7, 8, 16, 64])
def test_kernel_geometry(G):
    """The launch geometry (pure Python, so checked here): rows fit the
    block, no KV split is empty, splits only where blocks underfill the card."""
    for B, Tq, S, Hkv in ((4, 128, 2048, 4), (4, 1, 2176, 4), (1, 1, 64, 2),
                          (1, 17, 33, 1), (2, 1, 5000, 8), (1, 256, 100, 1)):
        rg, bq, nsplit, per = fa._geometry(B, Tq, S, G, Hkv, 132)
        n_tiles = -(-S // fa.BLOCK_K)
        assert rg in (1, 2, 4) and 1 <= bq <= Tq and G * bq <= 16 * rg
        assert 1 <= nsplit <= fa.MAX_SPLITS and (nsplit - 1) * per < n_tiles <= nsplit * per
        if -(-Tq // bq) * Hkv * B >= 132:
            assert nsplit == 1
    assert fa._geometry(4, 1, 2176, 7, 4, 132) == (1, 1, 17, 2)     # decode step
    assert fa._geometry(4, 128, 2048, 7, 4, 132) == (4, 9, 1, 32)   # prefill chunk


@pytest.mark.parametrize("G", [1, 2, 3, 7, 8, 16, 64])
def test_tc_kernel_geometry(G):
    """The tensor-core forward's launch geometry: 1, 2, 4 or 8 warps of 16
    rows that fit the block's G x bq rows, query tiles of equal length, no
    KV split empty, splits only where blocks leave more than half the card
    idle, and one split counter per (query tile, KV head, batch row)."""
    for B, Tq, S, Hkv in ((4, 128, 2048, 4), (4, 1, 2176, 4), (1, 1, 64, 2),
                          (1, 17, 33, 1), (2, 1, 5000, 8), (1, 256, 100, 1),
                          (1, 2560, 2560, 4), (1, 1664, 8192, 4)):
        warps, bq, nsplit, per = fa._tc_geometry(B, Tq, S, G, Hkv, 132)
        n_tiles = -(-S // fa.BLOCK_K)
        n_qt = -(-Tq // bq)
        assert warps in (1, 2, 4, fa.TC_FWD_WARPS) and 1 <= bq <= Tq
        assert G * bq <= 16 * warps and (warps == 1 or G * Tq > 8 * warps)
        assert n_qt * bq - Tq < n_qt           # every tile within one token of bq
        assert 1 <= nsplit <= fa.MAX_SPLITS and (nsplit - 1) * per < n_tiles <= nsplit * per
        if 2 * n_qt * Hkv * B > 132:
            assert nsplit == 1
        assert fa._ticket_groups(B, Tq, Hkv, bq) == n_qt * Hkv * B
    # the serve path's decode step: one warp (7 live rows), 17 splits of 2 tiles
    assert fa._tc_geometry(4, 1, 2176, 7, 4, 132) == (1, 1, 17, 2)
    assert fa._ticket_groups(4, 1, 4, 1) == 16
    # its prefill chunk: 8 query tiles of 16 tokens (112 rows), unsplit
    assert fa._tc_geometry(4, 128, 2048, 7, 4, 132) == (8, 16, 1, 32)
    # the train cell's first and last chunks: 143 / 93 tiles of 18 tokens
    assert fa._tc_geometry(1, 2560, 2560, 7, 4, 132) == (8, 18, 1, 40)
    assert fa._tc_geometry(1, 1664, 8192, 7, 4, 132) == (8, 18, 1, 128)


@pytest.mark.parametrize("dtype,kernels,want", [
    (torch.bfloat16, None, "tensor_cores"), (torch.float32, None, "cuda_cores"),
    (torch.bfloat16, "cuda_cores", "cuda_cores"), (torch.float32, "cuda_cores", "cuda_cores"),
    (torch.bfloat16, "tensor_cores", "tensor_cores"), (torch.float32, "tensor_cores", TypeError),
    (torch.bfloat16, "wgmma", ValueError),
])
def test_kernel_choice_by_dtype(dtype, kernels, want):
    """Both wrappers take the tensor cores for bf16 and the CUDA cores for
    fp32; ``kernels=`` names one (measurement only), and the tensor cores
    refuse fp32: nothing falls back."""
    if isinstance(want, str):
        assert fa._pick_kernels(kernels, dtype, "forward") == want
    else:
        with pytest.raises(want):
            fa._pick_kernels(kernels, dtype, "forward")


def test_kernel_wrapper_refuses_cpu_tensors():
    """The wrapper is the card's path only; CPU tensors reach the plain
    version through ops.attention_partial, never the other way round."""
    q = torch.zeros(1, 1, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_partial(q, q, q, torch.zeros(1, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32))


@pytest.mark.parametrize("dtype,hd,ok", [
    (torch.float32, 16, True), (torch.float32, 20, True), (torch.float32, 18, False),
    (torch.bfloat16, 24, True), (torch.bfloat16, 20, False), (torch.bfloat16, 128, True),
])
def test_kernel_wrapper_takes_only_whole_16_byte_vectors(dtype, hd, ok):
    """The kernel loads K and V in 16-byte vectors: a head dim, stride or
    base that is not whole vectors is refused before any launch (the check
    reads only shapes, strides and addresses, so it runs here)."""
    buf = torch.zeros(2, 40, 2, hd, dtype=dtype)
    view = buf[:, :33]                      # a cache prefix view keeps its alignment
    if ok:
        fa._check_vec("k", view, hd)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            fa._check_vec("k", view, hd)
    shifted = buf.view(-1)[1:1 + 2 * 33 * 2 * hd].view(2, 33, 2, hd)
    with pytest.raises(ValueError, match="16-byte"):
        fa._check_vec("k", shifted, hd)
