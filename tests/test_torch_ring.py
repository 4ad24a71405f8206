"""The port's ring attention over the model axis, the pod axis and ZeRO-1
against the JAX reference, on CPU ranks over gloo.

Mirrors tests/test_ring.py and the ring fold's property test
(tests/test_kernel_grads.py::test_ring_fold_is_arrival_order_invariant).
The same numpy inputs go through the reference and through the port's
ranks, which ``launch.mesh.spawn`` starts (``tests/_torch_ring_workers.py``,
no JAX): one spawn of 2 ranks and one of 4 run every case of that many
ranks.

What is held, and how:

- ``Ctx.ppermute_model`` and its backward against a dense permutation
  (rotations, a non-adjacent cycle, a partial permutation), exactly;
- ``ring_attention`` (B 2, T 64, H 4, Hkv 2, hd 16, fp32) at sp 2 and 4,
  causal and not, and under the packed window with the reference's
  sp-misaligned document boundary at 24: the loss and dq / dk / dv
  against the reference's dense oracle ``mha_reference`` at 1e-5, each
  rank's rotations at the closed form of ``costmodel.ring_hop_bytes``; sp
  = 1 degenerating to the oracle;
- the fold: bitwise invariant under arrival permutations (hypothesis) and
  within 1e-6 of the reference's ``fold_arrivals``;
- the ring pipeline on the reduced qwen2-7b, B 4, S 256, under the default
  plan: data 2 x model 2 at pp 2 (plain and MSP) and 1 x 4 at pp 1, loss
  within the reference's 3e-4 of its single device (and 1e-5), every
  gradient within 1e-5; pods 2 x sp 1 and pods 2 x sp 2 the same;
- ZeRO-1: three AdamW steps at pods 2 (sp 1, sp 2, sp 2 with the moments
  in host memory) bitwise equal to ``zero1=False``, the moments' bytes at
  ``costmodel.moment_bytes_from_shapes`` over the rank's slices; the
  widening rule against the reference's ``specs.opt_specs``;
- the batch rows bitwise the reference's ``shard_batch``; the train CLI's
  ``--mesh 1x2 --attn-mode ring`` under a process group, ``--attn-mode
  ring`` at one rank the degenerate ring.
"""
import dataclasses
import functools
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.kernels.ref import mha_reference as jmha
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel import ring as jring
from repro.parallel import runner as jrunner
from repro.parallel import specs as jspecs
from repro.parallel.ctx import SINGLE as JSINGLE
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import tree
from repro_torch.data import pipeline as dpipe
from repro_torch.kernels import ref
from repro_torch.launch import mesh
from repro_torch.models import attention as A
from repro_torch.models.convert import gather_model_shards
from repro_torch.models.model_zoo import build_model, shard_params
from repro_torch.parallel import ring, runner, specs
from repro_torch.parallel.ctx import SINGLE, Ctx

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)
import _torch_ring_workers as W  # noqa: E402

TOL = 1e-5
LOSS_TOL = 3e-4               # the reference's bar (tests/test_ring.py)
DEADLINE_S = 300.0
B, S = 4, 256
LR = dict(peak=1e-2, warmup=1, total=10)
ARCHS = ("qwen2-7b", "sppo-gpt-7b")
PERMS = {2: {"rotation": [(0, 1), (1, 0)], "partial": [(0, 1)]},
         4: {"rotation": [(i, (i + 1) % 4) for i in range(4)],
             "cycle": [(0, 2), (2, 1), (1, 3), (3, 0)],
             "partial": [(0, 3), (3, 0), (1, 2)]}}
# name -> (world, layout); every layout runs the default plan (offload on,
# remat "sppo", prefetch "ahead"), the ring at sp > 1
GRAD_LAYOUTS = {
    "data2_model2_pp2": (4, dict(pp=2, sp=2, n_chunks=2, plan=dict(attn_mode="ring"))),
    "data2_model2_pp2_msp": (4, dict(pp=2, sp=2, n_chunks=2, msp=True,
                                     plan=dict(attn_mode="ring"))),
    "data1_model4": (4, dict(sp=4, n_chunks=2, plan=dict(attn_mode="ring",
                                                          partition="length"))),
    "pods2_sp1": (2, dict(pods=2, n_chunks=2, plan=dict(partition="length"))),
    "pods2_sp2": (4, dict(pods=2, sp=2, n_chunks=2, plan=dict(attn_mode="ring",
                                                              partition="length"))),
}
ZERO1_LAYOUTS = {"pods2_sp1": (2, dict(pods=2, n_chunks=2)),
                 "pods2_sp2": (4, dict(pods=2, sp=2, n_chunks=2))}
ZERO1_PLANS = {"zero1": {}, "zero1_host": dict(offload_moments=True),
               "plain": dict(zero1=False)}
CLI_BASE = ["--reduced", "--device", "cpu", "--steps", "3", "--seq", "256", "--batch", "2",
            "--n-chunks", "2", "--log-every", "1"]


# ---------------------------------------------------------------------------
# inputs and the reference's values
# ---------------------------------------------------------------------------


def _qkv(seed, *, causal=True, packed=False, Bq=2, T=64, H=4, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    case = {n: rng.standard_normal((Bq, T, h, hd)).astype(np.float32)
            for n, h in (("q", H), ("k", Hkv), ("v", Hkv))}
    case["pos"] = np.arange(T, dtype=np.int32)
    # two packed documents, [0, 24) and [24, T): sp-misaligned at sp 4
    case["q_start"] = (np.broadcast_to(np.where(case["pos"] < 24, 0, 24), (Bq, T))
                       .astype(np.int32).copy() if packed else None)
    case["causal"] = causal
    return case


CASES = {"causal": _qkv(0), "noncausal": _qkv(0, causal=False), "packed": _qkv(3, packed=True)}


@functools.lru_cache(maxsize=None)
def _oracle(name):
    """The reference's dense oracle: sum(o^2) and its gradients in q, k, v."""
    c = CASES[name]
    qs = None if c["q_start"] is None else jnp.asarray(c["q_start"])

    def loss(q, k, v):
        o = jmha(q, k, v, c["pos"], c["pos"], causal=c["causal"], q_start=qs)
        return (o.astype(jnp.float32) ** 2).sum()

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(c[n]) for n in ("q", "k", "v")))
    return float(val), [np.asarray(g) for g in grads]


def _batch(vocab):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    labels[2, 100:140] = -1          # the label sentinel: no loss there
    return tokens, labels


@functools.lru_cache(maxsize=None)
def _jax_ref():
    """The reference at one device on the whole batch: numpy params (seed
    0), the batch, the loss and the gradients."""
    mdef = jbuild_model(jget_config("qwen2-7b").reduced())
    cell = jrunner.resolve_cell(mdef, JShapeConfig("t", S, B, "train"), data_size=1,
                                model_size=1,
                                overrides=dict(pp=1, dp=1, n_chunks=2, partition="length",
                                               grad_accum=1, offload=False, remat="none"))
    cell = dataclasses.replace(cell, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    params = {"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
              "globals": mdef.init_globals(key, jnp.float32)}
    tokens, labels = _batch(mdef.cfg.vocab_size)

    def loss_fn(p):
        out = jrunner.run_pipeline(cell, JSINGLE, p["stages"], p["globals"],
                                   jnp.asarray(tokens), jnp.asarray(labels), None,
                                   with_loss=True)
        return out["loss"] / jnp.maximum(out["denom"], 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float32))
    return dict(params=to_np(params), grads=to_np(grads), loss=float(loss), tokens=tokens,
                labels=labels)


def _jobs(world):
    ref = _jax_ref()
    common = dict(arch="qwen2-7b", params=ref["params"], tokens=ref["tokens"],
                  labels=ref["labels"])
    jobs = [dict(name=name, layout=lay, **common)
            for name, (w, lay) in GRAD_LAYOUTS.items() if w == world]
    jobs += [dict(name=f"zero1_{name}", layout=lay, steps=3, lr_kwargs=LR,
                  step_plans=ZERO1_PLANS if lay.get("sp", 1) > 1
                  else {k: v for k, v in ZERO1_PLANS.items() if k != "zero1_host"}, **common)
             for name, (w, lay) in ZERO1_LAYOUTS.items() if w == world]
    return jobs


@functools.lru_cache(maxsize=None)
def _spawns():
    """{world: the ranks' results} of the 2-rank and the 4-rank spawn, the
    4-rank one on a thread beside the other (their start-up overlaps)."""
    def run(world):
        data = dict(perms=list(PERMS[world].items()), attention=CASES, jobs=_jobs(world),
                    cli=[CLI_BASE + ["--mesh", "1x2", "--attn-mode", "ring"]] if world == 2
                    else [])
        try:
            out[world] = mesh.spawn(W.ring_rank, world, backend="gloo", device="cpu",
                                    args=(data,), timeout_s=DEADLINE_S)
        except RuntimeError as err:
            out[world] = err

    out = {}
    _jax_ref()
    side = threading.Thread(target=run, args=(4,), daemon=True)
    side.start()
    run(2)
    side.join(DEADLINE_S + 60.0)
    return out


def _spawned(world):
    got = _spawns().get(world)
    if got is None or isinstance(got, RuntimeError):
        raise RuntimeError(f"the {world}-rank spawn gave no result") from got
    return got


# ---------------------------------------------------------------------------
# the rotation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,name", [(w, n) for w, ps in PERMS.items() for n in ps])
def test_ppermute_and_its_backward_against_a_dense_permutation(world, name):
    """Rank d receives x of the rank that sends to it (zeros where none
    does), floats and ints together in one call; the float input's gradient
    is the cotangent of the rank it sent to (the inverse permutation, no sp
    factor), zeros where it sent nothing; the ints carry no gradient.  One
    call forward and one backward, bytes what the rank sent."""
    perm = PERMS[world][name]
    src = {d: s for s, d in perm}
    dst = {s: d for s, d in perm}
    base = np.arange(12, dtype=np.float32).reshape(3, 4)
    for r, res in enumerate(_spawned(world)):
        got = res["perms"][name]
        want = base * (src[r] + 1) if r in src else np.zeros_like(base)
        np.testing.assert_array_equal(got["y"], want)
        ints = np.arange(5, dtype=np.int32) + 10 * src[r] if r in src else np.zeros(5, np.int32)
        np.testing.assert_array_equal(got["ints"], ints)
        grad = np.full_like(base, dst[r] + 1) if r in dst else np.zeros_like(base)
        np.testing.assert_array_equal(got["x_grad"], grad)
        assert got["int_requires_grad"] is False
        c = got["counts"]
        sent = (48 + 20 if r in dst else 0) + (48 if r in src else 0)
        assert c["model_ppermute_calls"] == 2 and c["model_ppermute_bytes"] == sent, c


# ---------------------------------------------------------------------------
# ring attention against the dense oracle
# ---------------------------------------------------------------------------


def _hop_fp32(cfg, kv, batch):
    """(forward, backward) bytes of one fp32 ring hop of ``kv`` slots:
    ``costmodel.ring_hop_bytes`` prices bf16 k and v rows, and the int32
    positions travel once, forward only."""
    fwd = 2 * (cm.ring_hop_bytes(cfg, kv, batch) - 4 * kv) + 4 * kv
    return fwd, fwd - 4 * kv


def _check_attention(world, name):
    c = CASES[name]
    want_loss, (dq, dk, dv) = _oracle(name)
    ranks = _spawned(world)
    T = c["q"].shape[1]
    got_loss = sum(r["attention"][name]["loss"] for r in ranks)
    np.testing.assert_allclose(got_loss, want_loss, rtol=TOL)
    for m, r in enumerate(ranks):
        rows = slice(m * T // world, (m + 1) * T // world)
        got = r["attention"][name]
        for key, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            np.testing.assert_allclose(got[key], want[:, rows], rtol=0, atol=TOL,
                                       err_msg=f"sp {world} {name} rank {m} {key}")
        # sp - 1 hops of (k, v, positions) forward, of (dk, dv) backward
        Bq, Hkv, hd = c["k"].shape[0], c["k"].shape[2], c["k"].shape[3]
        cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), n_kv_heads=Hkv, head_dim=hd)
        fwd, bwd = _hop_fp32(cfg, T // world, Bq)
        cnt = got["counts"]
        assert cnt["model_ppermute_calls"] == 2 * (world - 1), cnt
        assert cnt["model_ppermute_bytes"] == (world - 1) * (fwd + bwd), cnt


@pytest.mark.parametrize("causal", ["causal", "noncausal"])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_dense_oracle(sp, causal):
    """sum(o^2) over every rank's rows and dq / dk / dv of each rank's
    shard against the reference's ``mha_reference`` at 1e-5 (fp32)."""
    _check_attention(sp, causal)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_packed_varlen_matches_oracle(sp):
    """The document window is query-side and stays; every arriving block
    is masked against it (the boundary at 24 splits a shard at sp 4)."""
    _check_attention(sp, "packed")
    assert CASES["packed"]["q"].shape[1] == 64


def test_ring_sp1_degenerates_to_oracle():
    """At sp = 1 the ring is one partial and a normalize."""
    c = CASES["packed"]
    q, k, v = (torch.from_numpy(c[n]) for n in ("q", "k", "v"))
    pos, qs = torch.from_numpy(c["pos"]), torch.from_numpy(c["q_start"])
    for causal in (True, False):
        o = ring.ring_attention(q, k, v, pos, pos, SINGLE, causal=causal, q_start=qs)
        want = jmha(*(jnp.asarray(c[n]) for n in ("q", "k", "v")), c["pos"], c["pos"],
                    causal=causal, q_start=jnp.asarray(c["q_start"]))
        np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    one = Ctx(device="cpu", attn_mode="ring")
    assert torch.equal(A.dist_attention(q, k, v, pos, pos, one, q_start=qs),
                       A.dist_attention(q, k, v, pos, pos, Ctx(device="cpu", attn_mode="local"),
                                        q_start=qs))


def test_auto_never_picks_the_ring():
    """"auto" chooses between the gathers by bytes, never the ring."""
    ctx = Ctx(device="cpu", attn_mode="auto")
    ctx.sp = 2        # _pick_mode reads the width alone
    for tq, kv in ((8, 4096), (4096, 8)):
        q = torch.zeros(1, tq, 28, 128)
        k = torch.zeros(1, kv, 4, 128)
        assert A._pick_mode(ctx, q, k, None) in ("gather_q", "gather_kv")


# ---------------------------------------------------------------------------
# the fold
# ---------------------------------------------------------------------------


def _fold_inputs(n_shards, seed):
    rng = np.random.default_rng(seed + 17 * n_shards)
    Tq, Bq, H, Hkv, hd = 8, 1, 4, 2, 16
    Sk = 8 * n_shards
    arrs = {n: rng.standard_normal(shape).astype(np.float32)
            for n, shape in (("q", (Bq, Tq, H, hd)), ("k", (Bq, Sk, Hkv, hd)),
                             ("v", (Bq, Sk, Hkv, hd)), ("w", (Bq, Tq, H, hd)))}
    arrs["q_pos"] = np.arange(Tq, dtype=np.int32) + Sk - Tq     # sees every shard
    arrs["kv_pos"] = np.arange(Sk, dtype=np.int32)
    return arrs


def _order(n_shards, order_seed):
    canonical = list(range(n_shards))
    rot = order_seed % n_shards
    order = canonical[rot:] + canonical[:rot]
    if order_seed >= 6:        # beyond rotations: arbitrary permutations too
        order = [int(i) for i in np.random.RandomState(order_seed).permutation(n_shards)]
    return order


def _torch_fold(a, k, order):
    q, v = torch.from_numpy(a["q"]), torch.from_numpy(a["v"])
    q_pos, kv_pos = torch.from_numpy(a["q_pos"]), torch.from_numpy(a["kv_pos"])
    parts = [ref.attention_partial_ref(q, k[:, s * 8:(s + 1) * 8], v[:, s * 8:(s + 1) * 8],
                                       q_pos, kv_pos[s * 8:(s + 1) * 8], causal=True)
             for s in order]
    return ring.fold_arrivals(parts, order, n_blocks=len(order))


@settings(deadline=None)
@given(st.integers(2, 5), st.integers(0, 11))
def test_ring_fold_is_arrival_order_invariant(n_shards, order_seed):
    """Folding the same blocks in any arrival order (each rank sees another
    rotation) gives the same (o, m, l) bits, and through them the same
    gradient bits: the blocks go to their canonical slots before the one
    merge."""
    a = _fold_inputs(n_shards, order_seed)
    order = _order(n_shards, order_seed)
    w = torch.from_numpy(a["w"])
    outs, grads = [], []
    for o in (list(range(n_shards)), order):
        k = torch.from_numpy(a["k"]).requires_grad_()
        folded = _torch_fold(a, k, o)
        (ref.normalize(folded[0], folded[2]) * w).sum().backward()
        outs.append(folded)
        grads.append(k.grad)
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    assert torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("n_shards,order_seed", [(2, 1), (3, 2), (4, 7), (5, 11)])
def test_fold_arrivals_matches_the_reference(n_shards, order_seed):
    """The port's fold within 1e-6 of the reference's on the same blocks
    (the plain partials of each shard, handed to both) in the same arrival
    order: (o, m, l) and the normalized output."""
    a = _fold_inputs(n_shards, order_seed)
    order = _order(n_shards, order_seed)
    q, k, v = (torch.from_numpy(a[n]) for n in ("q", "k", "v"))
    parts = [ref.attention_partial_ref(q, k[:, s * 8:(s + 1) * 8], v[:, s * 8:(s + 1) * 8],
                                       torch.from_numpy(a["q_pos"]),
                                       torch.from_numpy(a["kv_pos"][s * 8:(s + 1) * 8]),
                                       causal=True) for s in order]
    got = ring.fold_arrivals(parts, order, n_blocks=n_shards)
    want = jring.fold_arrivals([tuple(jnp.asarray(t.numpy()) for t in p) for p in parts], order,
                               n_blocks=n_shards)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ref.normalize(got[0], got[2]).numpy(),
                               np.asarray(want[0] / np.maximum(want[2], 1e-30)[..., None]),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the ring pipeline and the pods against the reference's single device
# ---------------------------------------------------------------------------


def _full_grads(ranks):
    """{(pod, dp_index, stage): the data rank's full gradients}."""
    cfg = get_config("qwen2-7b").reduced()
    by = {}
    for r in ranks:
        by.setdefault((r["pod_index"], r["dp_index"], r["stage"]), []).append(r)
    return {k: gather_model_shards([r["grads"] for r in sorted(rs, key=lambda r: r["model_index"])],
                                   cfg)
            for k, rs in by.items()}


@pytest.mark.parametrize("name", list(GRAD_LAYOUTS))
def test_ring_and_pods_match_jax_single_device(name):
    """Every rank's loss within the reference's 3e-4 (and 1e-5) of its
    single device on the whole batch, every gradient leaf, gathered over
    the model ranks, within 1e-5 on every pod and stage (ghost slots 0)."""
    world, lay = GRAD_LAYOUTS[name]
    want = _jax_ref()
    ranks = [r["jobs"][name] for r in _spawned(world)]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose(r["loss"], want["loss"], rtol=0, atol=TOL)
        assert r["b_loc"] == B // lay.get("pods", 1)
    pp = lay.get("pp", 1)
    spp = -(-2 // pp)
    full = _full_grads(ranks)
    assert len(full) == lay.get("pods", 1) * pp
    for (pod, g, stage), grads in full.items():
        for i, slot in enumerate(grads["stages"]):
            j = stage * spp + i
            ref_slot = dict(tree.items(jax.tree_util.tree_map(lambda a, j=j: a[j],
                                                              want["grads"]["stages"])))
            for path, got in tree.items(slot):
                np.testing.assert_allclose(got, ref_slot[path], rtol=0, atol=TOL,
                                           err_msg=f"{name} pod {pod} stage {stage} slot {j} {path}")
        wg = dict(tree.items(want["grads"]["globals"]))
        for path, got in tree.items(grads["globals"]):
            np.testing.assert_allclose(got, wg[path], rtol=0, atol=TOL,
                                       err_msg=f"{name} pod {pod} stage {stage} {path}")


def test_ring_moves_its_blocks_by_the_closed_form():
    """Each rank's rotations in the data 1 x model 4 gradients call: per
    layer and chunk sp - 1 hops of the cache view's k, v (fp32) and
    positions in the seam's forward and again in its replay, and sp - 1
    hops of dk, dv in the backward (``costmodel.ring_hop_bytes``)."""
    world, lay = GRAD_LAYOUTS["data1_model4"]
    cfg = get_config("qwen2-7b").reduced()
    sp, n_layers = lay["sp"], cfg.n_layers
    b_loc, ln = B, S // 2
    calls = nbytes = 0
    for c in range(2):
        fwd, bwd = _hop_fp32(cfg, (c + 1) * ln // sp, b_loc)
        calls += n_layers * 3 * (sp - 1)
        nbytes += n_layers * (sp - 1) * (2 * fwd + bwd)
    for r in _spawned(world):
        c = r["jobs"]["data1_model4"]["ctx_counts"]
        assert (c["model_ppermute_calls"], c["model_ppermute_bytes"]) == (calls, nbytes), c
        # the loss's max a chunk: the ring merges by its fold, with no pmax
        assert c["model_pmax_calls"] == 2 and c["model_all_gather_calls"] > 0


# ---------------------------------------------------------------------------
# ZeRO-1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,plan", [("pods2_sp1", "zero1"), ("pods2_sp2", "zero1"),
                                       ("pods2_sp2", "zero1_host")])
def test_zero1_three_steps_bitwise_equal_zero1_false(name, plan):
    """Three clipped AdamW steps with each rank updating its pod slice of
    the widened leaves (moments on the device, or in host memory) and the
    pods gathering the slices: the losses, every parameter and, sliced
    alike, every moment are the bits of ``zero1=False``; the rank's moments
    take ``costmodel.moment_bytes_from_shapes`` over its slices, less than
    whole moments; one pod gather a step."""
    world, lay = ZERO1_LAYOUTS[name]
    for r in _spawned(world):
        job = r["jobs"][f"zero1_{name}"]
        assert job["zero1"] is True and job["pod_index"] in (0, 1)
        got, want = job["plans"][plan], job["plans"]["plain"]
        assert got["losses"] == want["losses"]
        for (path, a), b in zip(tree.items(got["params"]), tree.leaves(want["params"])):
            assert np.array_equal(a, b), (name, plan, r["rank"], path)
        dims = got["pod_slices"]
        assert any(d is not None for d in dims) and want["pod_slices"] is None
        n = len(dims)
        for i, (a, b) in enumerate(zip(got["moments"], want["moments"])):
            d = dims[i % n]
            if d is not None:
                k = b.shape[d] // 2
                b = np.take(b, np.arange(job["pod_index"] * k, (job["pod_index"] + 1) * k),
                            axis=d)
            assert np.array_equal(a, b), (name, plan, i)
        assert got["moment_bytes"] == got["moment_bytes_closed_form"] < want["moment_bytes"]
        assert got["counts"]["pod_all_gather_calls"] == 3
        assert want["counts"]["pod_all_gather_calls"] == 0


@pytest.mark.parametrize("sp", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_widening_rule_matches_reference_opt_specs(arch, sp):
    """A leaf's moments split over the pods where the reference's
    ``opt_specs(zero1_pod=True)`` widens its 'model' dim to ('model',
    'pod'), along that dim, at the full widths (shapes only)."""
    pods = 2
    mdef = jbuild_model(jget_config(arch))
    struct, pspecs = jspecs.param_struct_and_specs(mdef, 1, 1)
    wide = jspecs.opt_specs(pspecs, zero1_pod=True, param_struct=struct, model_size=sp,
                            pods=pods)
    tmdef = build_model(get_config(arch))
    full = {"stages": tmdef.init_stage_params(torch.Generator(), device="meta"),
            "globals": tmdef.init_globals(torch.Generator(), device="meta")}
    dims = specs.zero1_dims(tmdef, shard_params(full, tmdef, sp, 0), sp, pods)

    def widened(spec, lead):
        for i, ax in enumerate(spec):
            if ax == ("model", "pod"):
                return i - lead
        return None

    want_stage = {p: widened(s, 2) for p, s in tree.items(wide["stages"])}
    want_glob = {p: widened(s, 0) for p, s in tree.items(wide["globals"])}
    n_wide = 0
    for (path, _), d in zip(tree.items(full), dims):
        part, rest = path.split("/", 1)
        want = want_glob[rest] if part == "globals" else want_stage[rest.split("/", 1)[1]]
        assert d == want, (arch, sp, path)
        n_wide += d is not None
    assert n_wide > 0


@pytest.mark.parametrize("pods,data_size,pp", [(1, 1, 1), (2, 1, 1), (2, 2, 1), (2, 2, 2),
                                               (1, 4, 2)])
def test_shard_batch_bitwise_the_reference(pods, data_size, pp):
    """The [pods, data, B_loc, S] layout of tokens, labels and doc_start,
    and the runner's rows of each rank (``Cell.rows``), are the
    reference's ``shard_batch`` bit for bit."""
    rng = np.random.default_rng(pods * 10 + data_size + pp)
    tokens = rng.integers(0, 1000, size=(8, 256)).astype(np.int32)
    labels = rng.integers(-1, 1000, size=(8, 256)).astype(np.int32)
    doc_start = rng.integers(0, 256, size=(8, 256)).astype(np.int32)
    got = dpipe.shard_batch(tokens, labels, pods=pods, data_size=data_size, pp=pp,
                            doc_start=doc_start)
    want = jpipe.shard_batch(tokens, labels, pods=pods, data_size=data_size, pp=pp,
                             doc_start=doc_start)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    cell = runner.resolve_cell(get_config("qwen2-7b").reduced(), ShapeConfig("t", 256, 8, "train"),
                               overrides=dict(pp=pp, dp=data_size // pp, n_chunks=1),
                               data_size=data_size, pods=pods)
    for pod in range(pods):
        for i in range(data_size):
            rank = types.SimpleNamespace(pod_index=lambda p=pod: p, data_index=lambda i=i: i)
            rows = cell.rows(rank, tokens, labels, doc_start)
            for a, k in zip(rows, ("tokens", "labels", "doc_start")):
                assert np.array_equal(a, want[k][pod, i]), (pod, i, k)


def test_plan_threads_ring_pods_and_zero1_to_ctx():
    """The plan's attn_mode and the cell's pods reach the context; ZeRO-1
    follows pods > 1 as in the reference's plan."""
    cfg = get_config("qwen2-7b").reduced()
    shape = ShapeConfig("t", 256, 4, "train")
    cell = runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, attn_mode="ring"),
                               model_size=2, pods=2)
    assert cell.plan.attn_mode == "ring" and cell.plan.zero1 and cell.pods == 2
    assert cell.b_loc == 2
    assert not runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1)).plan.zero1
    one = runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, attn_mode="ring"))
    ctx = one.ctx(device="cpu")
    assert ctx.attn_mode == "ring" and ctx.pods == 1 and not ctx.distributed
    with pytest.raises(RuntimeError, match="initialised process group"):
        Ctx(sp=2, pods=2, device="cpu", attn_mode="ring")


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def test_cli_trains_ring_under_a_process_group():
    """``--mesh 1x2 --attn-mode ring`` through the train CLI's ``main`` on
    two ranks whose process group is up (as under torchrun), in the CLI's
    bf16: the ranks report the same losses, the step-0 loss is the sp = 1
    CLI's within 2e-3 relative, and the loss falls; ``--attn-mode ring``
    at one rank is the degenerate ring, the default CLI's losses exactly."""
    from repro_torch.launch import train

    ranks = [r["cli"] for r in _spawned(2)]
    assert ranks[0] == ranks[1]
    one = [r["loss"] for r in train.main(CLI_BASE)]
    ring1 = [r["loss"] for r in train.main(CLI_BASE + ["--attn-mode", "ring"])]
    assert ring1 == one
    losses = ranks[0][0]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(losses[0], one[0], rtol=2e-3, atol=0)
