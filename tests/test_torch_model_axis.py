"""The port's model axis (sp > 1: sequence-sharded chunks, per-layer weight
gathers, the gather_q / gather_kv attention, the vocab-parallel loss) and
the data axis's packed rows, codecs and moment offload at pp > 1, against
the JAX reference, on CPU ranks over gloo.

The reduced qwen2-7b and sppo-gpt-7b at fp32, B = 2, S = 256.  JAX builds
the parameters once per case in this process; the same numpy arrays go to
the ranks, which ``launch.mesh.spawn`` starts (``tests/
_torch_model_axis_workers.py``, no JAX; one spawn of 2 ranks and one of 4
run every layout of that many ranks).  Each rank holds its model shard of
every leaf (``convert.params_from_numpy(sp=, model_rank=)``) and returns
its loss and gradients; ``convert.gather_model_shards`` puts each data
rank's shards back together.

What is held, and how:

- the collectives and their backward against dense one-process sums, the
  two attention schedules against attention over the whole sequence;
- loss and every gradient leaf at sp = 2 (pp 1; pp 2 plain and MSP; dp 2)
  under the default plan against the reference's single-device
  ``run_pipeline`` at 1e-5, the loss also against the reference's own sp =
  2 ``shard_map`` step (``memledger.build_step`` at data 1 x model 2):
  the port computes the gradient of the global loss, which the reference's
  ``check_vma=False`` step does not (PERF.md §6), so the reference's
  gradients at model 2 are not a target;
- ``merge_bf16`` and ``grad_compress``: the loss within the reference's
  3e-4 and every gradient within 1e-2 x max |leaf|;
- packed rows at pp 2 and at sp 2 against the pad-to-max oracle at 1e-5
  (tests/test_varlen.py::test_packed_equals_pad_to_max_oracle_pp2);
- the moment offload on == off over three steps at pp 2
  (tests/test_opt_offload.py::test_offload_identity_after_three_steps) and
  the codecs' drift law on the tick loop at dp 2 x pp 2 and at pp 2 x sp 2
  (tests/test_offload_quant.py::test_pp2_compressed_drift_within_pinned_tolerance);
- three clipped AdamW steps at sp 2 against the reference's single-device
  steps at 1e-5;
- the weight carrier's shard / gather round trip, bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_offload_quant as jquant
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.models.model_zoo import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.parallel import runner as jrunner
from repro.parallel.ctx import SINGLE as JSINGLE
from repro_torch.configs.base import get_config
from repro_torch.core import tree
from repro_torch.data import pipeline as dpipe
from repro_torch.launch import mesh
from repro_torch.models.convert import gather_model_shards, params_from_numpy
from repro_torch.models.model_zoo import build_model, marker_dim, param_markers

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)
import _torch_model_axis_workers as W  # noqa: E402
import _torch_pipeline_workers as PW  # noqa: E402

S, B = 256, 2
TOL = 1e-5
LOSS_BF16_TOL = 3e-4          # the reference's bar for merge_bf16 / grad_compress
GRAD_BF16_TOL = 1e-2          # x max |leaf|
DEADLINE_S = 400.0
LR = dict(peak=1e-2, warmup=1, total=10)
# AdamW's first steps divide each gradient element by |g| + 1e-8, so where
# |g| is near 1e-8 an element's update moves by lr x (its gradient's fp32
# rounding) / 1e-8: at lr 1e-2 that is 7e-5 between any two correct
# computations of the gradient (the port's sp = 2 against the reference's
# one device: layer 0's wo); at 1e-4 it stays under 1e-6, so the
# parameters after three steps can be held at 1e-5
LR_ADAMW = dict(peak=1e-4, warmup=1, total=10)
ARCHS = ("qwen2-7b", "sppo-gpt-7b")
# name -> (arch, layout); every layout trains under the default plan
# (offload on, remat "sppo", prefetch "ahead") unless it overrides it
GRAD_LAYOUTS = {
    "sp2": ("qwen2-7b", dict(sp=2, n_chunks=2)),
    "sp2_gather_kv": ("qwen2-7b", dict(sp=2, n_chunks=2, plan=dict(attn_mode="gather_kv"))),
    "sp2_auto": ("qwen2-7b", dict(sp=2, n_chunks=2, plan=dict(attn_mode="auto"))),
    "sp2_remat_none": ("qwen2-7b", dict(sp=2, n_chunks=2,
                                        plan=dict(offload=False, remat="none"))),
    "sp2_gpt": ("sppo-gpt-7b", dict(sp=2, n_chunks=2)),
    "sp2_gpt_gather_kv": ("sppo-gpt-7b", dict(sp=2, n_chunks=2,
                                              plan=dict(attn_mode="gather_kv"))),
    "pp2_sp2": ("qwen2-7b", dict(pp=2, sp=2, n_chunks=4)),
    "pp2_sp2_msp": ("qwen2-7b", dict(pp=2, sp=2, n_chunks=4, msp=True)),
    "pp2_sp2_gather_kv": ("qwen2-7b", dict(pp=2, sp=2, n_chunks=4,
                                           plan=dict(attn_mode="gather_kv"))),
    "dp2_sp2": ("qwen2-7b", dict(dp=2, sp=2, n_chunks=2)),
    "dp2_sp2_gpt": ("sppo-gpt-7b", dict(dp=2, sp=2, n_chunks=2)),
}
BF16_LAYOUTS = {
    "sp2_merge_bf16": ("qwen2-7b", dict(sp=2, n_chunks=2, plan=dict(merge_bf16=True))),
    "sp2_grad_compress": ("qwen2-7b", dict(sp=2, n_chunks=2, plan=dict(grad_compress=True))),
    "pp2_sp2_both": ("qwen2-7b", dict(pp=2, sp=2, n_chunks=4,
                                      plan=dict(merge_bf16=True, grad_compress=True,
                                                attn_mode="gather_q"))),
}
# the packed corpus of tests/test_varlen.py::_corpus: 4 packed rows against
# the pad-to-max oracle's 12 (one document a row at its packed offsets)
PACKED_LAYOUTS = {"pp2": dict(pp=2, n_chunks=4), "sp2": dict(sp=2, n_chunks=2)}
CODEC_LAYOUTS = {"model1_dp2_pp2": dict(dp=2, pp=2, n_chunks=4),
                 "model2_pp2_sp2": dict(pp=2, sp=2, n_chunks=4)}
CODECS = ("none", "fp8", "int8")


def _world(lay):
    return lay.get("dp", 1) * lay.get("pp", 1) * lay.get("sp", 1)


def _batch(vocab, rows=B, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(rows, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, -1] = -1
    labels[1, 60:90] = -1            # the label sentinel: no loss there
    return tokens, labels


def _to_np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


def _jcell(arch, **kw):
    mdef = jbuild_model(jget_config(arch).reduced())
    ov = dict(pp=1, dp=1, n_chunks=2, partition="length", grad_accum=1, offload=False,
              remat="none")
    ov.update(kw.pop("overrides", {}))
    cell = jrunner.resolve_cell(mdef, JShapeConfig("t", S, kw.pop("rows", B), "train"),
                                data_size=kw.pop("data_size", 1),
                                model_size=kw.pop("model_size", 1), overrides=ov)
    return mdef, dataclasses.replace(cell, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jax_ref(arch):
    """The reference at one device: numpy params, the batch, loss, grads,
    and three AdamW steps (loss, grad norm and parameters after each)."""
    mdef, cell = _jcell(arch)
    key = jax.random.PRNGKey(0)
    params = {"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
              "globals": mdef.init_globals(key, jnp.float32)}
    tokens, labels = _batch(mdef.cfg.vocab_size)

    def loss_fn(p):
        out = jrunner.run_pipeline(cell, JSINGLE, p["stages"], p["globals"],
                                   jnp.asarray(tokens), jnp.asarray(labels), None,
                                   with_loss=True)
        return out["loss"] / jnp.maximum(out["denom"], 1.0)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    loss, grads = vg(params)
    steps, p = [], params
    state = jadamw.init_state(params, jnp.float32)
    for _ in range(3):
        lval, g = vg(p)
        p, state, met = jadamw.apply_update(p, g, state,
                                            lr=jadamw.cosine_lr(state.step, **LR_ADAMW))
        steps.append((float(lval), float(met["grad_norm"]), _to_np(p)))
    return dict(params=_to_np(params), grads=_to_np(grads), loss=float(loss),
                tokens=tokens, labels=labels, steps=steps)


@functools.lru_cache(maxsize=None)
def _jax_sp2(arch):
    """The reference's own model-axis step: its shard_map over a data 1 x
    model 2 mesh of two of this process's fake CPU devices, the same
    parameters (seed 0) and batch: its loss and its stage gradients (each
    leaf as its out spec assembles it)."""
    from repro.runtime import memledger as ml

    _, cell = _jcell(arch, model_size=2)
    ref = _jax_ref(arch)
    fn, args = ml.build_step(cell, data_size=1, model_size=2,
                             tokens=jnp.asarray(ref["tokens"]),
                             labels=jnp.asarray(ref["labels"]), with_grad=True)
    loss, grads = jax.jit(fn)(*args)
    return float(loss), jax.tree_util.tree_map(lambda a: np.asarray(a[0], np.float32), grads)


def _corpus(vocab):
    docs = dpipe.sample_corpus(10, vocab_size=vocab, seed=3, dist="zipf", mean_len=48,
                               max_len=200)
    return docs, [len(d) for d in docs]


def _jobs(world):
    """Every job of ``world`` ranks."""
    jobs = []
    for name, (arch, lay) in {**GRAD_LAYOUTS, **BF16_LAYOUTS}.items():
        if _world(lay) == world:
            ref = _jax_ref(arch)
            jobs.append(dict(name=name, arch=arch, layout=lay, params=ref["params"],
                             tokens=ref["tokens"], labels=ref["labels"]))
    qwen = _jax_ref("qwen2-7b")
    if world == 2:
        jobs.append(dict(name="adamw_sp2", arch="qwen2-7b", layout=dict(sp=2, n_chunks=2),
                         params=qwen["params"], tokens=qwen["tokens"],
                         labels=qwen["labels"], steps=3, lr_kwargs=LR_ADAMW))
        jobs.append(dict(name="moments_pp2", arch="qwen2-7b", layout=dict(pp=2, n_chunks=4),
                         params=qwen["params"], tokens=qwen["tokens"],
                         labels=qwen["labels"], moments=3, lr_kwargs=LR))
        docs, lens = _corpus(get_config("qwen2-7b").vocab_size)
        packed = dpipe.pack_documents(docs, S, rows=4)
        oracle = dpipe.pad_to_max(docs, S, at_packed_offsets=packed, rows=12)
        for name, lay in PACKED_LAYOUTS.items():
            for kind, pb in (("packed", packed), ("oracle", oracle)):
                jobs.append(dict(name=f"{kind}_{name}", arch="qwen2-7b", layout=lay,
                                 params=qwen["params"], tokens=pb.tokens, labels=pb.labels,
                                 doc_start=pb.doc_start, doc_lens=lens))
    for name, lay in CODEC_LAYOUTS.items():
        if _world(lay) == world:
            tokens, labels = _batch(get_config("qwen2-7b").vocab_size, rows=4, seed=7)
            for codec in CODECS:
                jobs.append(dict(name=f"codec_{name}_{codec}", arch="qwen2-7b",
                                 layout={**lay, "plan": dict(offload_dtype=codec)},
                                 params=qwen["params"], tokens=tokens, labels=labels,
                                 alphas=jquant.ALPHAS))
    return jobs


@functools.lru_cache(maxsize=None)
def _spawned(world):
    return mesh.spawn(W.layout_rank, world, backend="gloo", device="cpu",
                      args=(_jobs(world),), timeout_s=DEADLINE_S)


def _ranks(name, lay):
    return [r[name] for r in _spawned(_world(lay))]


def _full_grads(ranks, arch, key="grads"):
    """{(dp_index, stage): the data rank's full gradients}, its model
    shards gathered."""
    cfg = get_config(arch).reduced()
    by = {}
    for r in ranks:
        by.setdefault((r["dp_index"], r["stage"]), []).append(r)
    return {k: gather_model_shards([r[key] for r in sorted(rs, key=lambda r: r["model_index"])],
                                   cfg)
            for k, rs in by.items()}


def _compare(name, arch, lay, ranks, want, tol, *, rel=False):
    """Every rank's loss and every gradient leaf against ``want``'s (the
    reference's single-device value); returns the leaves compared."""
    pp = lay.get("pp", 1)
    spp = -(-2 // pp)
    n = 0
    for (g, stage), full in _full_grads(ranks, arch).items():
        for i, slot in enumerate(full["stages"]):
            j = stage * spp + i
            if j >= 2:
                assert all((a == 0).all() for a in tree.leaves(slot))
                continue
            ref = dict(tree.items(jax.tree_util.tree_map(lambda a, j=j: a[j],
                                                         want["grads"]["stages"])))
            for path, got in tree.items(slot):
                atol = tol * np.abs(ref[path]).max() if rel else tol
                np.testing.assert_allclose(got, ref[path], rtol=0, atol=atol,
                                           err_msg=f"{name} dp {g} stage {stage} slot {j} {path}")
                n += 1
        ref = dict(tree.items(want["grads"]["globals"]))
        for path, got in tree.items(full["globals"]):
            atol = tol * np.abs(ref[path]).max() if rel else tol
            np.testing.assert_allclose(got, ref[path], rtol=0, atol=atol,
                                       err_msg=f"{name} dp {g} stage {stage} {path}")
            n += 1
    return n


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _collectives():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    g = rng.standard_normal((2, 4, 6)).astype(np.float32)
    Bq, T, H, Hkv, hd = 2, 16, 4, 2, 8
    a = {n: rng.standard_normal((Bq, 2 * T, h, hd)).astype(np.float32)
         for n, h in (("q", H), ("k", Hkv), ("v", Hkv), ("do", H))}
    a["pos"] = np.arange(2 * T, dtype=np.int32) + 5
    a["q_start"] = np.zeros((Bq, 2 * T), np.int32) + 5
    a["q_start"][1, 20:] = 25           # a second document in row 1
    data = dict(x=x, g=g, attn=a)
    return data, mesh.spawn(W.collectives_rank, 2, device="cpu", args=(data,),
                            timeout_s=DEADLINE_S)


def test_collectives_and_their_backward_against_dense_sums():
    """all-gather <-> reduce-scatter, the psum of a replicated value (its
    cotangent passes through), the gradient-frozen max, the bf16
    reduce-scatter of grad_compress, the permutation (its backward in
    tests/test_torch_ring.py), and the all-to-all of expert parallelism
    (its backward the all-to-all with the axes swapped; an integer tensor
    passes without a gradient; counted as ``model_all_to_all``)."""
    data, ranks = _collectives()
    x, g = data["x"], data["g"]
    gsum = g[0] + g[1]
    for m, r in enumerate(ranks):
        np.testing.assert_array_equal(r["all_gather"], x)
        np.testing.assert_allclose(r["all_gather_grad"], gsum[:, 3 * m:3 * m + 3], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(r["reduce_scatter"], 3 * x[:, 3 * m:3 * m + 3], rtol=0,
                                   atol=1e-6)
        want = np.concatenate([g[0][:, :3], g[1][:, :3]], axis=1)
        np.testing.assert_array_equal(r["reduce_scatter_grad"], want)
        np.testing.assert_allclose(r["psum"], 3 * x, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(r["psum_grad"], g[m])
        np.testing.assert_array_equal(r["pmax"], np.maximum(x, 2 * x - 3))
        assert r["pmax_requires_grad"] is False
        got = r["all_gather_param_bf16_grad"]
        assert np.abs(got - gsum[:, 3 * m:3 * m + 3]).max() <= 1e-2 * np.abs(gsum).max()
        assert np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())
        np.testing.assert_array_equal(r["ppermute"], x * (2 - m))
        want = np.concatenate([x[2 * m:2 * m + 2] * (j + 1) for j in range(2)], axis=1)
        np.testing.assert_array_equal(r["all_to_all"], want)
        cot = [g[j].reshape(2, 12) for j in range(2)]
        np.testing.assert_array_equal(r["all_to_all_grad"], np.concatenate(
            [cot[j][:, 6 * m:6 * m + 6] for j in range(2)], axis=0))
        ids = [np.arange(8).reshape(4, 2) + 100 * j for j in range(2)]
        np.testing.assert_array_equal(r["all_to_all_ids"], np.concatenate(
            [ids[j][2 * m:2 * m + 2] for j in range(2)], axis=0))
        assert r["all_to_all_ids_dtype"] == "torch.int32"
        c = r["all_to_all_counts"]
        # forward, backward and the ids: the bytes this rank put in
        assert c["model_all_to_all_calls"] == 3
        assert c["model_all_to_all_bytes"] == 2 * x.size * 4 + 8 * 4


@pytest.mark.parametrize("mode", ["gather_q", "gather_kv"])
def test_attention_schedules_against_the_whole_sequence(mode):
    """``dist_attention`` on each rank's rows and cache shard, forward and
    backward, equals attention over the whole sequence (plain version, one
    process) at 1e-5: gather_q merges the partials (its collectives: the
    queries, their positions and windows gathered, a pmax, two
    reduce-scatters), gather_kv gathers the shard and its positions."""
    from repro_torch.models import attention as A

    data, ranks = _collectives()
    a = data["attn"]
    q, k, v = (torch.from_numpy(a[n]).requires_grad_() for n in ("q", "k", "v"))
    pos = torch.from_numpy(a["pos"])
    o = A.dist_attention(q, k, v, pos, pos, q_start=torch.from_numpy(a["q_start"]))
    o.backward(torch.from_numpy(a["do"]))
    T = a["q"].shape[1] // 2
    for m, r in enumerate(ranks):
        rows = slice(m * T, (m + 1) * T)
        got = r[mode]
        for name, want in (("o", o.detach()), ("dq", q.grad), ("dk", k.grad), ("dv", v.grad)):
            np.testing.assert_allclose(got[name], want[:, rows].numpy(), rtol=0, atol=TOL,
                                       err_msg=f"{mode} rank {m} {name}")
        c = got["counts"]
        if mode == "gather_q":
            assert c["model_pmax_calls"] == 1 and c["model_reduce_scatter_calls"] == 2 + 1
        else:
            assert c["model_pmax_calls"] == 0 and c["model_all_gather_calls"] == 3
            assert c["model_reduce_scatter_calls"] == 2        # the backward's dk, dv


# ---------------------------------------------------------------------------
# loss and gradients at sp = 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GRAD_LAYOUTS))
def test_loss_and_every_grad_match_jax_single_device(name):
    """Every rank returns the global loss; the gradients of its shards,
    gathered over the model group, equal the reference's single-device
    gradients at 1e-5 (ghost slots 0), every leaf of every data rank."""
    arch, lay = GRAD_LAYOUTS[name]
    ref = _jax_ref(arch)
    ranks = _ranks(name, lay)
    assert len(ranks) == _world(lay)
    assert sorted((r["dp_index"], r["stage"], r["model_index"]) for r in ranks) == [
        (g, s, m) for g in range(lay.get("dp", 1)) for s in range(lay.get("pp", 1))
        for m in range(lay["sp"])]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=0, atol=TOL)
        assert all(L % lay["sp"] == 0 for L in r["lengths"])
    per_slot = len(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda a: a[0], ref["grads"]["stages"])))
    n_glob = len(jax.tree_util.tree_leaves(ref["grads"]["globals"]))
    pp, dp = lay.get("pp", 1), lay.get("dp", 1)
    assert _compare(name, arch, lay, ranks, ref, TOL) == dp * (2 * per_slot + pp * n_glob)


@pytest.mark.parametrize("arch", ARCHS)
def test_sp2_loss_matches_reference_sp2_shard_map(arch):
    """The loss equals the reference's own model-axis step (which the
    reference's tests hold at model 2; its gradients there are sp x the
    single-device ones on the gathered leaves, PERF.md §6)."""
    name = "sp2" if arch == "qwen2-7b" else "sp2_gpt"
    got = _ranks(name, GRAD_LAYOUTS[name][1])[0]["loss"]
    np.testing.assert_allclose(got, _jax_sp2(arch)[0], rtol=0, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_model_axis_gradients_depart_as_documented(arch):
    """Why the port's gradients are held against the reference's single
    device and not against its model axis: the reference's sp = 2 step
    (``shard_map`` with ``check_vma=False``) transposes its psums to
    psums, so every all-gathered ("ag") stage leaf's gradient is exactly 2x
    the single-device one, and sums no replicated ("rep") leaf's gradient
    over the model axis, so those are neither 1x nor 2x it (PERF.md §6).
    The port's, gathered, equal the single-device ones
    (test_loss_and_every_grad_match_jax_single_device)."""
    ref = _jax_ref(arch)
    _, grads = _jax_sp2(arch)
    spec = jbuild_model(jget_config(arch).reduced()).stage_spec()
    marks = dict(tree.items(spec))
    want = dict(tree.items(ref["grads"]["stages"]))
    halved = {}
    for path, g in tree.items(grads):
        w = want[path]
        if isinstance(marks[path], int):
            np.testing.assert_allclose(g, 2 * w, rtol=0, atol=1e-6 * max(1.0, np.abs(w).max()),
                                       err_msg=path)
        elif not path.endswith("gate"):
            halved[path] = float(np.linalg.norm(g / 2 - w) / np.linalg.norm(w))
            assert float(np.linalg.norm(g - w) / np.linalg.norm(w)) > 0.1, path
            assert halved[path] > 0.1, path
    print(f"{arch}: the reference's sp = 2 replicated-leaf gradients, halved, differ from "
          f"the single-device ones by {min(halved.values()):.3f}-{max(halved.values()):.3f} "
          "relative L2")


@pytest.mark.parametrize("name", list(BF16_LAYOUTS))
def test_merge_bf16_and_grad_compress_within_the_reference_bars(name):
    arch, lay = BF16_LAYOUTS[name]
    ref = _jax_ref(arch)
    ranks = _ranks(name, lay)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=0, atol=LOSS_BF16_TOL)
    assert _compare(name, arch, lay, ranks, ref, GRAD_BF16_TOL, rel=True) > 0


def test_model_axis_moves_what_the_closed_forms_say():
    """The sp = 2 pp = 1 step's collectives by count: per chunk, the
    embedding's reduce-scatter and its backward's gather; per chunk and
    layer under remat "sppo" (the seam's forward and its replay) the 7
    weight gathers twice with their 7 gradient reduce-scatters, gather_q's
    query and position gathers twice with its pmax and two reduce-scatters
    twice and their two backward gathers, the query gradient's
    reduce-scatter; per chunk the loss's gather, pmax and two psums and its
    gradient's reduce-scatter; the replicated leaves' gradients summed
    over the model group once."""
    arch, lay = GRAD_LAYOUTS["sp2"]
    ranks = _ranks("sp2", lay)
    n_chunks, n_layers, n_w = 2, 2, 7
    ag = n_chunks * (1 + n_layers * (2 * n_w + 2 * 2 + 2) + 1)
    rs = n_chunks * (1 + n_layers * (n_w + 2 * 2 + 1) + 1)
    for r in ranks:
        c = r["ctx_counts"]
        assert c["model_all_gather_calls"] == ag, c
        assert c["model_reduce_scatter_calls"] == rs, c
        assert c["model_pmax_calls"] == n_chunks * (2 * n_layers + 1), c
        assert c["model_psum_calls"] == 2 * n_chunks, c
        cfg = get_config(arch).reduced()
        mdef = build_model(cfg)
        shapes = {"stages": mdef.init_stage_params(torch.Generator(), device="meta"),
                  "globals": mdef.init_globals(torch.Generator(), device="meta")}
        marks = tree.leaves(param_markers(mdef, shapes))
        rep = sum(t.numel() * 4 for (p, t), mk in zip(tree.items(shapes), marks)
                  if marker_dim(mk) is None and not p.endswith("gate"))
        assert c["model_reduce_bytes"] == rep


def test_cli_trains_sp2_under_a_process_group():
    """``--mesh 1x2`` (gather_q, the default) and ``--attn-mode gather_kv``
    through the train CLI's ``main`` on two ranks whose process group is up
    (as under torchrun), in the CLI's bf16: the ranks report the same
    losses, the step-0 loss is the sp = 1 CLI's within 2e-3 relative, and
    the loss falls."""
    from repro_torch.launch import train

    base = ["--reduced", "--device", "cpu", "--steps", "3", "--seq", "256", "--batch", "2",
            "--n-chunks", "2", "--log-every", "1"]
    ranks = mesh.spawn(PW.cli_rank, 2, device="cpu",
                       args=([base + ["--mesh", "1x2"],
                              base + ["--mesh", "1x2", "--attn-mode", "gather_kv"]],),
                       timeout_s=DEADLINE_S)
    assert ranks[0] == ranks[1]
    one = [r["loss"] for r in train.main(base)]
    for losses in ranks[0]:
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
        np.testing.assert_allclose(losses[0], one[0], rtol=2e-3, atol=0)


# ---------------------------------------------------------------------------
# packed rows, codecs and moments at pp > 1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(PACKED_LAYOUTS))
def test_packed_equals_pad_to_max_oracle(name):
    """Packed rows (4 rows) and the pad-to-max oracle (12 rows, each
    document at its packed offsets) through the same layout: the loss and
    every gradient at 1e-5, as tests/test_varlen.py holds pp 2."""
    lay = PACKED_LAYOUTS[name]
    packed, oracle = _ranks(f"packed_{name}", lay), _ranks(f"oracle_{name}", lay)
    for p, o in zip(packed, oracle):
        np.testing.assert_allclose(p["loss"], o["loss"], rtol=0, atol=TOL)
    gp, go = _full_grads(packed, "qwen2-7b"), _full_grads(oracle, "qwen2-7b")
    assert set(gp) == set(go)
    for k in gp:
        for (path, a), b in zip(tree.items(gp[k]), tree.leaves(go[k])):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=f"{name} {k} {path}")


def test_moment_offload_identity_after_three_steps_at_pp2():
    """offload_moments on == off at pp 2 (each rank updates its stage and
    the globals): parameters and both moments after 3 steps within the
    reference's 1e-6 (bitwise here)."""
    for r in _ranks("moments_pp2", dict(pp=2, n_chunks=4)):
        for a, b in zip(tree.leaves(r["moments_on"]), tree.leaves(r["moments_off"])):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            assert np.array_equal(a, b)


def _drift(comp, raw):
    loss = abs(comp[0] - raw[0]) / max(abs(raw[0]), 1e-9)
    grad = float(np.linalg.norm(comp[1] - raw[1])) / max(float(np.linalg.norm(raw[1])), 1e-12)
    return loss, grad


@pytest.mark.parametrize("codec", ["fp8", "int8"])
@pytest.mark.parametrize("name", list(CODEC_LAYOUTS))
def test_compressed_drift_within_pinned_tolerance_on_the_tick_loop(name, codec):
    """The codecs on the pp 2 tick loop with the reference's pinned α
    (1.0, 0.7, 0.5, 0.0) per chunk: the loss within 1e-5 of raw offload's,
    the gradients (every rank's, flattened) drifting more than 1e-7 and at
    most the reference's GRAD_TOL, at model 1 (dp 2) and at model 2."""
    lay = CODEC_LAYOUTS[name]

    def step(c):
        ranks = _ranks(f"codec_{name}_{c}", lay)
        assert all(r["alphas"] == jquant.ALPHAS for r in ranks)
        flat = np.concatenate([np.asarray(a, np.float64).ravel() for r in ranks
                               for a in tree.leaves(r["grads"])])
        return ranks[0]["loss"], flat

    loss_d, grad_d = _drift(step(codec), step("none"))
    assert loss_d <= 1e-5, (codec, loss_d)
    assert 1e-7 < grad_d <= jquant.GRAD_TOL[codec], (codec, grad_d)


def test_adamw_three_clipped_steps_at_sp2_match_jax_single_device():
    """Three train steps at sp 2 (each rank updates its shards, clipped by
    the global norm over the model group) against the reference's three
    single-device AdamW steps (at LR_ADAMW): the loss, the norm before the
    clip (above the clip of 1.0) and every parameter after each step at
    1e-5."""
    ref = _jax_ref("qwen2-7b")
    ranks = _ranks("adamw_sp2", dict(sp=2, n_chunks=2))
    cfg = get_config("qwen2-7b").reduced()
    for k, (lval, gnorm, want) in enumerate(ref["steps"]):
        assert gnorm > 1.0
        for r in ranks:
            np.testing.assert_allclose(r["step_losses"][k], lval, rtol=0, atol=TOL)
            np.testing.assert_allclose(r["grad_norms"][k], gnorm, rtol=1e-5, atol=0)
        full = gather_model_shards([r["params_after"][k] for r in ranks], cfg)
        wst = dict(tree.items(want["stages"]))
        wgl = dict(tree.items(want["globals"]))
        for path, got in tree.items(full["stages"]):
            i, leaf = path.split("/", 1)
            np.testing.assert_allclose(got, wst[leaf][int(i)], rtol=0, atol=TOL,
                                       err_msg=f"step {k} {path}")
        for path, got in tree.items(full["globals"]):
            np.testing.assert_allclose(got, wgl[path], rtol=0, atol=TOL,
                                       err_msg=f"step {k} {path}")


# ---------------------------------------------------------------------------
# the weight carrier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_and_gather_round_trip_bitwise(arch):
    """Each model rank's shard of every leaf is its slice of the marker's
    dim (replicated leaves whole); gathering the ranks' shards gives every
    leaf back bit for bit, at sp 2 and 4."""
    ref = _jax_ref(arch)
    cfg = get_config(arch).reduced()
    full = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    marks = dict(tree.items(param_markers(build_model(cfg), full)))
    for sp in (2, 4):
        shards = [params_from_numpy(ref["params"], dtype=torch.float32, device="cpu", cfg=cfg,
                                    sp=sp, model_rank=r) for r in range(sp)]
        for path, t in tree.items(shards[1]):
            dim = marker_dim(marks[path])
            want = dict(tree.items(full))[path]
            if dim is None:
                assert torch.equal(t, want)
            else:
                assert t.shape[dim] * sp == want.shape[dim]
        back = gather_model_shards(shards, cfg)
        for (path, a), b in zip(tree.items(back), tree.leaves(full)):
            assert torch.equal(a, b), (sp, path)
    with pytest.raises(ValueError, match="pass cfg"):
        params_from_numpy(ref["params"], dtype=torch.float32, device="cpu", sp=2)
