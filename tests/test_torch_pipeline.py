"""The port's multi-rank sequence pipeline (pp > 1, MSP, dp) against the JAX
reference, on CPU ranks over gloo.

The reduced qwen2-7b at fp32, B = 2, S = 512 in 4 equal chunks.  JAX builds
the parameters; the same numpy arrays and tokens go through the reference's
single-device ``value_and_grad`` of ``run_pipeline`` and, split into stages
(``convert.params_from_numpy(stage=, pp=)``), through the port's
``loss_and_grads`` on 2 or 4 spawned ranks (``launch.mesh.spawn``; the ranks
run ``tests/_torch_pipeline_workers.py``, which imports no JAX) under the
default plan (offload on, remat "sppo", prefetch "ahead"): pp = 2, pp = 4
(2 layers over 4 stages: two ghost stages), MSP at pp = 2 and 4, dp = 2 x
pp = 2.  Loss and every gradient leaf at 1e-5; the pp = 2 loss against the
reference's own pp = 2 ``shard_map`` at 1e-5; offload on (ahead and sync)
against off bitwise; the prefill caches of every stage against pp = 1's
bitwise (the drain-tick fix); the globals bitwise identical across ranks
after two steps; the tick trace against the simulator's feed events and the
reference's.  Each spawned run has a deadline and fails instead of hanging.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.core import costmodel as jcm
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel import runner as jrunner
from repro.parallel import specs as jspecs
from repro.parallel.ctx import SINGLE as JSINGLE
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import simulate as sim
from repro_torch.core import tree
from repro_torch.launch import mesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import ctx as ctx_mod
from repro_torch.parallel import runner

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)
import _torch_moe_workers as MW  # noqa: E402
import _torch_pipeline_workers as W  # noqa: E402

S, B, N = 512, 2, 4
TOL = 1e-5
DEADLINE_S = 300.0
LAYOUTS = {
    "pp2": dict(dp=1, pp=2, n_chunks=N, S=S, B=B),
    "pp2_msp": dict(dp=1, pp=2, n_chunks=N, S=S, B=B, msp=True),
    "pp4": dict(dp=1, pp=4, n_chunks=N, S=S, B=B),
    "pp4_msp": dict(dp=1, pp=4, n_chunks=N, S=S, B=B, msp=True),
    "dp2_pp2": dict(dp=2, pp=2, n_chunks=N, S=S, B=B),
}
WANT = {"pp2": {"grads", "ablations", "accum", "prefill", "steps"},
        "pp2_msp": {"grads", "prefill"},
        "pp4": {"grads", "prefill"}, "pp4_msp": {"grads", "prefill"},
        "dp2_pp2": {"grads", "steps"}}


def _batch(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, -1] = -1
    labels[1, 100:140] = -1          # the label sentinel: no loss there
    return tokens, labels


@functools.lru_cache(maxsize=None)
def _jax_ref():
    """The reference at one device: numpy params, the batch, loss, grads."""
    cfg = jget_config("qwen2-7b").reduced()
    mdef = jbuild_model(cfg)
    cell = dataclasses.replace(jrunner.resolve_cell(
        mdef, JShapeConfig("t", S, B, "train"), data_size=1, model_size=1,
        overrides=dict(pp=1, dp=1, n_chunks=N, partition="length", grad_accum=1,
                       offload=False, remat="none")), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    params = {"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
              "globals": mdef.init_globals(key, jnp.float32)}
    tokens, labels = _batch(cfg.vocab_size)

    def loss_fn(p):
        out = jrunner.run_pipeline(cell, JSINGLE, p["stages"], p["globals"],
                                   jnp.asarray(tokens), jnp.asarray(labels), None,
                                   with_loss=True)
        return out["loss"] / jnp.maximum(out["denom"], 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float32))
    return dict(params=to_np(params), grads=to_np(grads), loss=float(loss),
                tokens=tokens, labels=labels, lengths=cell.sched.lengths)


@functools.lru_cache(maxsize=None)
def _spawned(world):
    """Every layout of ``world`` ranks, run once in one spawn."""
    ref = _jax_ref()
    runs = [(name, lay, WANT[name]) for name, lay in LAYOUTS.items()
            if lay["dp"] * lay["pp"] == world]
    return mesh.spawn(W.pipeline_rank, world, backend="gloo", device="cpu",
                      args=(runs, ref["params"], ref["tokens"], ref["labels"]),
                      timeout_s=DEADLINE_S)


def _ranks(name):
    lay = LAYOUTS[name]
    return [r[name] for r in _spawned(lay["dp"] * lay["pp"])]


def _jax_slot_grads(grads, j):
    return jax.tree_util.tree_map(lambda a: a[j], grads["stages"])


def _leaves_by_path(tree_np):
    return dict(tree.items(tree_np))


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_loss_and_every_grad_match_jax_single_device(name):
    """Every rank returns the global loss and the gradients of what it holds
    (its stage, the globals) under the default plan; each equals the
    reference's single-device value at 1e-5, ghost slots' gradients are 0."""
    ref = _jax_ref()
    assert ref["lengths"] == (128, 128, 128, 128)
    lay = LAYOUTS[name]
    spp = -(-2 // lay["pp"])
    ranks = _ranks(name)
    assert sorted((r["dp_index"], r["stage"]) for r in ranks) == [
        (g, s) for g in range(lay["dp"]) for s in range(lay["pp"])]
    n_leaves = 0
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=0, atol=TOL)
        assert any(r["alphas"])          # the default plan offloads rows
        for i, slot in enumerate(r["grads"]["stages"]):
            j = r["stage"] * spp + i
            if j >= 2:                   # a ghost slot: gate 0
                assert all((a == 0).all() for a in tree.leaves(slot)), (name, r["rank"], i)
                continue
            want = _leaves_by_path(_jax_slot_grads(ref["grads"], j))
            for path, got in tree.items(slot):
                np.testing.assert_allclose(got, want[path], rtol=0, atol=TOL,
                                           err_msg=f"{name} rank {r['rank']} slot {j} {path}")
                n_leaves += 1
        want = _leaves_by_path(ref["grads"]["globals"])
        for path, got in tree.items(r["grads"]["globals"]):
            np.testing.assert_allclose(got, want[path], rtol=0, atol=TOL,
                                       err_msg=f"{name} rank {r['rank']} {path}")
            n_leaves += 1
    per_slot = len(jax.tree_util.tree_leaves(_jax_slot_grads(ref["grads"], 0)))
    n_glob = len(jax.tree_util.tree_leaves(ref["grads"]["globals"]))
    assert n_leaves == lay["dp"] * (2 * per_slot + lay["pp"] * n_glob)


# granite's tied embedding at pp = 2 (tests/_torch_moe_workers.py): the
# table is used on stage 0 (embedding) and the last (head)
TIED = {"tied_pp2": dict(pp=2, n_chunks=2, S=256, B=B)}


@functools.lru_cache(maxsize=None)
def _tied_ranks(name):
    cfg = jget_config(MW.ARCH).reduced()
    mdef = jbuild_model(cfg)
    key = jax.random.PRNGKey(0)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), {
        "stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
        "globals": mdef.init_globals(key, jnp.float32)})
    lay = TIED[name]
    tokens, labels = (a[:, :lay["S"]] for a in _batch(cfg.vocab_size))
    ranks = mesh.spawn(MW.moe_rank, lay.get("dp", 1) * lay["pp"], backend="gloo",
                       device="cpu", args=({name: lay}, params, tokens, labels),
                       timeout_s=DEADLINE_S)
    return params, [r[name] for r in ranks]


@pytest.mark.parametrize("name", list(LAYOUTS) + list(TIED))
def test_globals_go_from_the_stage_that_uses_them(name):
    """The globals' gradients are summed only where they are used and sent
    from there: each of the pp - 1 other stages of a dp group receives
    every global leaf that one stage alone uses once (the embedding from
    stage 0, the final norm and the head from the last), and no such leaf
    is all-reduced (what is all-reduced is the loss's two scalars, the
    stage-usage mask, and at dp > 1 the stage's and its owned globals'
    gradients over the dp group).  A tied table (granite, ``tied_*``) is
    used by stage 0 and the last stage: it is the one global leaf
    all-reduced over the data axis, and nothing sends it; the MoE balance
    loss adds one all-reduced scalar."""
    if name in TIED:
        params, ranks = _tied_ranks(name)
        lay = TIED[name]
        dp, pp = lay.get("dp", 1), lay["pp"]
        table = params["globals"]["embed"]["table"].nbytes
        norm = params["globals"]["final_norm"]["scale"].nbytes
        assert sum(r["ctx_counts"]["bcast_bytes"] for r in ranks) == dp * (pp - 1) * norm
        for r in ranks:
            want = 2 * 4 + 4 + pp * 2 * 4 + table
            if dp > 1:
                want += sum(a.nbytes for a in tree.leaves(r["grads"]["stages"]))
                want += norm if r["stage"] == pp - 1 else 0
            assert r["ctx_counts"]["reduce_bytes"] == want, (name, r["stage"])
        # the summed table is the same on both stages
        np.testing.assert_array_equal(ranks[0]["grads"]["globals"]["embed"]["table"],
                                      ranks[1]["grads"]["globals"]["embed"]["table"])
        return
    ref = _jax_ref()
    lay = LAYOUTS[name]
    ranks = _ranks(name)
    nbytes = lambda t: sum(a.size * a.itemsize for a in tree.leaves(t))  # noqa: E731
    g_bytes = nbytes(ref["grads"]["globals"])
    n_glob = len(tree.leaves(ref["grads"]["globals"]))
    assert sum(r["ctx_counts"]["bcast_bytes"] for r in ranks) == (
        lay["dp"] * (lay["pp"] - 1) * g_bytes)
    for r in ranks:
        want = 2 * 4 + lay["pp"] * n_glob * 4
        if lay["dp"] > 1:
            owned = {"embed"} if r["stage"] == 0 else set()
            if r["stage"] == lay["pp"] - 1:
                owned |= set(ref["grads"]["globals"]) - {"embed"}
            want += nbytes(r["grads"]["stages"]) + sum(
                nbytes(ref["grads"]["globals"][k]) for k in owned)
        assert r["ctx_counts"]["reduce_bytes"] == want, (name, r["rank"])


def _jax_pp2_loss():
    """The reference's own pp = 2 pipeline: its shard_map tick loop on a
    (2, 1) data x model mesh of two of the test process's fake CPU devices."""
    cfg = jget_config("qwen2-7b").reduced()
    mdef = jbuild_model(cfg)
    pp = 2
    cell = dataclasses.replace(jrunner.resolve_cell(
        mdef, JShapeConfig("t", S, B, "train"), data_size=pp, model_size=1,
        overrides=dict(pp=pp, dp=1, n_chunks=N, grad_accum=1, partition="length",
                       offload=False, remat="none")), dtype=jnp.float32)
    jmesh = Mesh(np.array(jax.devices()[:pp]).reshape(pp, 1), ("data", "model"))
    key = jax.random.PRNGKey(0)
    stages = [mdef.init_stage_params(key, s, pp, jnp.float32) for s in range(pp)]
    g_stage = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *stages)
    gl = mdef.init_globals(key, jnp.float32)
    ref = _jax_ref()
    batch = {k: jnp.asarray(np.stack([ref[k]] * pp))[None] for k in ("tokens", "labels")}
    pspecs = jrunner._in_specs_for_params(cell)
    _, bspecs = jrunner.batch_struct(cell)

    def body(stage_p, g, b):
        ctx = cell.ctx()
        stage_p = jax.tree_util.tree_map(lambda a: a.reshape(a.shape[1:]), stage_p)
        tok = b["tokens"].reshape(b["tokens"].shape[2:])
        lab = b["labels"].reshape(b["labels"].shape[2:])
        out = jrunner.run_pipeline(cell, ctx, stage_p, g, tok, lab, None, with_loss=True)
        return ctx.psum_loss_all(out["loss"]) / jnp.maximum(ctx.psum_loss_all(out["denom"]),
                                                            1.0)

    fn = jrunner.shard_map(body, jmesh, in_specs=(pspecs["stages"], pspecs["globals"], bspecs),
                           out_specs=P())
    return float(jax.jit(fn)(g_stage, gl, batch))


def test_pp2_loss_matches_reference_pp2_shard_map():
    got = _ranks("pp2")[0]["loss"]
    np.testing.assert_allclose(got, _jax_pp2_loss(), rtol=0, atol=TOL)


def test_offload_ahead_and_sync_equal_offload_off_bitwise():
    for r in _ranks("pp2"):
        assert r["ablations_bitwise"] == {"sync": True, "off": True}, r["rank"]


def test_grad_accum_over_ranks_equals_the_whole_batch():
    """grad_accum = 2 at pp = 2 (each rank runs both microbatches through
    its stage, the reductions after the accumulation): the loss and every
    gradient of the whole batch's step at 1e-5."""
    for r in _ranks("pp2"):
        (l1, g1), (l2, g2) = r["accum"]
        np.testing.assert_allclose(l2, l1, rtol=0, atol=TOL)
        for (path, a), b in zip(tree.items(g2), tree.leaves(g1)):
            assert a.dtype == np.float32
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=path)


@pytest.mark.parametrize("name", ["pp2", "pp2_msp", "pp4", "pp4_msp"])
def test_prefill_caches_equal_pp1_bitwise(name):
    """Each stage's caches after a pp > 1 prefill are pp = 1's for its
    layers, bit for bit: warmup and drain ticks write nothing (the
    reference's valid-tick mask, its drain-tick fix), and an MSP ramp's
    rewrite is idempotent."""
    ref = _jax_ref()
    cfg = get_config("qwen2-7b").reduced()
    cell = runner.resolve_cell(cfg, ShapeConfig("p", S, B, "prefill"),
                               overrides=dict(pp=1, dp=1, n_chunks=N, partition="length"),
                               dtype=torch.float32)
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    with torch.no_grad():
        state, last = runner.make_prefill_step(cell)(params, torch.from_numpy(ref["tokens"]))
    spp = -(-2 // LAYOUTS[name]["pp"])
    for r in _ranks(name):
        for i, (k, v, pos) in enumerate(r["prefill"]):
            j = r["stage"] * spp + i
            if j >= 2:
                continue
            kv = state[j]["kv"]
            assert np.array_equal(k, kv.k.numpy()), (name, r["stage"], i)
            assert np.array_equal(v, kv.v.numpy()), (name, r["stage"], i)
            assert np.array_equal(pos, kv.pos.numpy()), (name, r["stage"], i)
        if r["stage"] == LAYOUTS[name]["pp"] - 1:
            assert np.array_equal(r["prefill_last"], last.numpy())


@pytest.mark.parametrize("name", ["pp2", "dp2_pp2"])
def test_globals_identical_across_ranks_after_two_steps(name):
    """Every rank updates the globals it holds with the same summed
    gradients and the same global-norm clip: bitwise identical after two
    steps; the step-0 loss is the reference's."""
    ranks = _ranks(name)
    first = ranks[0]["globals_after"]
    for r in ranks:
        assert r["step_losses"] == ranks[0]["step_losses"]
        for (path, a), b in zip(tree.items(r["globals_after"]), tree.leaves(first)):
            assert np.array_equal(a, b), (name, r["rank"], path)
    np.testing.assert_allclose(ranks[0]["step_losses"][0], _jax_ref()["loss"], rtol=0, atol=TOL)
    assert ranks[0]["step_losses"][1] < ranks[0]["step_losses"][0]


@pytest.mark.parametrize("pp,n,msp,split", [(2, 4, False, 2), (2, 4, True, 2), (4, 4, True, 2),
                                            (4, 8, True, 4), (3, 6, True, 3)])
def test_tick_trace_matches_simulator_and_reference(pp, n, msp, split):
    cfg, jcfg = get_config("qwen2-7b").reduced(), jget_config("qwen2-7b").reduced()
    seq = 96 * n
    ov = dict(pp=pp, dp=1, n_chunks=n, msp=msp, msp_split=split, grad_accum=1)
    cell = runner.resolve_cell(cfg, ShapeConfig("t", seq, 1, "train"), overrides=ov,
                               data_size=pp)
    jcell = jrunner.resolve_cell(jbuild_model(jcfg), JShapeConfig("t", seq, 1, "train"),
                                 data_size=pp, model_size=1, overrides=ov)
    events = runner.pipeline_feed_events(cell.plan, cell.sched.n)
    assert tuple(events) == sim.simulate_schedule([1.0] * n, pp=pp, msp=msp,
                                                  split=split).feed_events
    trace = runner.pipeline_tick_trace(cell)
    assert trace == jrunner.pipeline_tick_trace(jcell)
    assert [tk["feed"] for tk in trace if tk["feed"]] == events
    assert [tk["drain"] for tk in trace if tk["drain"]] == events
    # every token's loss region drains exactly once
    cover = np.zeros(seq, int)
    clen = seq // n
    for c, sub, ns in events:
        cover[c * clen + sub * clen // ns:c * clen + (sub + 1) * clen // ns] += 1
    assert (cover == 1).all()


H100_REF = dataclasses.replace(jcm.V5E, name="h100", peak_flops_bf16=cm.H100.peak_flops_bf16,
                               hbm_bw=cm.H100.hbm_bw, d2h_bw=cm.H100.d2h_bw)


@pytest.mark.parametrize("reduced,seq,n,pp,dp,msp", [(True, 256, 4, 2, 1, False),
                                                     (True, 256, 4, 4, 1, True),
                                                     (True, 512, 4, 2, 2, False),
                                                     (False, 8192, 4, 2, 1, False),
                                                     (False, 8192, 4, 2, 1, True)])
def test_resolve_cell_at_pp_matches_reference(reduced, seq, n, pp, dp, msp):
    """Equal chunks and the reference's α (stage-aware parameter count,
    ``chunk_act_bytes(pp=)``) on the same hardware (a reference
    ``Hardware`` with the port's H100 numbers), at reduced width and at the
    chip cell's full width cut to 4 layers."""
    cfg, jcfg = get_config("qwen2-7b"), jget_config("qwen2-7b")
    cfg, jcfg = ((cfg.reduced(), jcfg.reduced()) if reduced else
                 (dataclasses.replace(cfg, n_layers=4), dataclasses.replace(jcfg, n_layers=4)))
    ov = dict(pp=pp, dp=dp, n_chunks=n, msp=msp, grad_accum=1)
    got = runner.resolve_cell(cfg, ShapeConfig("t", seq, 2, "train"), overrides=ov,
                              data_size=pp * dp)
    want = jrunner.resolve_cell(jbuild_model(jcfg), JShapeConfig("t", seq, 2, "train"),
                                data_size=pp * dp, model_size=1, overrides=ov, hw=H100_REF)
    assert got.sched.lengths == want.sched.lengths == (seq // n,) * n
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(want.plan)
    assert got.alphas == want.alphas
    assert got.b_loc == want.b_loc and got.data_size == want.data_size


@pytest.mark.parametrize("pp", [1, 2, 4])
def test_param_counts_match_reference(pp):
    """The reference's counts at pp stages over pp and 2 pp ranks (its
    data_size drops out)."""
    mdef, jmdef = build_model(get_config("qwen2-7b").reduced()), jbuild_model(
        jget_config("qwen2-7b").reduced())
    for data_size in (pp, 2 * pp):
        assert cm.count_params(mdef, pp) == jspecs.count_params(jmdef, pp, data_size)
        assert cm.count_active_params(mdef, pp) == jspecs.count_active_params(jmdef, pp,
                                                                             data_size)


def test_stage_init_draws_the_pp1_tensors_and_ghost_slots():
    """Stage s of pp holds the tensors pp = 1 draws for its layers from the
    same seed, the globals drawn after come out the same, and a stage past
    the last layer holds ghost slots (gate 0, zero weights)."""
    mdef = build_model(get_config("qwen2-7b").reduced())

    def draw(**kw):
        gen = torch.Generator().manual_seed(0)
        return (mdef.init_stage_params(gen, torch.float32, "cpu", **kw),
                mdef.init_globals(gen, torch.float32, "cpu"))

    full, g1 = draw()
    for pp in (2, 4):
        assert mdef.slots_per_stage(pp) == 1 and mdef.padded_slots(pp) == pp
        for s in range(pp):
            slots, g = draw(stage=s, pp=pp)
            assert len(slots) == 1
            assert all(torch.equal(a, b) for a, b in zip(tree.leaves(g), tree.leaves(g1)))
            if s < 2:
                assert all(torch.equal(a, b) for a, b in zip(tree.leaves(slots[0]),
                                                             tree.leaves(full[s])))
            else:
                assert float(slots[0]["gate"]) == 0.0
                assert all((t == 0).all() for t in tree.leaves(slots[0]))
    with pytest.raises(ValueError, match="stage 2 outside"):
        mdef.init_stage_params(torch.Generator(), device="meta", stage=2, pp=2)


def test_params_from_numpy_splits_stages_as_the_reference_builds_them():
    """Stage s of the converted pp = 1 stack equals the reference's own
    ``init_stage_params(rng, s, pp)`` on its real slots; ghost slots have
    gate 0 in both."""
    ref = _jax_ref()
    cfg = get_config("qwen2-7b").reduced()
    jmdef = jbuild_model(jget_config("qwen2-7b").reduced())
    for pp in (2, 4):
        for s in range(pp):
            got = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu",
                                    stage=s, pp=pp, cfg=cfg)["stages"]
            want = jmdef.init_stage_params(jax.random.PRNGKey(0), s, pp, jnp.float32)
            for i, slot in enumerate(got):
                wslot = _leaves_by_path(jax.tree_util.tree_map(
                    lambda a, i=i: np.asarray(a[i], np.float32), want))
                if s + i >= 2:
                    assert float(slot["gate"]) == 0.0 == wslot["gate"]
                    continue
                for path, t in tree.items(slot):
                    assert np.array_equal(t.numpy(), wslot[path]), (pp, s, path)
    with pytest.raises(ValueError, match="pass cfg"):
        params_from_numpy(ref["params"], dtype=torch.float32, device="cpu", stage=3, pp=4)


def test_what_the_multi_rank_slice_refuses():
    """What stays refused: chunks that do not tile S (at sp, their model
    shards too), MSP chunks that do not split, NCCL without a card per
    rank, a multi-rank context without a process group, an unknown
    attention schedule.  A model axis (tests/test_torch_model_axis.py) with
    the all-to-all of expert parallelism (since item 7's MoE part,
    tests/test_torch_moe.py), ring attention, ZeRO-1 over a pod axis
    (tests/test_torch_ring.py), packed rows at pp > 1, and, since item 5,
    prefill and decode at sp > 1 and decode at pp > 1
    (tests/test_torch_paged.py) resolve."""
    cfg = get_config("qwen2-7b").reduced()
    shape = ShapeConfig("t", 256, 2, "train")
    cell = runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1), model_size=2)
    assert cell.plan.sp == 2 and all(ln % 128 == 0 for ln in cell.sched.lengths)
    zero1 = runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1), pods=2)
    assert zero1.plan.zero1 and zero1.pods == 2 and zero1.b_loc == 1
    for kind in ("prefill", "decode"):
        served = runner.resolve_cell(cfg, ShapeConfig("p", 256, 2, kind),
                                     overrides=dict(pp=1, dp=1), model_size=2)
        assert served.plan.sp == 2 and served.cache_loc == 256 // 2 + runner.DECODE_BUDGET
    assert runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, attn_mode="ring"),
                               model_size=2).plan.attn_mode == "ring"
    decode_pp2 = runner.resolve_cell(cfg, ShapeConfig("d", 256, 2, "decode"),
                                     overrides=dict(pp=2, dp=1), data_size=2)
    assert decode_pp2.plan.pp == 2 and decode_pp2.sched.n == 1
    packed = runner.resolve_cell(cfg, shape, overrides=dict(pp=2, dp=1, n_chunks=2),
                                 doc_lens=[100, 156, 256], data_size=2)
    assert packed.varlen and packed.sched.lengths == (128, 128)
    with pytest.raises(ValueError, match="model shards"):
        runner.resolve_cell(cfg, ShapeConfig("t", 264, 2, "train"),
                            overrides=dict(pp=2, dp=1, n_chunks=4), data_size=2, model_size=4)
    with pytest.raises(ValueError, match="equal chunks"):
        runner.resolve_cell(cfg, ShapeConfig("t", 250, 2, "train"),
                            overrides=dict(pp=2, dp=1, n_chunks=4), data_size=2)
    with pytest.raises(ValueError, match="msp_split"):
        runner.resolve_cell(cfg, shape, overrides=dict(pp=2, dp=1, n_chunks=4, msp=True,
                                                       msp_split=3), data_size=2)
    with pytest.raises(RuntimeError, match="initialised process group"):
        ctx_mod.Ctx(sp=2, device="cpu", attn_mode="ring")
    with pytest.raises(ValueError, match="expected one of"):
        ctx_mod.Ctx(sp=2, device="cpu", attn_mode="striped")
    with pytest.raises(RuntimeError, match="initialised process group"):
        ctx_mod.Ctx(sp=2, device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        ctx_mod.Ctx(dp=2, device="cpu")
    with pytest.raises(RuntimeError, match="initialised process group"):
        ctx_mod.Ctx(dp=1, pp=2, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ctx_mod.check_backend("nccl", torch.device("cpu"), 2)
    with pytest.raises(RuntimeError, match="one CUDA device per rank"):
        ctx_mod.check_backend("nccl", torch.device("cuda"), torch.cuda.device_count() + 1)
    with pytest.raises(ValueError, match="expected one of"):
        ctx_mod.check_backend("mpi", torch.device("cpu"), 2)
    with pytest.raises(RuntimeError, match="one CUDA device per rank"):
        mesh.spawn(W.failing_rank, torch.cuda.device_count() + 1, backend="nccl",
                   device="cuda", args=(0,))
    assert mesh.parse_mesh("2x1") == (2, 1)
    assert mesh.parse_mesh("1x2") == (1, 2) and mesh.parse_mesh("2x2") == (2, 2)
    with pytest.raises(ValueError, match=">= 1"):
        mesh.parse_mesh("1x0")
    with pytest.raises(ValueError, match="DATAxMODEL"):
        mesh.parse_mesh("two")
    assert ctx_mod.SINGLE.psum_loss_all(torch.tensor(2.0)) == 2.0
    one = runner.make_ctx(runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1)).plan)
    assert one.stage_index() == 0 and not one.distributed
    # the entry points' default device is the card
    assert one.device.type == ctx_mod.SINGLE.device.type == "cuda"


def test_spawn_fails_a_run_whose_rank_fails_or_hangs():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        mesh.spawn(W.failing_rank, 2, device="cpu", args=(1,), timeout_s=120.0)
    with pytest.raises(RuntimeError, match="no result after"):
        mesh.spawn(W.hanging_rank, 2, device="cpu", timeout_s=8.0)


def test_cli_trains_pp2_and_msp_under_a_process_group():
    """``--mesh 2x1 --pp 2`` and ``--msp`` through the train CLI's ``main``
    on two ranks whose process group is up (as under torchrun): the ranks
    report the same losses, plain and MSP agree at step 0 (the same
    function of the parameters), and the loss falls."""
    base = ["--reduced", "--device", "cpu", "--mesh", "2x1", "--pp", "2", "--steps", "3",
            "--seq", "256", "--batch", "2", "--n-chunks", "4", "--log-every", "1"]
    ranks = mesh.spawn(W.cli_rank, 2, device="cpu", args=([base, base + ["--msp"]],),
                       timeout_s=DEADLINE_S)
    assert ranks[0] == ranks[1]
    plain, msp = ranks[0]
    assert all(np.isfinite(plain + msp))
    np.testing.assert_allclose(msp[0], plain[0], rtol=0, atol=TOL)
    assert plain[-1] < plain[0] and msp[-1] < msp[0]
