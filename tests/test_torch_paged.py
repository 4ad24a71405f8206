"""The port's serving at sp > 1 and pp > 1 and its paged continuous-batching
engine against the JAX reference, on the CPU.  Mirrors tests/test_serving.py.

The reduced qwen2-7b at fp32, parameters built once by JAX (PRNGKey 0) and
carried across as numpy (``convert.params_from_numpy``).  The multi-rank
cases run in one spawn of two CPU ranks over gloo
(``tests/_torch_paged_workers.py``, no JAX), every job of it on the same
process group; the reference runs first, in this process, on fake CPU
devices (``make_test_mesh``).  What is held, and how:

- static serving at sp = 2 (mesh 1 x 2): each rank's prefill caches under
  gather_q, gather_kv and the ring (S = 256 in two chunks) within 1e-5 of
  the reference's, their positions exact, the decoded tokens exact and the
  caches after decoding within 1e-5 (the reference's shard_map claims its
  cache replicated over the model axis while each device keeps its own
  shard: its per-device buffers are read through ``addressable_shards``);
- decode at pp = 2 (mesh 2 x 1, four rows in two microbatches): the tokens
  exact, each stage's cache within 1e-5, the hand-offs by the closed form;
- the cache contract (prefill(S) + one decode step == prefill(S + 1), bit
  for bit) at pp = 1 and pp = 2;
- the engine at the reference's own geometry (mesh 1 x 2, ``s_bucket`` 32,
  2 slots, ``max_new`` 4, ``block_tokens`` 4) against the reference's engine
  run in fp32: every request's tokens exact, the position map exact, the
  run's steps, waves, spans and block counts equal; continuous == static ==
  solo bitwise; blocks recycled; the pool's bytes at the closed form;
- the engine at mesh 2 x 1 against the engine on one device, and the serve
  CLI's ``--mesh`` / ``--pp`` / ``--continuous`` under two ranks;
- ``runtime/kvpool.py`` against the reference's module on drawn
  geometries, bitwise; the sink: a pool write from an inactive row, a rank
  that does not own the token, a row outside an admission or past its
  blocks changes no other slot.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import NamedSharding

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.launch import serve as jserve
from repro.launch.mesh import make_test_mesh
from repro.launch.train import build_params as jbuild_params
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel import runner as jrunner
from repro.runtime import kvpool as jkvpool
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import mesh, serve
from repro_torch.models import attention as A
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import ModelDef, build_model
from repro_torch.parallel import runner
from repro_torch.runtime import kvpool

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)
import _torch_paged_workers as W  # noqa: E402

ARCH = "qwen2-7b"
# caches against the reference: fp32, the reference's own bar for the
# serving caches (tests/test_pipeline_equivalence.py, tests/test_torch_serve.py);
# the two frameworks' fp32 differ by up to 3.5e-6 here (2e-6 already at
# layer 0's keys, |k| <= 3.4), so 1e-6 is out of reach
TOL = 1e-5
DEADLINE_S = 400.0
S_SP, B_SP, STEPS = 256, 2, 4              # static sp = 2: two chunks of 128
S_PP, B_PP, M_PP = 64, 4, 2                # static pp = 2: two microbatches of two rows
S_CONTRACT = 63                            # tests/test_serving.py's cache contract
MODES = ("gather_q", "gather_kv", "ring")
ENGINE = dict(s_bucket=32, slots=2, max_new=4, block_tokens=4, admit_min_free=1)
TRACE_SEEDS = (0, 1, 2)
CLI = ["--reduced", "--device", "cpu", "--prompt-len", "128", "--decode-steps", "3"]


def _to_np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


@functools.lru_cache(maxsize=None)
def _np_params():
    """The reduced model's fp32 parameters at pp = 1, as the reference's
    ``build_params`` draws them for every layout (PRNGKey 0)."""
    mdef = jbuild_model(jget_config(ARCH).reduced())
    key = jax.random.PRNGKey(0)
    return _to_np({"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
                   "globals": mdef.init_globals(key, jnp.float32)})


def _prompts(B, S, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(2, get_config(ARCH).reduced().vocab_size, size=(B, S)).astype(np.int32)


def _jcells(S, B, data, model, pp, n_chunks, plan=(), dec_plan=()):
    mdef = jbuild_model(jget_config(ARCH).reduced())
    kw = dict(data_size=data, model_size=model)
    pre = jrunner.resolve_cell(mdef, JShapeConfig("p", S, B, "prefill"), overrides=dict(
        pp=pp, dp=data // pp, n_chunks=n_chunks, offload=False, remat="none", **dict(plan)),
        **kw)
    dec = jrunner.resolve_cell(mdef, JShapeConfig("d", S, B, "decode"),
                               overrides=dict(pp=pp, dp=data // pp, **dict(dec_plan)), **kw)
    return (dataclasses.replace(pre, dtype=jnp.float32),
            dataclasses.replace(dec, dtype=jnp.float32))


def _per_device(state, jmesh):
    """{name: [device-ordered per-device arrays]} of a serving state: the
    reference's cache is declared replicated over the model axis while each
    device holds its own shard (or, at pp > 1, its own stage)."""
    order = {d: i for i, d in enumerate(jmesh.devices.flat)}
    out = {}
    for name in ("k", "v", "pos"):
        shards = getattr(state["kv"], name).addressable_shards
        by_dev = sorted(shards, key=lambda s: order[s.device])
        out[name] = [np.asarray(s.data)[0] for s in by_dev]
    return out


@functools.lru_cache(maxsize=None)
def _jax_static(data, model, pp, S, B, n_chunks, mode=None, micro=None, steps=STEPS):
    """The reference's static serving on a data x model mesh of fake CPU
    devices: each device's prefill caches, the tokens, each device's caches
    after ``steps`` decode steps."""
    plan = () if mode is None else (("attn_mode", mode),)
    dec_plan = () if micro is None else (("decode_microbatch", micro),)
    pre, dec = _jcells(S, B, data, model, pp, n_chunks, plan, dec_plan)
    jmesh = make_test_mesh(data, model)
    params, _, _ = jbuild_params(pre, jmesh)
    prompts = _prompts(B, S)
    fn, _, _ = jrunner.make_prefill_step(pre, jmesh)
    _, bspecs = jrunner.batch_struct(pre)
    tok = jnp.asarray(jserve.shard_rows(prompts, pre.plan.dp, pp))
    # transfer-lint: ok (test input staging onto the mesh)
    batch = {k: jax.device_put(v, NamedSharding(jmesh, bspecs[k]))
             for k, v in {"tokens": tok, "labels": tok}.items()}
    state, _ = jax.jit(fn)(params, batch)
    prefill = _per_device(state, jmesh)
    step, _, _ = jrunner.make_serve_step(dec, jmesh, decode_steps=steps)
    step = jax.jit(step)
    cur = jnp.asarray(jserve.shard_rows(prompts[:, -1:], dec.plan.dp, pp))
    toks = []
    for i in range(steps):
        state, nxt = step(params, state, {"tokens": cur, "pos": jnp.int32(S + i)})
        cur = nxt[None]
        toks.append(jserve.gather_decode_tokens(np.asarray(nxt), dec.plan.dp, pp, B))
    return dict(prefill=prefill, tokens=np.stack(toks, axis=1),
                decoded=_per_device(state, jmesh), chunks=pre.sched.lengths,
                microbatch=dec.plan.decode_microbatch)


def _trace(seed, n=5):
    """tests/test_serving.py::_trace at the engine's geometry, as dicts."""
    rng = np.random.default_rng(seed)
    vocab = get_config(ARCH).reduced().vocab_size
    reqs = []
    for i in range(n):
        plen = int(rng.integers(4, ENGINE["s_bucket"] + 1))
        reqs.append(dict(rid=i, prompt=rng.integers(2, vocab, size=plen).astype(np.int32),
                         max_new=int(rng.integers(1, ENGINE["max_new"] + 1)),
                         arrival=int(rng.integers(0, 5))))
    return reqs


def _recycle_trace():
    """tests/test_serving.py::test_pool_blocks_recycled's trace."""
    rng = np.random.default_rng(3)
    vocab = get_config(ARCH).reduced().vocab_size
    return [dict(rid=i, prompt=rng.integers(2, vocab, size=8).astype(np.int32), max_new=4,
                 arrival=i) for i in range(8)]


TRACES = [_trace(s) for s in TRACE_SEEDS] + [_recycle_trace()]


@functools.lru_cache(maxsize=None)
def _jax_engine():
    """The reference's ServeEngine at mesh 1 x 2 in fp32: its cells, params
    and step functions rebuilt at fp32 as its constructor builds them, then
    every trace run continuously."""
    jmesh = make_test_mesh(1, 2)
    eng = jserve.ServeEngine(ARCH, jmesh, reduced=True, **ENGINE)
    eng.pre_cell = dataclasses.replace(eng.pre_cell, dtype=jnp.float32)
    eng.dec_cell = dataclasses.replace(eng.dec_cell, dtype=jnp.float32)
    eng.params, _, _ = jbuild_params(eng.pre_cell, jmesh)
    eng._prefill = jax.jit(jrunner.make_prefill_step(eng.pre_cell, jmesh)[0])
    eng._ingest = jax.jit(jrunner.make_pool_ingest(eng.pre_cell, eng.geo, jmesh),
                          donate_argnums=(1,))
    eng._step = jax.jit(jrunner.make_pool_serve_step(eng.dec_cell, eng.geo, jmesh,
                                                     eng.pos_map), donate_argnums=(1,))
    runs = [eng.run([jserve.Request(**r) for r in trace], mode="continuous")
            for trace in TRACES]
    return dict(pos_map=eng.pos_map, runs=runs, pool_bytes=eng.predicted_pool_bytes())


def _jobs():
    P = _np_params()
    jobs = [dict(kind="static", name=f"sp2_{mode}", arch=ARCH, params=P,
                 prompts=_prompts(B_SP, S_SP), steps=STEPS,
                 layout=dict(sp=2, n_chunks=2, plan=dict(attn_mode=mode))) for mode in MODES]
    jobs += [dict(kind="static", name="pp2", arch=ARCH, params=P, prompts=_prompts(B_PP, S_PP),
                  steps=STEPS, layout=dict(pp=2, dec_plan=dict(decode_microbatch=M_PP))),
             dict(kind="contract", name="contract_pp2", arch=ARCH, params=P,
                  prompts=_prompts(2, S_CONTRACT), layout=dict(pp=2)),
             dict(kind="engine", name="engine_1x2", arch=ARCH, params=P, layout=dict(sp=2),
                  engine=ENGINE, traces=TRACES, modes=("continuous", "static"), solo=True),
             dict(kind="engine", name="engine_2x1", arch=ARCH, params=P, layout=dict(dp=2),
                  engine=ENGINE, traces=TRACES, modes=("continuous",)),
             dict(kind="cli", name="cli", argv={
                 "static_1x2": CLI + ["--mesh", "1x2", "--batch", "2"],
                 "continuous_1x2": CLI + ["--mesh", "1x2", "--batch", "2", "--continuous"],
                 "static_2x1_pp2": CLI + ["--mesh", "2x1", "--pp", "2", "--batch", "4"]})]
    return jobs


@functools.lru_cache(maxsize=1)
def _ranks():
    """Every multi-rank job in one spawn of two CPU ranks."""
    return mesh.spawn(W.serve_rank, 2, backend="gloo", device="cpu", args=(_jobs(),),
                      timeout_s=DEADLINE_S)


# ---------------------------------------------------------------------------
# tests/test_serving.py's cases
# ---------------------------------------------------------------------------


def _decode_cell(model_size=1, seq=64, batch=2, **overrides):
    cfg = get_config(ARCH).reduced()
    return runner.resolve_cell(cfg, ShapeConfig("t_dec", seq, batch, "decode"),
                               data_size=1, model_size=model_size,
                               overrides=dict(pp=1, dp=1, **overrides))


def test_decode_budget_guard():
    """At sp = 2 the striped cache absorbs DECODE_BUDGET x 2 steps; a longer
    run is refused when the step is built, one at the budget is not."""
    cell = _decode_cell(model_size=2)
    assert runner.max_decode_steps(cell) == runner.DECODE_BUDGET * cell.plan.sp == 256
    with pytest.raises(ValueError, match="decode budget"):
        runner.make_serve_step(cell, decode_steps=runner.max_decode_steps(cell) + 1)
    runner.make_serve_step(cell, decode_steps=runner.max_decode_steps(cell))


def _contract_caches(pp):
    """(decoded, longer) caches of the cache contract: at pp = 1 in this
    process, at pp = 2 each rank's from the spawn."""
    if pp == 2:
        return [(r["contract_pp2"]["decoded"], r["contract_pp2"]["longer"]) for r in _ranks()]
    job = dict(arch=ARCH, params=_np_params(), prompts=_prompts(2, S_CONTRACT), layout={})
    cfg = get_config(ARCH).reduced()
    pre_s, dec = W._cells(job, cfg, S_CONTRACT, 2)
    pre_s1, _ = W._cells(job, cfg, S_CONTRACT + 1, 2)
    params = params_from_numpy(_np_params(), dtype=torch.float32, device="cpu")
    prompts = job["prompts"]
    state, _ = runner.make_prefill_step(pre_s)(params, torch.from_numpy(prompts))
    state, _ = runner.make_serve_step(dec)(params, state, torch.from_numpy(prompts[:, -1:]),
                                           S_CONTRACT)
    ext = np.concatenate([prompts, prompts[:, -1:]], axis=1)
    longer, _ = runner.make_prefill_step(pre_s1)(params, torch.from_numpy(ext))
    return [(W._caches(state), W._caches(longer))]


@pytest.mark.parametrize("pp", [1, 2])
def test_prefill_decode_cache_contract(pp):
    """A cache built by prefill(S) plus one decode step of the last prompt
    token equals prefill(S + 1) of the prompt with that token appended, bit
    for bit over the written extent, on every pipeline stage."""
    for decoded, longer in _contract_caches(pp):
        for name in ("k", "v", "pos"):
            ax = 2 if name != "pos" else 1     # [slot, B, S_loc, ...] and [slot, S_loc]
            idx = np.arange(S_CONTRACT + 1)
            np.testing.assert_array_equal(np.take(decoded[name], idx, axis=ax),
                                          np.take(longer[name], idx, axis=ax),
                                          err_msg=f"cache {name} (pp={pp})")


@functools.lru_cache(maxsize=1)
def _one_device():
    """The engine at mesh 1 x 1, in this process."""
    cfg = get_config(ARCH).reduced()
    params = params_from_numpy(_np_params(), dtype=torch.float32, device="cpu")
    return serve.ServeEngine(cfg, device="cpu", dtype=torch.float32, params=params, **ENGINE)


@given(st.integers(0, 10_000))
@settings(max_examples=3, deadline=None)
def test_continuous_equals_static_and_solo(seed):
    """Per-request token streams are bitwise identical whether a request is
    decoded continuously, in lock-step waves, or entirely alone (one
    device; the 1 x 2 engine holds the same in
    test_engine_matches_the_reference_at_mesh_1x2)."""
    eng = _one_device()
    reqs = [serve.Request(**r) for r in _trace(seed)]
    cont, _ = eng.run(reqs, mode="continuous")
    stat, _ = eng.run(reqs, mode="static")
    for r in reqs:
        np.testing.assert_array_equal(cont[r.rid], stat[r.rid], err_msg=f"rid {r.rid}")
        solo, _ = eng.run([serve.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)],
                          mode="static")
        np.testing.assert_array_equal(cont[r.rid], solo[r.rid], err_msg=f"rid {r.rid} solo")


def test_pool_blocks_recycled():
    """Over a trace longer than the pool, lifetime allocations exceed the
    physical block count while the peak stays within the analytic
    concurrency bound (the 1 x 2 engine, both ranks)."""
    geo = _one_device().geo
    for r in _ranks():
        res = r["engine_1x2"]["traces"][-1]["continuous"]
        stats, toks = res["stats"], res["tokens"]
        bound = kvpool.concurrent_peak(
            [(s, e, geo.blocks_for(4)) for (s, e) in stats.spans.values()])
        assert stats.peak_blocks[0] <= bound <= geo.n_blocks
        assert stats.total_blocks[0] > geo.n_blocks, "trace too short to prove recycling"
        assert all(len(toks[q["rid"]]) == q["max_new"] for q in _recycle_trace())


def test_block_pool_allocator_invariants():
    pool = kvpool.BlockPool(4)
    a = pool.alloc(3)
    assert pool.used == 3 and pool.free_blocks == 1
    with pytest.raises(MemoryError):
        pool.alloc(2)
    pool.free(a[:2])
    b = pool.alloc(2)
    assert set(b) <= set(range(4))
    assert pool.peak_used == 3
    assert pool.total_allocated == 5


def test_concurrent_peak_sweep():
    # [0,4)x2, [2,6)x3, [6,8)x4 -> peak 5 inside [2,4)
    assert kvpool.concurrent_peak([(0, 4, 2), (2, 6, 3), (6, 8, 4)]) == 5
    assert kvpool.concurrent_peak([]) == 0


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


def _by_rank(key):
    return sorted((r[key] for r in _ranks()), key=lambda x: x["rank"])


@pytest.mark.parametrize("mode", MODES)
def test_prefill_sp2_matches_jax(mode):
    """Each model rank's prefill cache (chunk-contiguous shards of two
    chunks) under the mode's attention schedule against the reference's
    device of that model index."""
    ref = _jax_static(1, 2, 1, S_SP, B_SP, 2, mode)
    got = _by_rank(f"sp2_{mode}")
    assert got[0]["chunks"] == ref["chunks"] == (128, 128)
    for m, r in enumerate(got):
        assert r["model"] == m
        np.testing.assert_array_equal(r["prefill"]["pos"], ref["prefill"]["pos"][m])
        for name in ("k", "v"):
            np.testing.assert_allclose(r["prefill"][name], ref["prefill"][name][m],
                                       rtol=0, atol=TOL, err_msg=f"{mode} rank {m} {name}")


def test_decode_sp2_matches_jax():
    """Decode at sp = 2: the tokens exact on both ranks, each rank's cache
    after the striped writes (positions exact, k and v within 1e-5), and
    the model collectives a step by the closed form (per layer a max and two
    sums of the merge, a gather of each of the 7 "ag" weight leaves; the
    embedding's sum, the logits' gather)."""
    ref = _jax_static(1, 2, 1, S_SP, B_SP, 2, "gather_q")
    n_layers = get_config(ARCH).reduced().n_layers
    for m, r in enumerate(_by_rank("sp2_gather_q")):
        np.testing.assert_array_equal(r["tokens"], ref["tokens"])
        np.testing.assert_array_equal(r["decoded"]["pos"], ref["decoded"]["pos"][m])
        for name in ("k", "v"):
            np.testing.assert_allclose(r["decoded"][name], ref["decoded"][name][m],
                                       rtol=0, atol=TOL, err_msg=f"rank {m} {name}")
        c = r["counts"]
        assert c["model_pmax_calls"] == STEPS * n_layers, c
        assert c["model_psum_calls"] == STEPS * (2 * n_layers + 1), c
        assert c["model_all_gather_calls"] == STEPS * (7 * n_layers + 1), c
        assert c["model_reduce_scatter_calls"] == 0 and c["handoffs"] == 0, c


def test_decode_pp2_matches_jax():
    """Decode at pp = 2 (four rows in two microbatches): both stages return
    the reference's tokens, and each stage's cache after decoding is the
    reference's stage's; each stage posts M hand-offs a step (stage 0 sends,
    stage 1 receives one microbatch's carry each)."""
    ref = _jax_static(2, 1, 2, S_PP, B_PP, 1, micro=M_PP)
    ranks = _by_rank("pp2")
    assert ranks[0]["microbatch"] == ref["microbatch"] == M_PP
    d = get_config(ARCH).reduced().d_model
    for r in ranks:
        np.testing.assert_array_equal(r["tokens"], ref["tokens"], err_msg=f"stage {r['stage']}")
        assert r["counts"]["handoffs"] == STEPS * M_PP
        sent = STEPS * M_PP * (B_PP // M_PP) * d * 4 if r["stage"] == 0 else 0
        assert r["counts"]["handoff_bytes"] == sent
    for name in ("k", "v"):
        for r in ranks:
            np.testing.assert_allclose(r["decoded"][name], ref["decoded"][name][r["stage"]],
                                       rtol=0, atol=TOL, err_msg=f"stage {r['stage']} {name}")


@pytest.mark.parametrize("trace", range(len(TRACES)))
def test_engine_matches_the_reference_at_mesh_1x2(trace):
    """The engine at the reference's own geometry: every request's tokens
    and the run's schedule as the reference's fp32 engine runs them, the
    position map exact, continuous == static == solo bitwise on both ranks,
    the pool's bytes at the closed form (blocks and sink)."""
    ref = _jax_engine()
    want_toks, want_stats = ref["runs"][trace]
    for r in _by_rank("engine_1x2"):
        np.testing.assert_array_equal(r["pos_map"], ref["pos_map"])
        res = r["traces"][trace]
        got = res["continuous"]
        for rid, toks in want_toks.items():
            np.testing.assert_array_equal(got["tokens"][rid], toks, err_msg=f"rid {rid}")
            np.testing.assert_array_equal(res["static"]["tokens"][rid], toks)
            np.testing.assert_array_equal(res["solo"][rid], toks)
        for f in ("steps", "waves", "spans", "peak_blocks", "total_blocks"):
            assert getattr(got["stats"], f) == getattr(want_stats, f), f
        cfg = get_config(ARCH).reduced()
        assert got["stats"].pool_bytes == r["pool_bytes_closed_form"] == (
            ref["pool_bytes"] + kvpool.sink_bytes(cfg, cfg.n_layers, 4))


@pytest.mark.parametrize("trace", range(len(TRACES)))
def test_engine_dp2_equals_one_device(trace):
    """At mesh 2 x 1 each rank serves its data shard's slots and gathers
    every shard's tokens at the end: each request decodes as on one
    device."""
    eng = _one_device()
    want, _ = eng.run([serve.Request(**q) for q in TRACES[trace]], mode="continuous")
    for r in _by_rank("engine_2x1"):
        got = r["traces"][trace]["continuous"]
        assert got["stats"].peak_blocks and len(got["stats"].peak_blocks) == 2
        for rid, toks in want.items():
            np.testing.assert_array_equal(got["tokens"][rid], toks, err_msg=f"rid {rid}")
        assert r["counts"]["data_all_gather_calls"] == len(TRACES)


def test_serve_cli_mesh_and_continuous():
    """The serve CLI under two ranks: ``--mesh 1x2`` static and continuous
    decode the same tokens (the engine's pool holds the static cache's slots
    in the same order), ``--mesh 2x1 --pp 2`` decodes every request, every
    rank returns every request's tokens."""
    vocab = get_config(ARCH).reduced().vocab_size
    outs = [r["cli"] for r in _ranks()]
    for o in outs:
        np.testing.assert_array_equal(o["static_1x2"]["tokens"], o["continuous_1x2"]["tokens"])
        assert o["static_1x2"]["tokens"].shape == (2, 3)
        toks = o["static_2x1_pp2"]["tokens"]
        assert toks.shape == (4, 3) and ((toks >= 0) & (toks < vocab)).all()
        assert o["continuous_1x2"]["stats"][0].steps == 3
    for name in ("static_1x2", "continuous_1x2", "static_2x1_pp2"):
        np.testing.assert_array_equal(outs[0][name]["tokens"], outs[1][name]["tokens"])


def test_what_the_engine_refuses():
    """The reference's limits of the paged pool, raised as ValueError: pp >
    1, more than one pod, a family other than dense GQA, a geometry of
    another sp or slot count; the CLI refuses ``--continuous`` at pp > 1;
    the engine's default device is the card."""
    cfg = get_config(ARCH).reduced()
    geo = kvpool.PoolGeometry(s_bucket=32, sp=1, max_new=4, block_tokens=4, n_blocks=8,
                              n_slots=2)
    ok = _decode_cell(seq=32)
    runner.check_pool_cell(ok, geo)
    for cell, what in (
            (runner.resolve_cell(cfg, ShapeConfig("d", 32, 2, "decode"), data_size=2,
                                 overrides=dict(pp=2, dp=1)), "pp = 1"),
            (runner.resolve_cell(cfg, ShapeConfig("d", 32, 4, "decode"), pods=2,
                                 overrides=dict(pp=1, dp=1)), "single-pod"),
            (dataclasses.replace(ok, mdef=ModelDef(dataclasses.replace(cfg, family="moe"), 2)),
             "dense GQA"),
            (_decode_cell(model_size=2, seq=32), "sp"),
            (_decode_cell(seq=32, batch=3), "slots")):
        with pytest.raises(ValueError, match=what):
            runner.make_pool_state(cell, geo, device="cpu")
    with pytest.raises(ValueError, match="pp = 1"):
        serve.main(CLI + ["--batch", "2", "--continuous", "--mesh", "2x1", "--pp", "2"])
    # asked for no device, the engine targets the card, and fails with none
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.ServeEngine(cfg, **ENGINE)


# ---------------------------------------------------------------------------
# the pool: kvpool against the reference, the sink
# ---------------------------------------------------------------------------


class _Sched:
    def __init__(self, lengths):
        self.lengths = tuple(lengths)
        self.offsets = tuple(int(x) for x in np.cumsum((0,) + self.lengths[:-1]))


@given(st.sampled_from([1, 2, 4]), st.integers(1, 5), st.integers(1, 40), st.integers(1, 9),
       st.integers(1, 6), st.integers(0, 10_000))
@settings(max_examples=40, deadline=None)
def test_kvpool_matches_the_reference(sp, n_chunks, max_new, block_tokens, n_slots, seed):
    """Geometry, position map, block-table rows, the allocator under a
    random alloc/free sequence and the concurrency sweep: bitwise the
    reference's on drawn geometries."""
    rng = np.random.default_rng(seed)
    lengths = [sp * int(rng.integers(1, 9)) for _ in range(n_chunks)]
    s_bucket = sum(lengths)
    n_blocks = int(rng.integers(1, 40))
    kw = dict(s_bucket=s_bucket, sp=sp, max_new=max_new, block_tokens=block_tokens,
              n_blocks=n_blocks, n_slots=n_slots)
    geo, jgeo = kvpool.PoolGeometry(**kw), jkvpool.PoolGeometry(**kw)
    for f in ("base", "dec_loc", "l_loc", "max_blocks", "p_loc"):
        assert getattr(geo, f) == getattr(jgeo, f), f
    for m in range(1, max_new + 1):
        assert geo.blocks_for(m) == jgeo.blocks_for(m)
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    for n_layers, itemsize in ((1, 2), (28, 2), (3, 4)):
        assert geo.pool_bytes(cfg, n_layers, itemsize) == jgeo.pool_bytes(jcfg, n_layers,
                                                                           itemsize)
    got, want = kvpool.pos_map(geo, _Sched(lengths)), jkvpool.pos_map(jgeo, _Sched(lengths))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    blocks = list(rng.permutation(n_blocks)[:int(rng.integers(0, geo.max_blocks + 1))])
    assert np.array_equal(kvpool.block_table_row(geo, blocks),
                          jkvpool.block_table_row(jgeo, blocks))
    pools, held = (kvpool.BlockPool(n_blocks), jkvpool.BlockPool(n_blocks)), ([], [])
    for _ in range(20):
        if held[0] and rng.random() < 0.4:
            i = int(rng.integers(0, len(held[0])))
            for p, h in zip(pools, held):
                p.free(h.pop(i))
            continue
        n = int(rng.integers(1, 6))
        outs = []
        for p, h in zip(pools, held):
            try:
                h.append(p.alloc(n))
                outs.append(h[-1])
            except MemoryError:
                outs.append(None)
        assert outs[0] == outs[1]
        for f in ("used", "free_blocks", "peak_used", "total_allocated"):
            assert getattr(pools[0], f) == getattr(pools[1], f), f
    iv = [(int(a), int(a + rng.integers(1, 9)), int(rng.integers(1, 5)))
          for a in rng.integers(0, 20, size=int(rng.integers(0, 12)))]
    assert kvpool.concurrent_peak(iv) == jkvpool.concurrent_peak(iv)
    bad = {**kw, "s_bucket": s_bucket + 1} if sp > 1 else {**kw, "max_new": 0}
    for module in (kvpool, jkvpool):
        with pytest.raises(AssertionError):
            module.PoolGeometry(**bad)


def _changed_slots(before, after):
    return sorted(set(np.nonzero((before != after).reshape(before.shape[0], -1).any(1))[0]))


def test_pool_writes_outside_their_slot_land_in_the_sink():
    """The paged step's write on model rank 1 of 2: of three rows, one
    active and owning its token (its striped slot through its block table),
    one active but owned by rank 0 and one inactive (q_pos 0) -- only the
    first row's slot and the sink change.  The ingest of an admission wave
    with one row outside ``admit`` and one row's blocks ending early: only
    the admitted rows' allocated slots and the sink change.  Every other
    slot keeps its bits, and no gather reads the sink."""
    cfg = get_config(ARCH).reduced()
    mdef = build_model(cfg)
    geo = kvpool.PoolGeometry(s_bucket=8, sp=2, max_new=4, block_tokens=2, n_blocks=9,
                              n_slots=3)
    gen = torch.Generator().manual_seed(0)
    pool = mdef.init_pool(geo, torch.float32, "cpu", n_slots=1)[0]["kv"]
    for t in pool:
        t.copy_(torch.randn(t.shape, generator=gen))
    assert pool.k.shape[0] == geo.p_loc + kvpool.SINK_SLOTS
    btab = torch.tensor([[0, 1, 2], [3, 4, 5], [6, -1, -1]], dtype=torch.int32)
    pos_map = torch.from_numpy(kvpool.pos_map(geo, _Sched([8]))[1])
    # decode indices 1 (rank 1's), 2 (rank 0's) and an inactive row
    q_pos = torch.tensor([geo.s_bucket + 1, geo.s_bucket + 2, 0], dtype=torch.int32)
    pg = A.paged_meta(q_pos, btab, pos_map, base=geo.base, s_bucket=geo.s_bucket,
                      block_tokens=geo.block_tokens, sp=2, rank=1, p_loc=geo.p_loc)
    own = 2 * geo.block_tokens + 0               # row 0: logical slot base + 0, its block 2
    assert pg.write.tolist() == [own, geo.p_loc, geo.p_loc]
    assert int(pg.gather.max()) < geo.p_loc
    params = params_from_numpy(_np_params(), dtype=torch.float32, device="cpu")
    x = torch.randn((3, 1, cfg.d_model), generator=gen)
    rope = runner._rope(cfg, pg.q_pos[:, None])
    before = [t.clone() for t in pool]
    A.gqa_paged_decode_attention(x, params["stages"][0]["attn"], cfg, pool, pg, rope)
    for b, a in zip(before, pool):
        assert _changed_slots(b.numpy(), a.numpy()) == [own, geo.p_loc]
    # the ingest of a wave: rows 0 and 2 admitted, row 2's second block unallocated
    pre = runner.resolve_cell(cfg, ShapeConfig("p", 8, 3, "prefill"), model_size=2,
                              overrides=dict(pp=1, dp=1, n_chunks=1, offload=False,
                                             remat="none"), dtype=torch.float32)
    state = mdef.init_state(3, pre.cache_loc, torch.float32, "cpu", n_slots=1)
    for t in (state[0]["kv"].k, state[0]["kv"].v):
        t.copy_(torch.randn(t.shape, generator=gen))
    before = [t.clone() for t in pool]
    runner.make_pool_ingest(pre, geo)(state, [{"kv": pool}], btab,
                                      torch.tensor([True, False, True]))
    written = [0, 1, 2, 3, 12, 13, geo.p_loc]    # row 0's blocks 0, 1, row 2's 6, the sink
    for b, a, c in zip(before, pool, (state[0]["kv"].k, state[0]["kv"].v)):
        assert _changed_slots(b.numpy(), a.numpy()) == written
        assert torch.equal(a[:4], c[0, :4]) and torch.equal(a[12:14], c[2, :2])
