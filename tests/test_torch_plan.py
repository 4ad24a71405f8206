"""SPPO's planning math in the port against the JAX reference, on the CPU
(DESIGN.md §3), and the three dense configs that came with it.

- ``core/schedule.py``, ``core/simulate.py`` and ``core/solver.py`` are
  copies (plain Python), held identical to the reference's on the cases of
  tests/test_sppo_core.py and tests/test_simulator.py: every field of every
  result, the lane trace event for event.
- The ten golden traces of tests/golden/ come out byte-identical through the
  port's ``solver.simulate_candidate``.  They were written for the
  reference's TPU numbers, which the port does not hold: the test builds a
  port ``Hardware`` from the reference's ``V5E`` fields.
- The rest of ``core/costmodel.py``: the attention FLOPs and bytes, the KV
  and ring bytes, ``stage_attn_demand``, ``chunk_time_est``, equal.
- ``glm4-9b`` (partial RoPE, G = 16 at full width), ``nemotron-4-15b``
  (squared ReLU, LayerNorm) and ``starcoder2-3b`` (GeLU with MLP bias):
  the reduced model's loss and every gradient at 1e-5 against
  ``jax.value_and_grad`` of the reference's ``run_pipeline``, fp32, as
  tests/test_torch_train.py holds qwen2-7b.
"""
import dataclasses
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.core import costmodel as jcm
from repro.core import schedule as jsched
from repro.core import simulate as jsim
from repro.core import solver as jsolver
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel import runner as jrunner
from repro.parallel.ctx import SINGLE
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import schedule as sched
from repro_torch.core import simulate as sim
from repro_torch.core import solver
from repro_torch.core import tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import runner

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmarks import golden_traces as gt  # noqa: E402

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

TOL = 1e-5
V5E = cm.Hardware(**dataclasses.asdict(jcm.V5E))


def _plain(x):
    """A result as nested tuples of plain values (dataclasses unpacked), so
    the two packages' classes compare field by field."""
    if dataclasses.is_dataclass(x):
        return tuple(_plain(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, set):
        return frozenset(x)
    return x


# ---------------------------------------------------------------------------
# schedule.py: the closed forms and the phase tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pp,n,split", [(4, 16, 2), (4, 8, 2), (2, 4, 3), (8, 64, 4),
                                        (1, 5, 2), (3, 9, 2)])
def test_schedule_closed_forms_and_phase_tables_match_reference(pp, n, split):
    assert sched.bubble_ratio(pp, n) == jsched.bubble_ratio(pp, n)
    for f in (1.0, 3.7):
        assert sched.total_time(pp, n, f) == jsched.total_time(pp, n, f)
        assert sched.msp_total_time(pp, n, f, split) == jsched.msp_total_time(pp, n, f, split)
    assert sched.ticks(n, pp) == jsched.ticks(n, pp)
    assert [sched.chunk_at(t, s, n) for t in range(n + pp) for s in range(pp)] == \
        [jsched.chunk_at(t, s, n) for t in range(n + pp) for s in range(pp)]
    assert sched.msp_ramp_schedule(n, pp, split) == jsched.msp_ramp_schedule(n, pp, split)
    if n >= pp:
        assert _plain(sched.msp_phase_table(pp, n)) == _plain(jsched.msp_phase_table(pp, n))
        for s in range(pp):
            for phase in ("left", "steady", "right"):
                assert sched.comm_scope(pp, s, phase) == jsched.comm_scope(pp, s, phase)


# ---------------------------------------------------------------------------
# simulate.py on the cases of tests/test_simulator.py
# ---------------------------------------------------------------------------

ACTS, TIMES = [5.0, 4.0, 3.0, 2.0], [1.0] * 4
SIM_CASES = {
    "uniform_pp4": (dict(chunk_costs=[0.7] * 16, pp=4), {}),
    "pp1_arbitrary": (dict(chunk_costs=[0.3, 1.7, 2.0, 0.5], pp=1), {}),
    "imbalanced_pp2": (dict(chunk_costs=[0.1, 0.1, 4.0, 4.0], pp=2), {}),
    "msp_pp3_split3": (dict(chunk_costs=[1.3] * 12, pp=3, msp=True, split=3), {}),
    "unhidden_d2h": (dict(chunk_costs=TIMES, pp=1, chunk_acts=ACTS,
                          alphas=[1.0, 1.0, 1.0, 0.0], d2h_bw=0.5), {}),
    "sequence_aware": (dict(chunk_costs=TIMES, pp=1, chunk_acts=ACTS, d2h_bw=0.5),
                       dict(bw=0.5)),
    "ahead_pp2": (dict(chunk_costs=TIMES, pp=2, chunk_acts=ACTS, d2h_bw=2.0), dict(bw=2.0)),
    "sync_pp2": (dict(chunk_costs=TIMES, pp=2, chunk_acts=ACTS, d2h_bw=2.0, prefetch="sync"),
                 dict(bw=2.0)),
    "first_cotangent": (dict(chunk_costs=TIMES, pp=2, chunk_acts=[1.0] * 4,
                             alphas=[0.5] * 4, d2h_bw=100.0), {}),
    "p2p_slow": (dict(chunk_costs=[1.0] * 4, pp=2, p2p_bytes=[8.0] * 4, ici_bw=16.0), {}),
    "recurrence_n7": (dict(chunk_costs=[1.3] * 7, pp=1, chunk_acts=[7.0 - i for i in range(7)],
                           d2h_bw=3.0), dict(bw=3.0, fwd_scale=1 / 3)),
}


def _sim_kwargs(case, ofl_mod):
    kw, plan = SIM_CASES[case]
    kw = dict(kw)
    if plan:  # alphas from the sequence-aware solver, as the reference's test
        scale = plan.get("fwd_scale", 1 / 3)
        kw["alphas"] = ofl_mod.sequence_aware_alphas(
            kw["chunk_acts"], [t * scale for t in kw["chunk_costs"]], plan["bw"]).alphas
    return kw


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_simulate_schedule_matches_reference(case):
    from repro.core import offload as jofl
    from repro_torch.core import offload as ofl

    kw, jkw = _sim_kwargs(case, ofl), _sim_kwargs(case, jofl)
    assert kw == jkw
    got, want = sim.simulate_schedule(**kw), jsim.simulate_schedule(**jkw)
    assert _plain(got) == _plain(want)
    assert got.bubble_ratio == want.bubble_ratio
    ev = (jsched.msp_ramp_schedule(len(kw["chunk_costs"]), kw["pp"], kw.get("split", 2))
          if kw.get("msp") else jsim.plain_events(len(kw["chunk_costs"])))
    rest = {k: v for k, v in kw.items() if k not in ("chunk_costs", "msp", "split")}
    assert _plain(sim.simulate(ev, kw["chunk_costs"], **rest)) == _plain(
        jsim.simulate(ev, jkw["chunk_costs"], **rest))


def test_simulate_refuses_an_unknown_prefetch_as_the_reference():
    for mod in (sim, jsim):
        with pytest.raises(AssertionError):
            mod.simulate_schedule(TIMES, pp=2, prefetch="nope")


@pytest.mark.parametrize("n,pp,split,scales", [(8, 4, 2, False), (6, 2, 3, True), (4, 1, 2, False)])
def test_spmd_tick_peak_matches_reference(n, pp, split, scales):
    ev = jsched.msp_ramp_schedule(n, pp, split)
    acts = [float(n - i) for i in range(n)]
    alphas = [0.1 * i for i in range(n)]
    sc = [0.01 * i for i in range(n)] if scales else None
    assert sim.spmd_tick_peak(ev, pp=pp, chunk_acts=acts, alphas=alphas, chunk_scales=sc) == \
        jsim.spmd_tick_peak(ev, pp=pp, chunk_acts=acts, alphas=alphas, chunk_scales=sc)
    assert sim.spmd_tick_peak([], pp=pp, chunk_acts=acts, alphas=alphas) == (0.0, [])


@pytest.mark.parametrize("args", [(6_700_000_000, 8.0, 32e9), (1000, 2.004, 64e9, 50e9),
                                  (10, 8.0, None), (10, 8.0, float("inf"))])
def test_opt_update_transfer_matches_reference(args):
    assert sim.opt_update_transfer(*args) == jsim.opt_update_transfer(*args)


@pytest.mark.parametrize("comp,xfer", [([1.0, 0.5, 0.5, 0.5], [0.0, 0.7, 0.7, 0.7]),
                                       ([0.2] * 8, [0.0] + [0.5] * 7), ([2.0], [0.0])])
def test_ring_overlap_matches_reference(comp, xfer):
    assert sim.ring_overlap(comp, xfer) == jsim.ring_overlap(comp, xfer)


# ---------------------------------------------------------------------------
# solver.py and the golden traces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq,msp", [(524288, False), (262144, True), (4096, False)])
def test_solve_picks_the_reference_plan(seq, msp):
    """Same (pp, N), time, α and candidates as the reference's solver, at
    the reference's hardware (its numbers passed in)."""
    got = solver.solve(get_config("sppo-gpt-7b"), seq, 1, 6_700_000_000, hw=V5E, msp=msp)
    want = jsolver.solve(jget_config("sppo-gpt-7b"), seq, 1, 6_700_000_000, msp=msp)
    assert _plain(got) == _plain(want)


def test_solver_defaults_to_the_h100():
    cfg = get_config("sppo-gpt-7b")
    got = solver.solve(cfg, 524288, 1, 6_700_000_000)
    want = jsolver.solve(jget_config("sppo-gpt-7b"), 524288, 1, 6_700_000_000,
                         hw=jcm.Hardware(**dataclasses.asdict(cm.H100)))
    assert _plain(got) == _plain(want)
    t, _ = solver.iteration_time(cfg, 524288, 1, 6_700_000_000, 4, 8, 16)
    assert t == jsolver.iteration_time(jget_config("sppo-gpt-7b"), 524288, 1, 6_700_000_000,
                                       4, 8, 16, jcm.Hardware(**dataclasses.asdict(cm.H100)))[0]


@pytest.mark.parametrize("mode_kw", [dict(), dict(modes=("local", "gather_kv", "ring"))])
def test_attn_mode_admission_matches_reference(mode_kw):
    args = (524288 * 4, 1, 6_700_000_000, 4, 16)
    got = solver.admit_attn_mode(get_config("sppo-gpt-7b"), *args, V5E, **mode_kw)
    want = jsolver.admit_attn_mode(jget_config("sppo-gpt-7b"), *args, **mode_kw)
    assert got == want
    got = solver.choose_attn_mode(get_config("sppo-gpt-7b"), 524288, 1, 6_700_000_000, 4, 8,
                                  16, V5E)
    want = jsolver.choose_attn_mode(jget_config("sppo-gpt-7b"), 524288, 1, 6_700_000_000, 4, 8,
                                    16)
    assert got == want


def _port_trace_lines(spec):
    """``benchmarks/golden_traces.py::trace_lines`` with the port's config
    and solver: the parameter count that the spec derives from the
    reference's ``parallel/specs.py``, and the document lengths of a seeded
    histogram, are taken from the reference's own derivation; everything
    the trace prints comes from the port."""
    spec = dict(spec)
    cfg = get_config(spec.pop("arch"))
    if spec.pop("reduced", False):
        cfg = cfg.reduced()
    if spec.get("n_params") is None:
        from repro.parallel import specs as jspecs

        jcfg = jget_config(cfg.name.removesuffix("-reduced")).reduced()
        spec["n_params"] = jspecs.count_active_params(jbuild_model(jcfg), spec["pp"], spec["pp"])
    if isinstance(spec.get("doc_lens"), dict):
        from repro_torch.data import pipeline as dpipe

        spec["doc_lens"] = [int(x) for x in dpipe.sample_doc_lengths(**spec["doc_lens"])]
    total, alphas, res = solver.simulate_candidate(cfg, hw=V5E, **spec)
    lines = [
        "# golden schedule trace — regenerate with "
        "`python -m benchmarks.golden_traces --write`",
        f"total_s,{total:.9e}",
        f"alphas,{':'.join(f'{a:.6f}' for a in alphas)}",
        f"d2h_stall_s,{res.d2h_stall:.9e}",
        f"h2d_stall_s,{res.h2d_stall:.9e}",
        f"p2p_stall_s,{res.p2p_stall:.9e}",
    ]
    if any(ev.lane == sim.RING for ev in res.trace):
        lines.append(f"ring_stall_s,{res.ring_stall:.9e}")
    lines += [f"peak_units,{':'.join(f'{p:.6e}' for p in res.peak_units)}",
              "stage,lane,chunk,sub,n_sub,start_s,end_s"]
    lines += [f"{ev.stage},{ev.lane},{ev.chunk},{ev.sub},{ev.n_sub},{ev.start:.9e},{ev.end:.9e}"
              for ev in res.trace]
    return lines


@pytest.mark.parametrize("name,spec", gt.CONFIGS, ids=[n for n, _ in gt.CONFIGS])
def test_golden_trace_byte_identical_through_the_port(name, spec):
    path = os.path.join(os.path.normpath(gt.GOLDEN_DIR), f"{name}.csv")
    got = "\n".join(_port_trace_lines(spec)) + "\n"
    with open(path) as f:
        want = f.read()
    assert got == want, name


# ---------------------------------------------------------------------------
# costmodel.py, the rest
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2-7b", "sppo-gpt-7b", "glm4-9b", "nemotron-4-15b",
                                  "starcoder2-3b"])
def test_costmodel_attention_and_kv_terms_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for b, s, kv, causal in ((1, 8192, None, True), (3, 2560, 8192, True), (2, 128, None, False)):
        kw = dict(causal=causal, kv_len=kv)
        assert cm.attn_flops(b, s, H, hd, **kw) == jcm.attn_flops(b, s, H, hd, **kw)
        assert cm.attn_bwd_flops(b, s, H, hd, **kw) == jcm.attn_bwd_flops(b, s, H, hd, **kw)
        assert cm.attn_bwd_bytes(b, s, kv or s, H, Hkv, hd, hd) == \
            jcm.attn_bwd_bytes(b, s, kv or s, H, Hkv, hd, hd)
    for f in (-0.5, 0.0, 0.37, 1.0, 2.0):
        assert cm.effective_bwd_ratio(f) == jcm.effective_bwd_ratio(f)
    assert cm.ATTN_BWD_RATIO == jcm.ATTN_BWD_RATIO
    for train in (True, False):
        assert cm.model_flops_per_token(7_070_000_000, train=train) == \
            jcm.model_flops_per_token(7_070_000_000, train=train)
    assert cm.kv_bytes_per_token(cfg) == jcm.kv_bytes_per_token(jcfg)
    assert cm.kv_block_bytes(cfg, 16) == jcm.kv_block_bytes(jcfg, 16)
    assert cm.kv_pool_bytes(cfg, 100, 16, 4) == jcm.kv_pool_bytes(jcfg, 100, 16, 4)
    assert cm.ring_hop_bytes(cfg, 512.0, 2) == jcm.ring_hop_bytes(jcfg, 512.0, 2)
    assert cm.tagged_bytes_per_token(cfg) == jcm.tagged_bytes_per_token(jcfg)
    for mode in ("local", "gather_q", "gather_kv", "auto", "ring"):
        for n_params in (None, 7_000_000_000):
            kw = dict(seq_len=1 << 20, batch=2, sp=16, pp=4, mode=mode, n_params=n_params)
            assert cm.stage_attn_demand(cfg, **kw) == jcm.stage_attn_demand(jcfg, **kw)


def test_ring_fractions_and_chunk_time_match_reference():
    for sp in (1, 2, 16):
        for causal in (True, False):
            for layout in ("zigzag", "block"):
                assert cm.ring_hop_fractions(sp, causal=causal, layout=layout) == \
                    jcm.ring_hop_fractions(sp, causal=causal, layout=layout)
    for args in ((1e12, 1e9), (1e9, 1e12, 7)):
        assert cm.chunk_time_est(*args[:2], V5E, *args[2:]) == \
            jcm.chunk_time_est(*args[:2], jcm.V5E, *args[2:])
    assert dataclasses.asdict(V5E) == dataclasses.asdict(jcm.V5E)
    assert set(dataclasses.asdict(cm.H100)) == set(dataclasses.asdict(jcm.V5E))


# ---------------------------------------------------------------------------
# The three dense configs: reduced loss and every gradient against JAX
# ---------------------------------------------------------------------------

CONFIGS = ["glm4-9b", "nemotron-4-15b", "starcoder2-3b"]
S, B = 128, 2


@pytest.mark.parametrize("arch", CONFIGS)
def test_config_matches_reference_fields(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(get_config(arch).reduced()) == \
        dataclasses.asdict(jget_config(arch).reduced())


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    cfg = jget_config(arch).reduced()
    mdef = jbuild_model(cfg)
    ov = dict(pp=1, dp=1, n_chunks=1, grad_accum=1, offload=False, remat="none")
    cell = dataclasses.replace(jrunner.resolve_cell(
        mdef, JShapeConfig("t", S, B, "train"), data_size=1, model_size=1, overrides=ov),
        dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    params = {"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
              "globals": mdef.init_globals(key, jnp.float32)}
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[1, 50:70] = -1

    def loss_fn(p):
        out = jrunner.run_pipeline(cell, SINGLE, p["stages"], p["globals"],
                                   jnp.asarray(tokens), jnp.asarray(labels), None,
                                   with_loss=True)
        return out["loss"] / jnp.maximum(out["denom"], 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float32))
    return dict(params=to_np(params), grads=to_np(grads), loss=float(loss), tokens=tokens,
                labels=labels, ov=ov)


def _jax_leaf(grads, path):
    keys = path.split("/")
    node = grads["stages"] if keys[0] == "stages" else grads
    for k in (keys[2:] if keys[0] == "stages" else keys):
        node = node[k]
    return node[int(keys[1])] if keys[0] == "stages" else node


@pytest.mark.parametrize("arch", CONFIGS)
def test_config_loss_and_every_grad_match_jax(arch):
    ref = _jax_run(arch)
    cell = runner.resolve_cell(get_config(arch).reduced(), ShapeConfig("t", S, B, "train"),
                               overrides=ref["ov"], dtype=torch.float32)
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    loss, grads = runner.loss_and_grads(cell, params, torch.from_numpy(ref["tokens"]),
                                        torch.from_numpy(ref["labels"]))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=0, atol=TOL)
    n = 0
    for path, g in tree.items(grads):
        want = _jax_leaf(ref["grads"], path)
        assert g.shape == want.shape, path
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=TOL, err_msg=path)
        n += 1
    assert n == len(jax.tree_util.tree_leaves(ref["grads"]["globals"])) + 2 * len(
        jax.tree_util.tree_leaves(ref["grads"]["stages"]))
