"""The port's serving slice against the JAX reference, on the CPU.

The same JAX-built fp32 parameters (carried across through
``convert.params_from_numpy``) and the same numpy prompts go through JAX's
``make_prefill_step`` + ``make_serve_step`` on a 1x1 mesh and through the
port's counterparts.  S = 320 gives two FLOPs-balanced chunks (128, 192), the
second ragged.  Prefill caches and the last hidden state agree at 1e-5 (fp32,
the reference's own bar in tests/test_pipeline_equivalence.py), decoded
tokens are identical, and so are the caches after decoding.
"""
import ast
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import gather_decode_tokens as jgather
from repro.launch.serve import shard_rows as jshard_rows
from repro.launch.train import build_params as jbuild_params
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel import plans as jplans
from repro.parallel import runner as jrunner
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import plans, runner

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

ROOT = Path(__file__).resolve().parents[1]
S, B, DECODE = 320, 2, 4
TOL = 1e-5


def _overrides(S):
    return dict(pp=1, dp=1, n_chunks=max(1, S // 64), offload=False,
                remat="none")


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """JAX reference: params, prefill state + last hidden, decode tokens and
    the state after decoding (all as numpy)."""
    cfg = jget_config(arch).reduced()
    mdef = jbuild_model(cfg)
    mesh = make_test_mesh(1, 1)
    pre = dataclasses.replace(jrunner.resolve_cell(
        mdef, JShapeConfig("p", S, B, "prefill"), data_size=1, model_size=1,
        overrides=_overrides(S)), dtype=jnp.float32)
    dec = dataclasses.replace(jrunner.resolve_cell(
        mdef, JShapeConfig("d", S, B, "decode"), data_size=1, model_size=1,
        overrides=dict(pp=1, dp=1)), dtype=jnp.float32)
    params, _, _ = jbuild_params(pre, mesh)
    prompts = _prompts(cfg.vocab_size, S)
    prefill, _, _ = jrunner.make_prefill_step(pre, mesh)
    _, bspecs = jrunner.batch_struct(pre)
    tok = jnp.asarray(jshard_rows(prompts, 1, 1))
    # transfer-lint: ok (test input staging onto the mesh)
    batch = {k: jax.device_put(v, NamedSharding(mesh, bspecs[k]))
             for k, v in {"tokens": tok, "labels": tok}.items()}
    state, last = jax.jit(prefill)(params, batch)
    state_pre = _np_kv(state)
    serve_fn, _, _ = jrunner.make_serve_step(dec, mesh, decode_steps=DECODE)
    serve_fn = jax.jit(serve_fn)
    cur = jnp.asarray(jshard_rows(prompts[:, -1:], 1, 1))
    toks = []
    for step in range(DECODE):
        state, nxt = serve_fn(params, state, {"tokens": cur,
                                              "pos": jnp.int32(S + step)})
        cur = nxt[None]
        toks.append(jgather(np.asarray(nxt), 1, 1, B))
    np_params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                       params)
    # drop the data-axis lead of the stage leaves: [1, n_slots, ...]
    np_params["stages"] = jax.tree_util.tree_map(lambda a: a[0],
                                                 np_params["stages"])
    return dict(params=np_params, prompts=prompts, state_pre=state_pre,
                last=np.asarray(last)[0], tokens=np.stack(toks, axis=1),
                state_dec=_np_kv(state), n_chunks=pre.sched.n)


def _prompts(vocab, S):
    rng = np.random.default_rng(0)
    return rng.integers(2, vocab, size=(B, S)).astype(np.int32)


def _np_kv(state):
    kv = state["kv"]
    return {n: np.asarray(getattr(kv, n))[0] for n in ("k", "v", "pos")}


def _torch_kv(state):
    return {n: torch.stack([getattr(s["kv"], n) for s in state]).numpy()
            for n in ("k", "v", "pos")}


def _torch_cells(arch, S):
    cfg = get_config(arch).reduced()
    pre = runner.resolve_cell(cfg, ShapeConfig("p", S, B, "prefill"),
                              overrides=_overrides(S), dtype=torch.float32)
    dec = runner.resolve_cell(cfg, ShapeConfig("d", S, B, "decode"),
                              overrides=dict(pp=1, dp=1), dtype=torch.float32)
    return pre, dec


def _torch_run(ref, arch):
    params = params_from_numpy(ref["params"], dtype=torch.float32,
                               device="cpu")
    pre, dec = _torch_cells(arch, S)
    state, last = runner.make_prefill_step(pre)(
        params, torch.from_numpy(ref["prompts"]))
    state_pre = _torch_kv(state)
    serve_fn = runner.make_serve_step(dec, decode_steps=DECODE)
    cur = torch.from_numpy(ref["prompts"][:, -1:])
    toks = []
    for step in range(DECODE):
        state, cur = serve_fn(params, state, cur, S + step)
        toks.append(cur[:, 0].numpy())
    return dict(state_pre=state_pre, last=last.numpy(), state_dec=_torch_kv(state),
                tokens=np.stack(toks, axis=1), sched=pre.sched)


ARCHS = ["qwen2-7b", "sppo-gpt-7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    ref = _jax_run(arch)
    got = _torch_run(ref, arch)
    assert got["sched"].lengths == (128, 192) and ref["n_chunks"] == 2
    for name in ("k", "v"):
        np.testing.assert_allclose(got["state_pre"][name], ref["state_pre"][name],
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got["state_pre"]["pos"], ref["state_pre"]["pos"])
    np.testing.assert_allclose(got["last"], ref["last"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_tokens_and_caches_match_jax(arch):
    ref = _jax_run(arch)
    got = _torch_run(ref, arch)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    for name in ("k", "v"):
        np.testing.assert_allclose(got["state_dec"][name], ref["state_dec"][name],
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got["state_dec"]["pos"], ref["state_dec"]["pos"])


def test_prefill_then_decode_equals_longer_prefill():
    """Mirror of test_serving.py's cache contract inside the port: prefill(S)
    plus one decode step of the last prompt token at position S builds the
    cache prefill(S + 1) builds for the prompt with that token appended."""
    ref = _jax_run("qwen2-7b")
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    prompts = ref["prompts"]
    ext = np.concatenate([prompts, prompts[:, -1:]], axis=1)
    pre_s, dec = _torch_cells("qwen2-7b", S)
    pre_s1, _ = _torch_cells("qwen2-7b", S + 1)
    state_s, _ = runner.make_prefill_step(pre_s)(params, torch.from_numpy(prompts))
    state_d, _ = runner.make_serve_step(dec)(
        params, state_s, torch.from_numpy(prompts[:, -1:]), S)
    state_s1, _ = runner.make_prefill_step(pre_s1)(params, torch.from_numpy(ext))
    got, want = _torch_kv(state_d), _torch_kv(state_s1)
    np.testing.assert_array_equal(got["pos"][:, :S + 1], want["pos"][:, :S + 1])
    for name in ("k", "v"):
        np.testing.assert_allclose(got[name][:, :, :S + 1],
                                   want[name][:, :, :S + 1],
                                   rtol=TOL, atol=TOL, err_msg=name)


def test_decode_budget_guard():
    _, dec = _torch_cells("qwen2-7b", 64)
    assert runner.max_decode_steps(dec) == runner.DECODE_BUDGET
    with pytest.raises(ValueError, match="decode budget"):
        runner.make_serve_step(dec, decode_steps=runner.max_decode_steps(dec) + 1)
    runner.make_serve_step(dec, decode_steps=runner.max_decode_steps(dec))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind,seq,batch", [
    ("prefill", 320, 2), ("prefill", 2048, 4), ("prefill", 8192, 8),
    ("decode", 2048, 4), ("train", 4096, 16)])
def test_resolve_plan_matches_jax(arch, kind, seq, batch):
    for reduced in (False, True):
        tcfg, jcfg = get_config(arch), jget_config(arch)
        if reduced:
            tcfg, jcfg = tcfg.reduced(), jcfg.reduced()
        got = plans.resolve_plan(tcfg, ShapeConfig("c", seq, batch, kind),
                                 data_size=1, model_size=1)
        want = jplans.resolve_plan(jcfg, JShapeConfig("c", seq, batch, kind),
                                   data_size=1, model_size=1)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_resolve_plan_caps_pp_where_the_reference_divides_by_zero():
    """The port's one departure from the reference's planner: at S >= 32768
    with >= 24 layers the reference asks for pp = 2 whatever the data axis,
    so at data_size = 1 it divides by dp = 0; the port caps pp at the data
    axis and plans pp = 1, dp = 1.  Everywhere the reference returns a plan,
    the port returns the same one."""
    cfg, jcfg = get_config("qwen2-7b"), jget_config("qwen2-7b")
    shape, jshape = ShapeConfig("t", 32768, 1, "train"), JShapeConfig("t", 32768, 1, "train")
    with pytest.raises(ZeroDivisionError):
        jplans.resolve_plan(jcfg, jshape, data_size=1, model_size=1)
    plan = plans.resolve_plan(cfg, shape, data_size=1, model_size=1)
    assert (plan.pp, plan.dp) == (1, 1)
    planned = refused = 0
    for arch in ARCHS:
        for kind, seq, batch in (("train", 32768, 1), ("train", 65536, 2), ("train", 8192, 1),
                                 ("prefill", 32768, 1), ("prefill", 4096, 4),
                                 ("decode", 32768, 2)):
            for data_size, model_size in ((1, 1), (2, 1), (4, 2), (16, 16)):
                args = dict(data_size=data_size, model_size=model_size)
                try:
                    want = jplans.resolve_plan(jget_config(arch), JShapeConfig("c", seq, batch,
                                                                             kind), **args)
                except ZeroDivisionError:
                    refused += 1
                    got = plans.resolve_plan(get_config(arch), ShapeConfig("c", seq, batch, kind),
                                             **args)
                    assert got.dp * got.pp == data_size and got.pp <= data_size
                    continue
                got = plans.resolve_plan(get_config(arch), ShapeConfig("c", seq, batch, kind),
                                         **args)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, kind, seq, args)
                planned += 1
    assert refused > 0 and planned > refused


def test_cli_serves_on_cpu_and_matches_layout_helpers():
    out = serve.main(["--arch", "qwen2-7b", "--reduced", "--prompt-len", "128",
                      "--batch", "2", "--decode-steps", "3", "--device", "cpu"])
    toks = out["tokens"]
    assert toks.shape == (2, 3) and toks.dtype == np.int32
    assert ((toks >= 0) & (toks < get_config("qwen2-7b").reduced().vocab_size)).all()
    assert torch.isfinite(out["last_hidden"]).all() and out["peak_bytes"] is None
    prompts = np.arange(24, dtype=np.int32).reshape(4, 6)
    for dp, pp in ((1, 1), (2, 1), (2, 3)):
        np.testing.assert_array_equal(serve.shard_rows(prompts, dp, pp),
                                      jshard_rows(prompts, dp, pp))
        nxt = serve.shard_rows(prompts, dp, pp)[0, :, :, :1]
        np.testing.assert_array_equal(serve.gather_decode_tokens(nxt, dp, pp, 4),
                                      jgather(nxt, dp, pp, 4))


def test_cli_repeats_time_each_run_and_serve_the_same_tokens():
    argv = ["--arch", "qwen2-7b", "--reduced", "--prompt-len", "64", "--batch", "2",
            "--decode-steps", "2", "--device", "cpu"]
    once = serve.main(argv)
    twice = serve.main(argv + ["--repeats", "2"])
    assert len(twice["prefill_s_runs"]) == len(twice["decode_s_runs"]) == 2
    assert twice["prefill_s"] == twice["prefill_s_runs"][-1]
    np.testing.assert_array_equal(twice["tokens"], once["tokens"])
    with pytest.raises(ValueError, match="repeats"):
        serve.main(argv + ["--repeats", "0"])


def test_entry_points_target_cuda():
    """Asked for nothing, the serve entry point targets the card; with no
    card it fails instead of running on the CPU."""
    assert serve.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--reduced", "--prompt-len", "64", "--decode-steps", "1"])


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f} imports {mod}"
