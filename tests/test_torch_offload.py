"""The port's executed activation offload against the JAX reference, on the
CPU (DESIGN.md §5, §10, §12).

- The planning math (``core/offload.py``: ``sequence_aware_alphas``,
  ``peak_memory``, ``split_rows``, ``quantized_alpha``; ``core/costmodel.py``:
  ``tagged_bytes_per_token``, ``chunk_act_bytes``) is a copy, held equal to
  the reference's on the same inputs; ``resolve_cell`` deploys the
  reference's α on the same hardware.
- Loss and every gradient of a training step with offload on, under
  prefetch "ahead" and "sync", equal the reference's ``run_pipeline`` with
  offload on at 1e-5 (fp32: the reference's bar,
  tests/test_offload_exec.py::test_pp1_offload_on_off_loss_and_grads_match).
  JAX-built fp32 parameters are carried across through
  ``convert.params_from_numpy``; tokens are numpy from a seed.  S = 512:
  at S = 256 the chunk boundaries' 128-token multiple leaves two chunks, and
  four are needed to deploy all of ALPHAS.
- Ahead ≡ sync (tests/test_prefetch.py::test_ahead_vs_sync_loss_and_grads_match
  at pp = 1) and remat "sppo" ≡ "full" ≡ "none", in the port.
- The bytes moved, the order of the copies and the staging invariant (at
  most one chunk's rows reloaded ahead), from ``runtime/hostmem.py``'s
  counters and log: on the CPU the "host" copy is a CPU clone.
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

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.core import costmodel as jcm
from repro.core import offload as jofl
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel import runner as jrunner
from repro.parallel import specs as jspecs
from repro.parallel.ctx import SINGLE
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import offload as ofl
from repro_torch.core import tree
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import runner
from repro_torch.runtime import hostmem

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

ALPHAS = (1.0, 0.7, 0.5, 0.0)   # full / fractional / fractional / reserved
S, B = 512, 2
TOL = 1e-5
ARCHS = ["qwen2-7b", "sppo-gpt-7b"]


def _overrides(**kw):
    return {**dict(pp=1, dp=1, n_chunks=len(ALPHAS), grad_accum=1,
                   partition="length"), **kw}


def _batch(vocab):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, prefetch, codec="none"):
    """The reference's loss and gradients with offload on at ALPHAS (numpy),
    its fp32 parameters and the batch; ``codec``: the off rows' codec."""
    cfg = jget_config(arch).reduced()
    mdef = jbuild_model(cfg)
    cell = jrunner.resolve_cell(mdef, JShapeConfig("t", S, B, "train"), data_size=1,
                                model_size=1,
                                overrides=_overrides(offload=True, prefetch=prefetch,
                                                     offload_dtype=codec))
    cell = dataclasses.replace(cell, dtype=jnp.float32, alphas=ALPHAS)
    key = jax.random.PRNGKey(0)
    params = {"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
              "globals": mdef.init_globals(key, jnp.float32)}
    tokens, labels = _batch(cfg.vocab_size)

    def loss_fn(p):
        out = jrunner.run_pipeline(cell, SINGLE, p["stages"], p["globals"],
                                   jnp.asarray(tokens), jnp.asarray(labels), None,
                                   with_loss=True)
        return out["loss"] / jnp.maximum(out["denom"], 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float32))
    return dict(params=to_np(params), grads=to_np(grads), loss=float(loss),
                tokens=tokens, labels=labels, lengths=cell.sched.lengths)


def _jax_leaf(grads, path):
    """The reference's gradient at a port path (stages/<slot>/... unstacks
    the slot dim)."""
    keys = path.split("/")
    if keys[0] == "stages":
        node = grads["stages"]
        for k in keys[2:]:
            node = node[k]
        return node[int(keys[1])]
    node = grads
    for k in keys:
        node = node[k]
    return node


def _cell(arch, alphas=ALPHAS, **kw):
    cell = runner.resolve_cell(get_config(arch).reduced(), ShapeConfig("t", S, B, "train"),
                               overrides=_overrides(**kw), dtype=torch.float32)
    return cell if alphas is None else dataclasses.replace(cell, alphas=tuple(alphas))


def _run(cell, ref):
    """One step's loss and gradients in the port, with its copy counters and
    log from zero."""
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    hostmem.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, torch.from_numpy(ref["tokens"]),
                                        torch.from_numpy(ref["labels"]))
    return float(loss), grads, hostmem.counts(), hostmem.log()


def _assert_grads_equal(got, want_leaf):
    for path, g in tree.items(got):
        want = want_leaf(path)
        assert g.shape == want.shape, path
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=TOL, err_msg=path)


def _closed_form_bytes(cell):
    """D2H bytes of one step: the off rows of every chunk, layer and tag site
    (q, k, v, attention out, MLP hidden), at the cell's dtype, or at the
    codec's 1-byte payload (the scales do not cross)."""
    elems = cm.tagged_bytes_per_token(cell.cfg) // cm.ACT_ITEMSIZE
    itemsize = (torch.finfo(cell.dtype).bits // 8 if cell.plan.offload_dtype == "none"
                else cm.codec_itemsize(cell.plan.offload_dtype))
    return sum(ofl.split_rows(ln, a) * cell.shape.global_batch * elems * itemsize
               * cell.cfg.n_layers for ln, a in zip(cell.sched.lengths, cell.alphas))


# ---------------------------------------------------------------------------
# planning math: copies of the reference's
# ---------------------------------------------------------------------------


def _planning_case(n, seed):
    rng = np.random.default_rng(seed)
    acts = list(rng.uniform(1e3, 1e9, n))
    times = list(rng.uniform(1e-6, 1e-1, n))
    return acts, times


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 12), st.integers(0, 10_000), st.floats(1e6, 1e12),
       st.sampled_from([True, False]), st.floats(0.5, 4.0))
def test_sequence_aware_alphas_match_reference(n, seed, bw, reserve_last, bwd_over_fwd):
    """tests/test_sppo_core.py's offload-ratio properties, as an identity."""
    acts, times = _planning_case(n, seed)
    got = ofl.sequence_aware_alphas(acts, times, bw, reserve_last=reserve_last,
                                    bwd_over_fwd=bwd_over_fwd)
    want = jofl.sequence_aware_alphas(acts, times, bw, reserve_last=reserve_last,
                                      bwd_over_fwd=bwd_over_fwd)
    assert got.alphas == want.alphas
    assert got.m_threshold == want.m_threshold and got.peak_units == want.peak_units
    assert ofl.peak_memory(acts, got.alphas) == jofl.peak_memory(acts, want.alphas)


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 5000), st.floats(-0.5, 1.5))
def test_split_rows_and_quantized_alpha_match_reference(rows, alpha):
    assert ofl.split_rows(rows, alpha) == jofl.split_rows(rows, alpha)
    assert ofl.quantized_alpha(rows, alpha) == jofl.quantized_alpha(rows, alpha)


@pytest.mark.parametrize("arch", ARCHS)
def test_tagged_and_chunk_bytes_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cm.tagged_bytes_per_token(cfg) == jcm.tagged_bytes_per_token(jcfg)
    lengths = (2560, 2048, 1920, 1664)
    for kw in (dict(batch=1, pp=1, sp=1), dict(batch=4, pp=1, sp=1, grad_accum=2)):
        assert cm.chunk_act_bytes(cfg, lengths, **kw) == jcm.chunk_act_bytes(jcfg, lengths, **kw)
    assert cm.BWD_RATIO == jcm.BWD_RATIO


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_only_param_count_matches_reference(arch):
    """``count_active_params`` of a ModelDef (meta-device shapes) at full
    width is the reference's ``specs.count_active_params(mdef, 1, 1)``."""
    cfg = dataclasses.replace(get_config(arch), n_layers=4)
    jcfg = dataclasses.replace(jget_config(arch), n_layers=4)
    assert cm.count_active_params(build_model(cfg)) == jspecs.count_active_params(
        jbuild_model(jcfg), 1, 1)


CELLS = [("qwen2-7b", True, 256, 2, 2), ("sppo-gpt-7b", True, 256, 2, 2),
         ("qwen2-7b", False, 8192, 1, 4), ("qwen2-7b", False, 32768, 1, 8),
         ("sppo-gpt-7b", False, 8192, 1, 4)]


@pytest.mark.parametrize("arch,reduced,seq,batch,n_chunks", CELLS)
@pytest.mark.parametrize("offload", [True, False])
def test_deployed_alphas_match_reference(arch, reduced, seq, batch, n_chunks, offload):
    """The α ``resolve_cell`` deploys equal the reference's on the same
    hardware (a reference ``Hardware`` with the port's H100 numbers), at
    reduced width and at full width cut to 4 layers (S = 8192 and 32768,
    the chip_smoke.py cells); with offload off, zeros in both."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    cfg, jcfg = ((cfg.reduced(), jcfg.reduced()) if reduced else
                 (dataclasses.replace(cfg, n_layers=4), dataclasses.replace(jcfg, n_layers=4)))
    h100 = dataclasses.replace(jcm.V5E, name="h100", peak_flops_bf16=cm.H100.peak_flops_bf16,
                               hbm_bw=cm.H100.hbm_bw, d2h_bw=cm.H100.d2h_bw)
    ov = dict(pp=1, dp=1, n_chunks=n_chunks, offload=offload)
    got = runner.resolve_cell(cfg, ShapeConfig("t", seq, batch, "train"), overrides=ov)
    want = jrunner.resolve_cell(jbuild_model(jcfg), JShapeConfig("t", seq, batch, "train"),
                                data_size=1, model_size=1, overrides=ov, hw=h100)
    assert got.sched.lengths == want.sched.lengths
    assert got.alphas == want.alphas
    assert any(got.alphas) == offload


def test_h100_cells_deploy_the_planned_alphas():
    """The chip_smoke.py cells under the H100's data-sheet numbers: the
    chunk plans and α of the cost model (a CPU computation, not a card
    reading)."""
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=4)
    want = {8192: ((2560, 2048, 1920, 1664), (0.683, 0.911, 0.935, 0.0)),
            32768: ((7680, 5248, 4352, 3712, 3328, 2944, 2816, 2688),
                    (0.469, 0.698, 0.83, 0.976, 1.0, 1.0, 1.0, 0.0))}
    for seq, (lengths, alphas) in want.items():
        cell = runner.resolve_cell(cfg, ShapeConfig("t", seq, 1, "train"),
                                   overrides=dict(pp=1, dp=1, n_chunks=len(lengths)))
        assert cell.sched.lengths == lengths
        assert tuple(round(a, 3) for a in cell.alphas) == alphas


# ---------------------------------------------------------------------------
# the executed offload: loss and gradients against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefetch", ["ahead", "sync"])
@pytest.mark.parametrize("arch", ARCHS)
def test_offload_loss_and_every_grad_match_jax(arch, prefetch):
    """tests/test_offload_exec.py::test_pp1_offload_on_off_loss_and_grads_match's
    cell, in both packages with offload on at ALPHAS: four chunks of 128
    tokens, whose tagged rows go to host whole, at 90 and 64 of 128 rows, and
    not at all."""
    ref = _jax_run(arch, prefetch)
    cell = _cell(arch, offload=True, prefetch=prefetch)
    assert cell.sched.lengths == ref["lengths"] == (128,) * 4
    assert cell.plan.remat == "sppo" and cell.plan.offload
    loss, grads, counts, _ = _run(cell, ref)
    np.testing.assert_allclose(loss, ref["loss"], rtol=0, atol=TOL)
    _assert_grads_equal(grads, lambda path: _jax_leaf(ref["grads"], path))
    assert counts["d2h_bytes"] == _closed_form_bytes(cell) > 0


@pytest.mark.parametrize("alpha", [0.0, 0.45, 1.0])
def test_ahead_equals_sync(alpha):
    """tests/test_prefetch.py::test_ahead_vs_sync_loss_and_grads_match at
    pp = 1: where the reloads sit changes no number."""
    ref = _jax_run("qwen2-7b", "ahead")
    alphas = (alpha, alpha, alpha, 0.0)
    out = {p: _run(_cell("qwen2-7b", alphas, offload=True, prefetch=p), ref)
           for p in ("ahead", "sync")}
    (la, ga, ca, _), (ls, gs, cs, _) = out["ahead"], out["sync"]
    np.testing.assert_allclose(la, ls, rtol=0, atol=TOL)
    _assert_grads_equal(ga, dict(tree.items(gs)).__getitem__)
    assert ca == cs


@pytest.mark.parametrize("remat", ["sppo", "full"])
def test_remat_policies_equal_none(remat):
    """With offload off, remat "sppo" (tagged rows kept on the device) and
    "full" (nothing kept) give remat "none"'s loss and gradients, and move
    nothing."""
    ref = _jax_run("qwen2-7b", "ahead")
    l0, g0, _, _ = _run(_cell("qwen2-7b", None, offload=False, remat="none"), ref)
    cell = _cell("qwen2-7b", None, offload=False, remat=remat)
    assert not any(cell.alphas)
    loss, grads, counts, log = _run(cell, ref)
    np.testing.assert_allclose(loss, l0, rtol=0, atol=TOL)
    _assert_grads_equal(grads, dict(tree.items(g0)).__getitem__)
    assert counts["d2h"] == counts["h2d"] == 0 and log == []


@pytest.mark.parametrize("prefetch,alphas", [("ahead", ALPHAS), ("sync", ALPHAS),
                                             ("ahead", None)])
def test_copied_bytes_match_the_closed_form(prefetch, alphas):
    """D2H bytes of a step are Σ over chunks, layers and tag sites of
    split_rows(rows, α_c) × row bytes, exactly; the H2D moves the same
    bytes back.  ``None``: the α ``resolve_cell`` deploys."""
    ref = _jax_run("qwen2-7b", "ahead")
    cell = _cell("qwen2-7b", alphas, offload=True, prefetch=prefetch)
    _, _, counts, _ = _run(cell, ref)
    want = _closed_form_bytes(cell)
    assert want > 0
    assert counts["d2h_bytes"] == counts["h2d_bytes"] == want
    n_off = sum(ofl.split_rows(ln, a) > 0 for ln, a in zip(cell.sched.lengths, cell.alphas))
    assert counts["d2h"] == counts["h2d"] == 5 * cell.cfg.n_layers * n_off


def _staged_ahead(log):
    """The most chunks whose reload was issued before their backward began,
    at any point of the log."""
    issued, begun, most = set(), set(), 0
    for what, c in log:
        if what == "h2d":
            issued.add(c)
        elif what == "bwd":
            begun.add(c)
        most = max(most, len(issued - begun))
    return most


def _compress(log):
    """The log with runs of the same entry folded into one."""
    return [e for i, e in enumerate(log) if i == 0 or e != log[i - 1]]


def test_ahead_reloads_each_chunk_during_the_next_chunks_backward():
    """Under "ahead" the reload of chunk c - 1 is issued in chunk c's
    backward, before its replay; the last chunk's (none: α = 0) at the
    loss; never more than one chunk's rows staged ahead."""
    ref = _jax_run("qwen2-7b", "ahead")
    _, _, _, log = _run(_cell("qwen2-7b", offload=True, prefetch="ahead"), ref)
    assert _compress(log) == [
        ("d2h", 0), ("d2h", 1), ("d2h", 2),
        ("bwd", 3), ("h2d", 2), ("replay", 3),
        ("bwd", 2), ("h2d", 1), ("replay", 2),
        ("bwd", 1), ("h2d", 0), ("replay", 1),
        ("bwd", 0), ("replay", 0)]
    assert _staged_ahead(log) == 1


def test_sync_reloads_each_chunk_at_its_own_backward():
    ref = _jax_run("qwen2-7b", "sync")
    _, _, _, log = _run(_cell("qwen2-7b", offload=True, prefetch="sync"), ref)
    assert _compress(log) == [
        ("d2h", 0), ("d2h", 1), ("d2h", 2),
        ("bwd", 3), ("replay", 3),
        ("bwd", 2), ("h2d", 2), ("replay", 2),
        ("bwd", 1), ("h2d", 1), ("replay", 1),
        ("bwd", 0), ("h2d", 0), ("replay", 0)]
    assert _staged_ahead(log) == 0


def test_last_chunk_offloading_is_reloaded_at_the_loss():
    """With α > 0 on the last chunk (``reserve_last=False``'s case) its
    reload is issued by ``link_drain`` before its own backward, and the
    numbers stay those of sync."""
    ref = _jax_run("qwen2-7b", "ahead")
    alphas = (0.5, 0.5, 0.5, 0.5)
    la, ga, _, log = _run(_cell("qwen2-7b", alphas, offload=True, prefetch="ahead"), ref)
    assert _compress(log)[4:6] == [("h2d", 3), ("bwd", 3)]
    assert _staged_ahead(log) == 1
    ls, gs, _, _ = _run(_cell("qwen2-7b", alphas, offload=True, prefetch="sync"), ref)
    np.testing.assert_allclose(la, ls, rtol=0, atol=TOL)
    _assert_grads_equal(ga, dict(tree.items(gs)).__getitem__)


@pytest.mark.parametrize("prefetch", ["ahead", "sync"])
def test_staged_rows_give_bitwise_the_numbers_of_kept_rows(prefetch):
    """The replay reads the same values whether a tagged row was kept on
    the device or went to host and back: remat "sppo" with offload on at
    ALPHAS gives bitwise the loss and gradients of "sppo" with every row
    kept (chip_smoke.py holds the card's plans (b) and (c) to (d)'s
    gradients the same way)."""
    ref = _jax_run("qwen2-7b", prefetch)
    kept = _run(_cell("qwen2-7b", None, offload=False, remat="sppo"), ref)
    moved = _run(_cell("qwen2-7b", offload=True, prefetch=prefetch), ref)
    assert moved[2]["d2h_bytes"] > 0 and kept[2]["d2h_bytes"] == 0
    assert moved[0] == kept[0]
    want = dict(tree.items(kept[1]))
    for path, g in tree.items(moved[1]):
        assert torch.equal(g, want[path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_sppo_replay_skips_the_qkv_projections(arch):
    """Under remat "sppo" the replay takes q, k and v from the saved rows:
    a step runs exactly the q, k, v projections' forward FLOPs fewer than
    under "full", which recomputes them (the backward is the same)."""
    from torch.utils.flop_counter import FlopCounterMode

    ref = _jax_run(arch, "ahead")
    flops = {}
    for remat in ("sppo", "full"):
        cell = _cell(arch, None, offload=False, remat=remat)
        with FlopCounterMode(display=False) as counter:
            _run(cell, ref)
        flops[remat] = counter.get_total_flops()
    cfg = cell.cfg
    qkv = 2 * B * S * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.hd * cfg.n_layers
    assert flops["full"] - flops["sppo"] == qkv > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_saved_qkv_backward_matches_autograd(arch, dtype):
    """``_SavedQKV``'s hand-written backward (RoPE rotated back, then the
    projections' VJP) equals autograd's through ``_qkv`` bitwise, for every
    input that has a gradient (the biases where the model has them): the
    same products, summed in the same order."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L

    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(3)
    T = 48
    p = {k: torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * 0.1).to(dtype)
         for k, shape in (("wq", (cfg.d_model, cfg.n_heads * cfg.hd)),
                          ("wk", (cfg.d_model, cfg.n_kv_heads * cfg.hd)),
                          ("wv", (cfg.d_model, cfg.n_kv_heads * cfg.hd)))}
    if cfg.qkv_bias:
        p.update({"b" + k[1]: torch.from_numpy(rng.standard_normal(w.shape[1]).astype(
            np.float32)).to(dtype) for k, w in list(p.items())})
    x = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)).to(dtype)
    rope = L.rope_tables(torch.arange(100, 100 + T), cfg.hd, cfg.rope_theta, cfg.rope_fraction)
    dq, dk, dv = (torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)).to(dtype)
                  for t in A._qkv(x, p, cfg, rope))
    leaves = [x, *p.values()]
    names = ["x", *p]

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in leaves]
        q, k, v = fn(ins[0], dict(zip(names[1:], ins[1:])))
        return torch.autograd.grad((q, k, v), ins, (dq, dk, dv)), (q, k, v)

    want, outs = grads(lambda x, p: A._qkv(x, p, cfg, rope))
    saved = [t.detach() for t in outs]
    got, back = grads(lambda x, p: A._SavedQKV.apply(
        rope, x, p["wq"], p["wk"], p["wv"], p.get("bq"), p.get("bk"), p.get("bv"), *saved))
    assert all(torch.equal(a, b) for a, b in zip(back, saved))
    for name, g, w in zip(names, got, want):
        assert g.dtype == dtype and torch.equal(g, w), name


# ---------------------------------------------------------------------------
# the compressed rows (DESIGN.md §14)
# ---------------------------------------------------------------------------

# one-step gradient drift of a compressed cell against raw residency, the
# reference's pinned bounds (tests/test_offload_quant.py)
GRAD_TOL = {"fp8": 0.05, "int8": 0.03}


def _flat(grads, order):
    return np.concatenate([np.asarray(grads(path), np.float64).ravel() for path in order])


def _drift(a, b, order):
    """(relative loss drift, relative L2 gradient drift) of run a against
    run b, each (loss, path -> gradient)."""
    ga, gb = _flat(a[1], order), _flat(b[1], order)
    return (abs(a[0] - b[0]) / max(abs(b[0]), 1e-9),
            float(np.linalg.norm(ga - gb) / max(np.linalg.norm(gb), 1e-12)))


def _port_step(codec, prefetch):
    ref = _jax_run("qwen2-7b", prefetch, codec)
    cell = _cell("qwen2-7b", offload=True, prefetch=prefetch, offload_dtype=codec)
    loss, grads, counts, _ = _run(cell, ref)
    paths = [path for path, _ in tree.items(grads)]
    got = dict(tree.items(grads))
    return cell, (loss, lambda p: got[p].numpy()), counts, paths, (
        ref["loss"], lambda p: _jax_leaf(ref["grads"], p))


@pytest.mark.parametrize("codec", ["fp8", "int8"])
def test_pp1_compressed_drift_within_pinned_tolerance(codec):
    """tests/test_offload_quant.py's law on the port, at ALPHAS (whole,
    fractional and no row sets offloaded): the capture forward is exact (loss
    within 1e-5 of the raw run's), the replay on the dequantized rows drifts
    within the codec's pinned bound and not zero.  And the port's compressed
    run against the reference's: loss within 1e-5, gradients within
    GRAD_TOL (the payloads are the reference's bit for bit on equal rows; the
    two frameworks' fp32 rows differ in their last bits)."""
    _, comp, counts, order, jcomp = _port_step(codec, "ahead")
    _, raw, _, _, jraw = _port_step("none", "ahead")
    loss_d, grad_d = _drift(comp, raw, order)
    assert loss_d <= 1e-5, loss_d
    assert 1e-7 < grad_d <= GRAD_TOL[codec], grad_d
    loss_d, grad_d = _drift(comp, jcomp, order)
    assert loss_d <= 1e-5 and grad_d <= GRAD_TOL[codec], (loss_d, grad_d)
    # the reference's own compressed drift is of the same size as the port's
    assert _drift(jcomp, jraw, order)[1] <= GRAD_TOL[codec]


def test_pp1_sync_prefetch_compressed_drift():
    """tests/test_offload_quant.py::test_pp1_sync_prefetch_compressed_drift's
    bounds on the port (loss within 2e-2, 1e-7 < gradient drift <= 0.1).
    The reference's "sync" form substitutes the reconstruction in its
    forward, so its loss drifts; the port's seam runs "sync" as "ahead",
    its forward exact, so its loss is the raw run's and its gradients are
    its "ahead" run's bitwise."""
    _, comp, _, order, jcomp = _port_step("fp8", "sync")
    _, raw, _, _, _ = _port_step("none", "sync")
    loss_d, grad_d = _drift(comp, raw, order)
    assert loss_d <= 1e-5
    assert 1e-7 < grad_d <= 0.1, grad_d
    loss_d, grad_d = _drift(comp, jcomp, order)
    assert loss_d <= 2e-2 and grad_d <= 0.1, (loss_d, grad_d)
    _, ahead, _, _, _ = _port_step("fp8", "ahead")
    assert comp[0] == ahead[0] and all((comp[1](p) == ahead[1](p)).all() for p in order)


@pytest.mark.parametrize("prefetch", ["ahead", "sync"])
@pytest.mark.parametrize("codec", ["fp8", "int8"])
def test_compressed_copies_carry_the_payload_only(codec, prefetch):
    """Each way, a step moves the off rows' 1-byte payloads, exactly the
    closed form at the codec's itemsize: one copy per tag site and layer of
    every offloading chunk, as uncompressed; the scales stay on the device."""
    cell, _, counts, _, _ = _port_step(codec, prefetch)
    want = _closed_form_bytes(cell)
    assert want > 0 and counts["d2h_bytes"] == counts["h2d_bytes"] == want
    n_off = sum(ofl.split_rows(ln, a) > 0 for ln, a in zip(cell.sched.lengths, cell.alphas))
    assert counts["d2h"] == counts["h2d"] == 5 * cell.cfg.n_layers * n_off


@pytest.mark.parametrize("arch,reduced,seq,batch,n_chunks", CELLS)
@pytest.mark.parametrize("codec", ["fp8", "int8"])
def test_deployed_alphas_under_a_codec_match_reference(codec, arch, reduced, seq, batch,
                                                       n_chunks):
    """Under a codec α is planned at the link's effective rate, d2h_bw over
    the wire ratio, as the reference's ``resolve_cell`` does (a reference
    ``Hardware`` with the port's H100 numbers): equal α, and at least the
    uncompressed α on every chunk."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    cfg, jcfg = ((cfg.reduced(), jcfg.reduced()) if reduced else
                 (dataclasses.replace(cfg, n_layers=4), dataclasses.replace(jcfg, n_layers=4)))
    h100 = dataclasses.replace(jcm.V5E, name="h100", peak_flops_bf16=cm.H100.peak_flops_bf16,
                               hbm_bw=cm.H100.hbm_bw, d2h_bw=cm.H100.d2h_bw)
    ov = dict(pp=1, dp=1, n_chunks=n_chunks, offload_dtype=codec)
    got = runner.resolve_cell(cfg, ShapeConfig("t", seq, batch, "train"), overrides=ov)
    want = jrunner.resolve_cell(jbuild_model(jcfg), JShapeConfig("t", seq, batch, "train"),
                                data_size=1, model_size=1, overrides=ov, hw=h100)
    assert got.alphas == want.alphas
    raw = runner.resolve_cell(cfg, ShapeConfig("t", seq, batch, "train"),
                              overrides=dict(ov, offload_dtype="none"))
    assert all(c >= r for c, r in zip(got.alphas, raw.alphas))


def test_chunk_offload_keeps_scales_on_the_device_and_restores_rows():
    """``ChunkOffload.send`` puts only the payload on the link (int8 in the
    fp8 transport view) and keeps each row set's scales; ``restore`` gives
    back rows within the codec's resolution, in the sent dtype."""
    for codec, tol in (("fp8", 0.07), ("int8", 0.01)):
        link = ofl.Link(ahead=False)
        off = ofl.ChunkOffload(chunk=0, alpha=1.0, link=link, codec=codec)
        rows = [torch.randn(2, 5, 4, 8), torch.randn(2, 5, 24).to(torch.bfloat16)]
        hostmem.reset_counts()
        for t in rows:
            off.send(t)
        assert [h.tensor.dtype for h in link.host[0]] == [torch.float8_e4m3fn] * 2
        assert hostmem.counts()["d2h_bytes"] == sum(t.numel() for t in rows)
        assert [tuple(s.shape) for s, _ in off.scales] == [(2, 5, 4, 1), (2, 5, 1)]
        link.begin(0)
        back = list(off.restore(link.take(0)))
        assert off.scales == []
        for t, b in zip(rows, back):
            assert b.dtype == t.dtype and b.shape == t.shape
            err = (b.float() - t.float()).abs().amax(-1)
            assert bool((err <= tol * t.float().abs().amax(-1)).all())


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_residual_substitute_routes_the_gradient_to_the_computed_branch():
    x = torch.randn(3, 4, requires_grad=True)
    computed = x * 2.0
    staged = (x * 2.0).detach() + 1.0          # a different value, to tell them apart
    staged.requires_grad_()
    y = ofl.residual_substitute.apply(computed, staged)
    assert torch.equal(y, staged)
    gx, gs = torch.autograd.grad((y * 3.0).sum(), [x, staged], allow_unused=True)
    assert torch.equal(gx, torch.full((3, 4), 6.0)) and gs is None


def test_capture_and_inject_tags_split_and_restore_rows():
    t = torch.arange(2 * 10 * 3, dtype=torch.float32).view(2, 10, 3)
    for alpha, k in ((0.0, 0), (0.26, 3), (1.0, 10)):
        col = []
        assert ofl.CaptureTag(alpha, col)(t) is t
        kinds = [kind for kind, _ in col]
        assert kinds == (["keep"] if k == 0 else ["off"] if k == 10 else ["off", "keep"])
        off = [x.clone() for kind, x in col if kind == "off"]
        keep = [x.clone() for kind, x in col if kind == "keep"]
        assert sum(x.shape[1] for x in off) == k
        y = ofl.InjectTag(alpha, off, keep)(torch.zeros_like(t))
        assert torch.equal(y, t)
        inject = ofl.InjectTag(alpha, off, keep)
        assert torch.equal(inject.take(t.shape, t.dtype), t)
        with pytest.raises(ValueError, match="do not match"):
            ofl.InjectTag(alpha, off, keep).take((2, 10, 4), t.dtype)


def test_host_copies_on_the_cpu_are_separate_buffers():
    hostmem.reset_counts()
    t = torch.randn(2, 5, 3)
    h = hostmem.to_host(t[:, :2], 4)
    assert h.event is None and h.tensor.data_ptr() != t.data_ptr()
    assert torch.equal(h.tensor, t[:, :2])
    d = hostmem.to_device(h, 4)
    assert d.tensor.data_ptr() != h.tensor.data_ptr() and torch.equal(hostmem.wait(d), t[:, :2])
    # the rows' copies only: the moment channel's counters stay apart, at 0
    assert hostmem.counts() == {"d2h": 1, "d2h_bytes": 48, "d2h_pinned": 0, "h2d": 1,
                                "h2d_bytes": 48, **dict.fromkeys(hostmem.MOMENT_KEYS, 0)}
    assert hostmem.log() == [("d2h", 4), ("h2d", 4)]


def test_link_keeps_one_chunk_staged_ahead():
    link = ofl.Link(ahead=True)
    for c in range(3):
        link.send(c, torch.ones(1, 2))
    with pytest.raises(RuntimeError, match="not reloaded ahead"):
        link.take(2)
    link.prefetch(2)
    link.begin(2)
    link.prefetch(1)
    with pytest.raises(RuntimeError, match="already staged ahead"):
        link.prefetch(0)
    assert [t.shape for t in link.take(2)] == [(1, 2)]
    sync = ofl.Link(ahead=False)
    sync.send(0, torch.ones(3))
    sync.begin(0)
    assert torch.equal(sync.take(0)[0], torch.ones(3))


def test_offload_refusals():
    """Offload moves the rows remat "sppo" saves: with "none" or "full",
    in the "xla" form, or in a decode plan it is refused, as is a chunk
    that would offload without a link to send its rows through."""
    cfg = get_config("qwen2-7b").reduced()
    shape = ShapeConfig("t", 256, 2, "train")
    for ov in (dict(remat="none"), dict(remat="full"), dict(offload_mode="xla")):
        with pytest.raises(ValueError):
            runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, **ov))
    with pytest.raises(ValueError, match="decode"):
        runner.resolve_cell(cfg, ShapeConfig("d", 256, 2, "decode"),
                            overrides=dict(pp=1, dp=1, offload=True))
    with pytest.raises(ValueError, match="remat 'sppo'"):
        T.stage_apply(cfg, [], [], None, None, remat="none",
                      offload=ofl.ChunkOffload(chunk=0, alpha=0.5))
    with pytest.raises(ValueError, match="remat="):
        T.stage_apply(cfg, [], [], None, None, remat="selective")


def test_cli_default_plan_offloads_and_the_loss_falls():
    """The train CLI with no plan flag runs the reference's default plan
    (offload on, remat "sppo", prefetch "ahead") on the CPU: rows go to host
    and come back, and the loss falls."""
    hostmem.reset_counts()
    hist = train.main(["--reduced", "--steps", "10", "--seq", "512", "--batch", "4",
                       "--n-chunks", "4", "--device", "cpu", "--log-every", "5"])
    losses = [r["loss"] for r in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.2
    counts = hostmem.counts()
    assert counts["d2h_bytes"] == counts["h2d_bytes"] > 0
    assert _staged_ahead(hostmem.log()) == 1
