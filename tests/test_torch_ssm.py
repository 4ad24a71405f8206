"""The port's SSM mixers (``models/ssm.py``) and rwkv6-3b against the JAX
reference, on the CPU, at fp32.

- ``mamba2_mixer``, ``rwkv6_time_mix`` and ``rwkv6_channel_mix`` on the
  reduced configs' parameters (the reference's ``_mamba`` / ``_rwkv_tmix``
  / ``_rwkv_cmix`` draws), T 32 / 64 / 96 in 1-3 chunks through the
  carried state (the cases of tests/test_ssm.py, and T 3 in one-token
  chunks, the decode step's recurrence): the outputs and every carried
  state within 2e-5 of the reference's mixers, against the
  per-token recurrence of tests/test_ssm.py within its 2e-4 / 3e-4, and the
  gradients of x, of every leaf and of the incoming state within 1e-4 x
  max |reference| (``jax.vjp``);
- the reduced rwkv6-3b (2 layers) and the shared cases of
  tests/_torch_ssm_cases.py: the train step at S 384 in 3 chunks under
  remat "none", plan (b) (offload off, remat "sppo") and plan (d) (offload
  on, every chunk offloading rows), loss and every gradient and the
  parameters after one ``make_train_step``; D2H = H2D at the closed form
  of the RWKV6 tag shapes; static serving: the tokens of a prefill and 4
  greedy decode steps equal, the last hidden state within 1e-4 x max;
- the config and the parameters' shapes and markers leaf by leaf, the cost
  model's SSM branches equal to the reference's;
- what is refused: sp > 1 and pp > 1 (NotImplementedError naming ROADMAP
  Queue 1 item 7), MSP and the paged engine (ValueError), the mixers on a
  model axis.
"""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ssm_cases as C
import test_ssm as JT
from repro.configs.base import get_config as jget_config
from repro.models import ssm as JS
from repro.models.model_zoo import _mamba, _rwkv_cmix, _rwkv_tmix
from repro.parallel.ctx import SINGLE as JSINGLE
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import offload as ofl
from repro_torch.launch import serve, train
from repro_torch.models import ssm as S
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import runner
from repro_torch.runtime import hostmem, kvpool

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

ARCH = "rwkv6-3b"
TOL = 2e-5
# T and chunks: the cases of tests/test_ssm.py, and 3 one-token chunks (the
# decode step's path)
CASES = [(32, 1), (64, 2), (96, 3), (3, 3)]
B = 2


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@functools.lru_cache(maxsize=None)
def _mixer_params(kind):
    key = jax.random.PRNGKey(0)
    if kind == "mamba":
        cfg = jget_config("zamba2-7b").reduced()
        return cfg, C.to_np(_mamba(key, cfg, jnp.float32))
    cfg = jget_config(ARCH).reduced()
    return cfg, C.to_np(_rwkv_tmix(key, cfg, jnp.float32) if kind == "tmix"
                        else _rwkv_cmix(jax.random.PRNGKey(3), cfg, jnp.float32))


def _inputs(T, d, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, d)) * 0.5).astype(np.float32)


def _random_state(kind, seed=2):
    """An incoming state with every entry nonzero (the fp32 carry a chunk
    finds), as numpy, in the reference's field order."""
    cfg, _ = _mixer_params(kind)
    rng = np.random.default_rng(seed)
    init = (JS.mamba2_init_state(cfg, B, 1) if kind == "mamba"
            else JS.rwkv6_init_state(cfg, B, 1))
    return [(rng.standard_normal(a.shape) * 0.3).astype(np.float32) for a in init]


def _jax_mixer(kind, cfg):
    """(reference function of (x, p, state) -> (y, state), its state type)."""
    if kind == "mamba":
        return (lambda x, p, st: JS.mamba2_mixer(x, p, cfg, JSINGLE, st, subchunk=16),
                JS.MambaState)
    if kind == "tmix":
        return (lambda x, p, st: JS.rwkv6_time_mix(x, p, cfg, JSINGLE, st, subchunk=8),
                JS.RWKVState)
    return (lambda x, p, st: JS.rwkv6_channel_mix(x, p, cfg, JSINGLE, st), JS.RWKVState)


def _port_mixer(kind):
    if kind == "mamba":
        cfg = get_config("zamba2-7b").reduced()
        return (lambda x, p, st: S.mamba2_mixer(x, p, cfg, st, subchunk=16), S.MambaState)
    cfg = get_config(ARCH).reduced()
    if kind == "tmix":
        return (lambda x, p, st: S.rwkv6_time_mix(x, p, cfg, st, subchunk=8), S.RWKVState)
    return (lambda x, p, st: S.rwkv6_channel_mix(x, p, cfg, st), S.RWKVState)


def _chunks(fn, state_cls, x, p, st, n, cat):
    ys, cl = [], x.shape[1] // n
    st = state_cls(*st)
    for c in range(n):
        y, st = fn(x[:, c * cl:(c + 1) * cl], p, st)
        ys.append(y)
    return cat(ys), st


@pytest.mark.parametrize("kind", ["mamba", "tmix", "cmix"])
@pytest.mark.parametrize("T,n", CASES)
def test_mixer_and_its_states_match_the_reference(kind, T, n):
    jcfg, p = _mixer_params(kind)
    x = _inputs(T, jcfg.d_model)
    st0 = _random_state(kind)
    jfn, jcls = _jax_mixer(kind, jcfg)
    want, wst = _chunks(jfn, jcls, jnp.asarray(x), p, [jnp.asarray(a) for a in st0], n,
                        lambda ys: jnp.concatenate(ys, axis=1))
    tfn, tcls = _port_mixer(kind)
    got, gst = _chunks(tfn, tcls, _t(x), {k: _t(v) for k, v in p.items()},
                       [_t(a) for a in st0], n, lambda ys: torch.cat(ys, dim=1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert gst._fields == wst._fields
    for name, g, w in zip(gst._fields, gst, wst):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("T,n", CASES)
def test_mamba2_chunks_equal_the_per_token_recurrence(T, n):
    jcfg, p = _mixer_params("mamba")
    x = _inputs(T, jcfg.d_model)
    want, want_state = JT._mamba_ref(jnp.asarray(x), p, jcfg)
    tfn, tcls = _port_mixer("mamba")
    zero = S.mamba2_init_state(get_config("zamba2-7b").reduced(), B, "cpu")
    got, st = _chunks(tfn, tcls, _t(x), {k: _t(v) for k, v in p.items()}, list(zero), n,
                      lambda ys: torch.cat(ys, dim=1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(st.ssm.numpy(), np.asarray(want_state), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T,n", CASES)
def test_rwkv6_chunks_equal_the_per_token_recurrence(T, n):
    jcfg, p = _mixer_params("tmix")
    x = _inputs(T, jcfg.d_model)
    st0 = JS.rwkv6_init_state(jcfg, B, 1)
    want, want_state = JT._rwkv_ref_timemix(jnp.asarray(x), p, jcfg, st0)
    tfn, tcls = _port_mixer("tmix")
    zero = S.rwkv6_init_state(get_config(ARCH).reduced(), B, "cpu")
    got, st = _chunks(tfn, tcls, _t(x), {k: _t(v) for k, v in p.items()}, list(zero), n,
                      lambda ys: torch.cat(ys, dim=1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(st.wkv.numpy(), np.asarray(want_state), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("kind", ["mamba", "tmix", "cmix"])
@pytest.mark.parametrize("T,n", [(64, 2), (96, 3)])
def test_mixer_gradients_match_jax(kind, T, n):
    """d/d(x, every leaf, the incoming state) of <y, dy> + <state', ds'>
    over n chunks, the state carried between them."""
    jcfg, p = _mixer_params(kind)
    x = _inputs(T, jcfg.d_model)
    st0 = _random_state(kind)
    rng = np.random.default_rng(9)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dst = [rng.standard_normal(a.shape).astype(np.float32) for a in st0]
    jfn, jcls = _jax_mixer(kind, jcfg)

    def jloss(xx, pp, st):
        y, s2 = _chunks(jfn, jcls, xx, pp, st, n, lambda ys: jnp.concatenate(ys, axis=1))
        return jnp.sum(y * dy) + sum(jnp.sum(a * b) for a, b in zip(s2, dst))

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), p, [jnp.asarray(a) for a in st0])
    tfn, tcls = _port_mixer(kind)
    tx = _t(x).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    tst = [_t(a).requires_grad_() for a in st0]
    y, s2 = _chunks(tfn, tcls, tx, tp, tst, n, lambda ys: torch.cat(ys, dim=1))
    loss = (y * _t(dy)).sum() + sum((a * _t(b)).sum() for a, b in zip(s2, dst))
    loss.backward()
    pairs = [("x", tx.grad, want[0])] + [(k, tp[k].grad, want[1][k]) for k in p]
    pairs += [(f"state {i}", t.grad, w) for i, (t, w) in enumerate(zip(tst, want[2]))]
    for name, got, w in pairs:
        w = np.asarray(w)
        got = np.zeros_like(w) if got is None else got.numpy()
        err = np.abs(got - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30), f"{kind} {name}: {err}"


def test_mixers_refuse_the_model_axis():
    cfg = get_config(ARCH).reduced()
    _, p = _mixer_params("tmix")
    ctx = types.SimpleNamespace(sp=2)     # a model axis of two ranks, as the mixers see it
    st = S.rwkv6_init_state(cfg, B, "cpu")
    x = torch.zeros((B, 8, cfg.d_model))
    for fn in (lambda: S.rwkv6_time_mix(x, {k: _t(v) for k, v in p.items()}, cfg, st, ctx=ctx),
               lambda: S._shard_token_shift(x, st.shift_t, ctx),
               lambda: S._compose_states(st.wkv, st.wkv[..., 0], st.wkv, ctx)):
        with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
            fn()


# ---------------------------------------------------------------------------
# the config, the parameters, the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_the_reference_field_by_field(arch, reduced):
    jcfg, cfg = jget_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want, got = dataclasses.asdict(jcfg), dataclasses.asdict(cfg)
    assert got == want


@pytest.mark.parametrize("arch", [ARCH])
def test_params_and_markers_match_the_reference_leaf_by_leaf(arch):
    """rwkv6-3b's (zamba2-7b's in tests/test_torch_hybrid.py)."""
    C.check_params_and_markers(arch)


def test_build_model_slot_counts_and_ghost_mixers():
    """rwkv6-3b builds 32 slots, zamba2-7b 14 (81 mixers in groups of 6,
    the last slot's 3 mixers past the 81st at gate 0); both resolve train,
    prefill and decode cells at sp = pp = 1."""
    assert build_model("rwkv6-3b").n_slots == 32
    z = build_model("zamba2-7b")
    assert z.n_slots == 14
    stage = z.init_stage_params(torch.Generator(), device="meta")
    assert len(stage) == 14 and tuple(stage[0]["mamba"]["mix"]["in_x"].shape) == (6, 3584, 7168)
    small = build_model(C.tcfg("zamba2-7b"))
    gates = [s["mamba"]["gate"].tolist()
             for s in small.init_stage_params(torch.Generator(), torch.float32, "cpu")]
    assert gates == [[1.0, 1.0], [1.0, 1.0], [1.0, 0.0]]
    for arch in ("rwkv6-3b", "zamba2-7b"):
        for kind in ("train", "prefill", "decode"):
            cell = runner.resolve_cell(arch, ShapeConfig("c", 8192, 1, kind),
                                       overrides=dict(pp=1, dp=1))
            assert (cell.plan.sp, cell.plan.pp) == (1, 1)


@pytest.mark.parametrize("arch", [ARCH])
def test_costmodel_ssm_branches_match_the_reference(arch):
    """rwkv6-3b's (zamba2-7b's in tests/test_torch_hybrid.py)."""
    C.check_costmodel(arch)


# ---------------------------------------------------------------------------
# the reduced rwkv6-3b: the train step, serving, what is refused
# ---------------------------------------------------------------------------


def rwkv_offload_elems(cell) -> int:
    """Elements of a step's off rows by the RWKV6 tag shapes: per chunk and
    layer, split_rows of the chunk's rows of the time-mix output [d] and
    the channel-mix hidden [d_ff]."""
    cfg = cell.cfg
    return cfg.n_layers * sum(ofl.split_rows(ln, a) * C.B * (cfg.d_model + cfg.d_ff)
                              for ln, a in zip(cell.sched.lengths, cell.alphas))


PLANS = {"none": dict(offload=False, remat="none"), "b": dict(offload=False, remat="sppo"),
         "d": {}}


@pytest.mark.parametrize("plan", list(PLANS))
def test_train_step_matches_the_reference(plan):
    ref = C.jax_train(ARCH)
    cell = C.port_cell(ARCH, **PLANS[plan])
    if plan == "d":
        assert (cell.plan.offload, cell.plan.remat, cell.plan.prefetch) == (True, "sppo", "ahead")
        cell = dataclasses.replace(cell, alphas=(0.6, 1.0, 0.0))
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    tokens, labels = torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["labels"])
    hostmem.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, tokens, labels)
    copied = hostmem.counts()
    n_bytes = rwkv_offload_elems(cell) * 4
    assert copied["d2h_bytes"] == copied["h2d_bytes"] == n_bytes
    assert (n_bytes > 0) == (plan == "d")
    step = runner.make_train_step(cell, lr_kwargs=C.LR)
    new, _, met = step(params, runner.init_opt_state(cell, params), tokens, labels)
    C.check_step(ARCH, cell, loss, grads, dict(loss=met["loss"], params=new))


def test_static_serving_matches_the_reference():
    ref = C.jax_serve(ARCH)
    got = C.port_serve(ref, ARCH)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    err = np.abs(got["last"] - ref["last"]).max()
    assert err <= 1e-4 * np.abs(ref["last"]).max(), err
    # the recurrent state after decoding, slot by slot
    for j, s in enumerate(got["state"]):
        for name in ("wkv", "shift_t", "shift_c"):
            want = getattr(ref["state"]["rwkv"], name)[0, j]
            got_t = getattr(s["rwkv"], name).numpy()
            assert np.abs(got_t - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0), name


def test_serve_and_train_clis_take_rwkv():
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len", "128",
                      "--batch", "2", "--decode-steps", "2"])
    tokens = np.asarray(out["tokens"])
    assert tokens.shape == (2, 2) and ((tokens >= 0) & (tokens < 256)).all()
    hist = train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq", "256",
                       "--batch", "2", "--n-chunks", "2", "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_recurrent_families_refuse_what_later_slices_bring(arch):
    """sp > 1 and pp > 1 raise NotImplementedError naming ROADMAP Queue 1
    item 7 (train, prefill, decode); MSP, which re-runs a chunk a recurrent
    state cannot absorb, and the paged engine raise ValueError, as the
    reference asserts."""
    cfg = get_config(arch).reduced()
    for kind in ("train", "prefill", "decode"):
        for kw in (dict(sp=2), dict(pp=2)):
            with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
                runner.resolve_cell(cfg, ShapeConfig("t", 256, 2, kind),
                                    data_size=kw.get("pp", 1), model_size=kw.get("sp", 1),
                                    overrides=dict(n_chunks=2, dp=1, **kw))
    with pytest.raises(ValueError, match="msp unsupported"):
        runner.resolve_cell(cfg, ShapeConfig("t", 256, 2, "train"), data_size=2,
                            overrides=dict(pp=2, dp=1, n_chunks=2, msp=True))
    dec = runner.resolve_cell(cfg, ShapeConfig("d", 256, 2, "decode"), overrides=dict(pp=1, dp=1))
    geo = kvpool.PoolGeometry(s_bucket=256, sp=1, max_new=4, block_tokens=4, n_blocks=8,
                              n_slots=2)
    with pytest.raises(ValueError, match="dense GQA"):
        runner.check_pool_cell(dec, geo)
    with pytest.raises(ValueError, match="dense GQA"):
        serve.ServeEngine(cfg, (1, 1), s_bucket=64, slots=2, max_new=2, device="cpu")
