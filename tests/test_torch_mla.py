"""The port's MLA (deepseek-v3-671b: multi-head latent attention in the
absorbed form, on the MoE family) against the JAX reference, on the CPU.

The reduced deepseek-v3 (2 layers, d 64, 4 heads, q_lora 32, kv_lora 16,
rope 8, nope 16, v 16: q_eff and the latent 24 wide, v 16; 4 experts,
top-2, one shared) at fp32.  What is held, and how:

- the config field by field, the reduced model's parameter shapes and
  shard markers leaf by leaf;
- ``attention.mla_attention`` on one slot's parameters: one prefill chunk,
  three chunks through the serving cache (with a packed document window)
  and a decode step: outputs and the cache's latent within 1e-5; through
  the training cache, the gradients of x and of every MLA leaf within
  1e-5 x max |reference|;
- the port's plain ``attention_partial`` at deepseek-v3's own widths (hd_k
  576, hd_v 512, G 128, v the first 512 columns of k, a view) against the
  reference's jnp path and its Pallas kernel in interpret mode, forward
  and gradients (the kv gradient sums dk and dv through the view);
- the train step (2 chunks) with offload off and under the default plan:
  loss and every gradient at 1e-5 against the reference's
  ``run_pipeline`` plus its balance term, the default plan's D2H = H2D at
  the closed form of MLA's and the MoE block's tag shapes;
- static serving: prefill and greedy decode, tokens and positions exact,
  the latent and the last hidden state at 1e-5;
- AdamW with bf16 moments against the reference's update;
- the cost model's MLA branches and bf16 moment bytes.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_serve as TS
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.core import costmodel as jcm
from repro.kernels import ops as jkops
from repro.models import attention as JA
from repro.models.model_zoo import build_model as jbuild_model
from repro.models.model_zoo import init_slot_state as jinit_slot_state
from repro.optim import adamw as jadamw
from repro.parallel import runner as jrunner
from repro.parallel import specs as jspecs
from repro.parallel.ctx import SINGLE as JSINGLE
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import offload as ofl
from repro_torch.core import tree
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.models.moe import capacities, moe_dims
from repro_torch.optim import adamw
from repro_torch.parallel import runner
from repro_torch.runtime import hostmem

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

ARCH = "deepseek-v3-671b"
S, B, N = 256, 2, 2
TOL = 1e-5
ALPHAS = (0.6, 0.0)   # the default plan's rows: fractional / reserved
MLA_LEAVES = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "w_uk", "w_uv", "wo")


def _to_np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = jget_config(ARCH).reduced()
    mdef = jbuild_model(cfg)
    key = jax.random.PRNGKey(0)
    params = {"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
              "globals": mdef.init_globals(key, jnp.float32)}
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, -1] = -1
    labels[1, 60:90] = -1
    return _to_np(params), tokens, labels


# ---------------------------------------------------------------------------
# the config and its parameters
# ---------------------------------------------------------------------------


def test_config_matches_the_reference_field_by_field():
    for reduced in (False, True):
        jcfg, cfg = jget_config(ARCH), get_config(ARCH)
        if reduced:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        want, got = dataclasses.asdict(jcfg), dataclasses.asdict(cfg)
        assert got.keys() == want.keys()
        for field in want:
            assert got[field] == want[field], field
    full = get_config(ARCH)
    m = full.mla
    assert (m.kv_lora_rank + m.rope_head_dim, m.kv_lora_rank, full.n_heads) == (576, 512, 128)


def test_reduced_params_and_specs_match_the_reference_leaf_by_leaf():
    jparams, _, _ = _jax_params()
    cfg = get_config(ARCH).reduced()
    mdef = build_model(cfg)
    mine = {"stages": mdef.init_stage_params(torch.Generator(), torch.float32, "meta"),
            "globals": mdef.init_globals(torch.Generator(), torch.float32, "meta")}
    # the port's stage is a list of slots; the reference stacks them
    for j, slot in enumerate(mine["stages"]):
        for path, t in tree.items(slot):
            want = jparams["stages"]
            for k in path.split("/"):
                want = want[k]
            assert tuple(t.shape) == want.shape[1:], path
    assert {p for p, _ in tree.items(mine["stages"][0]["attn"])} == set(MLA_LEAVES)
    for path, t in tree.items(mine["globals"]):
        want = jparams["globals"]
        for k in path.split("/"):
            want = want[k]
        assert tuple(t.shape) == want.shape, path
    jmdef = jbuild_model(jget_config(ARCH).reduced())
    jspec = jmdef.stage_spec()
    for path, marker in tree.items(mdef.stage_spec()):
        want = jspec
        for k in path.split("/"):
            want = want[k]
        assert marker == want, path
    params = params_from_numpy(jparams, dtype=torch.float32, device="cpu")
    got = dict(tree.items(params["stages"][1]["attn"]))
    for name in MLA_LEAVES:
        np.testing.assert_array_equal(got[name].numpy(), jparams["stages"]["attn"][name][1])


# ---------------------------------------------------------------------------
# mla_attention
# ---------------------------------------------------------------------------

CHUNKS = (24, 32, 40)         # three chunks through the cache
CACHE = sum(CHUNKS) + 8       # room for the decode token


def _doc_start():
    """A packed layout's document window: row 0 holds documents [0, 30) and
    [30, 96), row 1 one document."""
    pos = np.arange(sum(CHUNKS))
    return np.stack([np.where(pos < 30, 0, 30), np.zeros_like(pos)]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _mla_case():
    jparams, _, _ = _jax_params()
    p = {k: jparams["stages"]["attn"][k][0] for k in MLA_LEAVES}
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, sum(CHUNKS), cfg.d_model)).astype(np.float32)
    x_dec = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, sum(CHUNKS), cfg.d_model)).astype(np.float32)
    return p, x, x_dec, dy


def _jax_mla_chunks(p, x, q_start=None):
    """The reference's three chunks through its cache: (outputs, cache)."""
    jcfg = jget_config(ARCH).reduced()
    cache = jinit_slot_state(jcfg, JSINGLE, B, CACHE, jnp.float32)["kv"]
    ys, off = [], 0
    for ln in CHUNKS:
        qs = None if q_start is None else q_start[:, off:off + ln]
        y, cache = JA.mla_attention(x[:, off:off + ln], p, jcfg, JSINGLE, cache,
                                    jnp.arange(off, off + ln, dtype=jnp.int32), off,
                                    off + ln, q_start=qs)
        ys.append(y)
        off += ln
    return jnp.concatenate(ys, axis=1), cache


def _port_mla_chunks(p, x, *, train, q_start=None):
    cfg = get_config(ARCH).reduced()
    m = cfg.mla
    cache = A.init_latent_cache(B, CACHE, m.kv_lora_rank, m.rope_head_dim, torch.float32,
                                "cpu", train=train)
    ys, off = [], 0
    for ln in CHUNKS:
        q_pos = torch.arange(off, off + ln, dtype=torch.int32)
        qs = None if q_start is None else q_start[:, off:off + ln]
        y, cache = A.mla_attention(x[:, off:off + ln], p, cfg, cache, q_pos, off, off + ln,
                                   runner._rope(cfg, q_pos), q_start=qs)
        ys.append(y)
        off += ln
    return torch.cat(ys, dim=1), cache


def test_mla_one_prefill_chunk_matches_the_reference():
    p, x, _, _ = _mla_case()
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    T = CHUNKS[0]
    jcache = jinit_slot_state(jcfg, JSINGLE, B, CACHE, jnp.float32)["kv"]
    want, jcache = JA.mla_attention(jnp.asarray(x[:, :T]), p, jcfg, JSINGLE, jcache,
                                    jnp.arange(T, dtype=jnp.int32), 0, T)
    m = cfg.mla
    cache = A.init_latent_cache(B, CACHE, m.kv_lora_rank, m.rope_head_dim, torch.float32, "cpu")
    assert cache.v.data_ptr() == cache.k.data_ptr() and cache.v.shape[-1] == m.kv_lora_rank
    q_pos = torch.arange(T, dtype=torch.int32)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    got, cache = A.mla_attention(torch.from_numpy(x[:, :T]), tp, cfg, cache, q_pos, 0, T,
                                 runner._rope(cfg, q_pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))


@pytest.mark.parametrize("packed", [False, True])
def test_mla_three_chunks_and_a_decode_step_match_the_reference(packed):
    p, x, x_dec, _ = _mla_case()
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    qs = _doc_start() if packed else None
    want, jcache = _jax_mla_chunks(p, jnp.asarray(x), None if qs is None else jnp.asarray(qs))
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    got, cache = _port_mla_chunks(tp, torch.from_numpy(x), train=False,
                                  q_start=None if qs is None else torch.from_numpy(qs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
    # a decode step at position 96, written at slot 96, attending the whole cache
    pos = sum(CHUNKS)
    want_d, jcache = JA.mla_attention(jnp.asarray(x_dec), p, jcfg, JSINGLE, jcache,
                                      jnp.array([pos], jnp.int32), None, None, decode=True,
                                      my_slot=jnp.int32(pos))
    q_pos = torch.tensor([pos], dtype=torch.int32)
    got_d, cache = A.mla_decode_attention(torch.from_numpy(x_dec), tp, cfg, cache, q_pos, pos,
                                          runner._rope(cfg, q_pos))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))


def test_mla_gradients_through_the_training_cache_match_the_reference():
    p, x, _, dy = _mla_case()
    qs = _doc_start()

    def f(pj, xj):
        return _jax_mla_chunks(pj, xj, jnp.asarray(qs))[0]

    want_y, vjp = jax.vjp(f, p, jnp.asarray(x))
    want_dp, want_dx = vjp(jnp.asarray(dy))
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    got_y, cache = _port_mla_chunks(tp, tx, train=True, q_start=torch.from_numpy(qs))
    assert len(cache.chunks) == len(CHUNKS)
    assert all(v.data_ptr() == k.data_ptr() for k, v in cache.chunks)  # v: a view of k
    np.testing.assert_allclose(got_y.detach().numpy(), np.asarray(want_y), rtol=TOL, atol=TOL)
    got_y.backward(torch.from_numpy(dy))
    for name, got, want in [("x", tx.grad, want_dx)] + [
            (k, tp[k].grad, want_dp[k]) for k in MLA_LEAVES]:
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= TOL * max(1.0, np.abs(want).max()), f"{name}: {err}"


# ---------------------------------------------------------------------------
# the plain attention_partial at deepseek-v3's widths
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _wide_case():
    rng = np.random.default_rng(11)
    Bw, Tq, Sw, H = 1, 3, 40, 128
    q = rng.standard_normal((Bw, Tq, H, 576)).astype(np.float32)
    kv = rng.standard_normal((Bw, Sw, 1, 576)).astype(np.float32)
    q_pos = np.arange(Sw - Tq, Sw, dtype=np.int32)
    kv_pos = np.arange(Sw, dtype=np.int32)
    kv_pos[-1] = 2**30                              # a PAD slot
    do = rng.standard_normal((Bw, Tq, H, 512)).astype(np.float32)
    dl = rng.standard_normal((Bw, Tq, H)).astype(np.float32)
    return q, kv, q_pos, kv_pos, do, dl


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_plain_partial_at_mla_widths_matches_the_reference(backend):
    q, kv, q_pos, kv_pos, do, dl = _wide_case()
    scale = 1 / 192 ** 0.5

    def f(qj, kvj):
        return jkops.attention_partial(qj, kvj, kvj[..., :512], jnp.asarray(q_pos),
                                       jnp.asarray(kv_pos), causal=True, scale=scale)

    with jkops.backend(backend):
        (wo, wm, wl), vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(kv))
        wdq, wdkv = vjp((jnp.asarray(do), jnp.zeros_like(wm), jnp.asarray(dl)))
    tq = torch.from_numpy(q).requires_grad_()
    tkv = torch.from_numpy(kv).requires_grad_()
    o, m, l = ops.attention_partial(tq, tkv, tkv[..., :512], torch.from_numpy(q_pos),
                                    torch.from_numpy(kv_pos), causal=True, scale=scale)
    for name, got, want in (("o", o, wo), ("m", m, wm), ("l", l, wl)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL,
                                   err_msg=name)
    torch.autograd.backward([o, l], [torch.from_numpy(do), torch.from_numpy(dl)])
    for name, got, want in (("dq", tq.grad, wdq), ("dkv", tkv.grad, wdkv)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= TOL * max(1.0, np.abs(want).max()), f"{name}: {err}"


# ---------------------------------------------------------------------------
# the train step and the offload seam
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_oracle():
    params, tokens, labels = _jax_params()
    mdef = jbuild_model(jget_config(ARCH).reduced())
    cell = dataclasses.replace(jrunner.resolve_cell(
        mdef, JShapeConfig("t", S, B, "train"), data_size=1, model_size=1,
        overrides=dict(pp=1, dp=1, n_chunks=N, partition="length", grad_accum=1,
                       offload=False, remat="none")), dtype=jnp.float32)
    w = 0.01 / (cell.sched.n * mdef.n_slots)

    def loss_fn(p):
        out = jrunner.run_pipeline(cell, JSINGLE, p["stages"], p["globals"],
                                   jnp.asarray(tokens), jnp.asarray(labels), None,
                                   with_loss=True)
        return out["loss"] / jnp.maximum(out["denom"], 1.0) + w * out["aux"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    return dict(loss=float(loss), grads=_to_np(grads), lengths=cell.sched.lengths)


def _cell(**kw):
    return runner.resolve_cell(get_config(ARCH).reduced(), ShapeConfig("t", S, B, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=N, grad_accum=1,
                                              partition="length", **kw),
                               dtype=torch.float32)


def mla_offload_elems(cell) -> int:
    """Elements of a step's off rows by the tag shapes of an MLA + MoE
    layer: per chunk and layer, split_rows of the chunk's rows of q_eff [H,
    dc + dr], k_eff [dc + dr], o_v [H, dv] and the shared experts' hidden,
    and of the routed experts' hidden [E, Ce, ff] split along its Ce rows."""
    cfg = cell.cfg
    m, moe = cfg.mla, cfg.moe
    eff = m.kv_lora_rank + m.rope_head_dim
    per_row = (cfg.n_heads * eff + eff + cfg.n_heads * m.v_head_dim
               + moe.n_shared_experts * moe.d_ff_expert)
    _, e_loc = moe_dims(cfg, 1)
    total = 0
    for ln, a in zip(cell.sched.lengths, cell.alphas):
        _, ce = capacities(cfg, B * ln, 1)
        total += ofl.split_rows(ln, a) * B * per_row + e_loc * ofl.split_rows(ce, a) * moe.d_ff_expert
    return total * cfg.n_layers


@pytest.mark.parametrize("plan", ["offload_off", "default"])
def test_train_step_matches_the_reference(plan):
    ref = _jax_oracle()
    assert ref["lengths"] == (128,) * N
    if plan == "default":
        cell = dataclasses.replace(_cell(), alphas=ALPHAS)
        assert (cell.plan.offload, cell.plan.remat, cell.plan.prefetch) == (True, "sppo", "ahead")
    else:
        cell = _cell(offload=False, remat="none")
    jparams, tokens, labels = _jax_params()
    params = params_from_numpy(jparams, dtype=torch.float32, device="cpu")
    hostmem.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, torch.from_numpy(tokens),
                                        torch.from_numpy(labels))
    copied = hostmem.counts()
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=0, atol=TOL)
    for j, slot in enumerate(grads["stages"]):
        for path, got in tree.items(slot):
            if path == "gate":   # a structural constant in the port (tests/test_torch_moe.py)
                assert (got == 0).all()
                continue
            want = ref["grads"]["stages"]
            for k in path.split("/"):
                want = want[k]
            np.testing.assert_allclose(got.numpy(), want[j], rtol=0, atol=TOL,
                                       err_msg=f"{plan} slot {j} {path}")
    for path, got in tree.items(grads["globals"]):
        want = ref["grads"]["globals"]
        for k in path.split("/"):
            want = want[k]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL, err_msg=path)
    if plan == "default":
        want = mla_offload_elems(cell) * 4
        assert want > 0 and copied["d2h_bytes"] == copied["h2d_bytes"] == want
    else:
        assert copied["d2h_bytes"] == copied["h2d_bytes"] == 0


def test_mla_refuses_the_model_axis_and_pipeline_stages():
    for kw in (dict(sp=2), dict(pp=2)):
        with pytest.raises(NotImplementedError, match="item 7"):
            runner.resolve_cell(get_config(ARCH).reduced(), ShapeConfig("t", S, B, "train"),
                                data_size=kw.get("pp", 1), model_size=kw.get("sp", 1),
                                overrides=dict(n_chunks=N, **kw), dtype=torch.float32)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_static_serving_matches_the_reference():
    ref = TS._jax_run(ARCH)
    got = TS._torch_run(ref, ARCH)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    for state in ("state_pre", "state_dec"):
        # the reference's v is a placeholder: the latent is k
        np.testing.assert_allclose(got[state]["k"], ref[state]["k"], rtol=TOL, atol=TOL,
                                   err_msg=state)
        np.testing.assert_array_equal(got[state]["pos"], ref[state]["pos"])
    np.testing.assert_allclose(got["last"], ref["last"], rtol=TOL, atol=TOL)


def test_serve_cli_takes_deepseek():
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len", "128",
                      "--batch", "2", "--decode-steps", "2"])
    tokens = np.asarray(out["tokens"])
    assert tokens.shape == (2, 2) and ((tokens >= 0) & (tokens < 256)).all()


# ---------------------------------------------------------------------------
# AdamW with bf16 moments, the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offload_moments", [False, True])
def test_adamw_bf16_moments_match_the_reference(offload_moments):
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((24, 40)).astype(np.float32),
              "b": rng.standard_normal((40,)).astype(np.float32)}
    grads = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
             for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    js = jadamw.init_state(jp, jnp.bfloat16)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    ts = adamw.init_state(tp, opt_dtype="bfloat16", offload_moments=offload_moments)
    assert all(t.dtype == torch.bfloat16 for t in tree.leaves([ts.m, ts.v]))
    for _ in range(3):
        jp, js, _ = jadamw.apply_update(jp, jg, js, lr=1e-2)
        tp, ts, _ = adamw.apply_update(tp, tg, ts, lr=1e-2, offload_moments=offload_moments)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
        for got, want in ((ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            got, want = got.float().numpy(), np.asarray(want, np.float32)
            # the same fp32 update rounded to bf16: equal, or one bf16 ulp
            # where the fp32 values straddle a rounding boundary
            np.testing.assert_allclose(got, want, rtol=2**-8, atol=0)
            assert (got == want).mean() > 0.99
    with pytest.raises(ValueError, match="opt_dtype"):
        adamw.init_state(tp, opt_dtype="float16")


def test_costmodel_mla_branches_match_the_reference():
    for reduced in (False, True):
        jcfg, cfg = jget_config(ARCH), get_config(ARCH)
        if reduced:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert cm.tagged_bytes_per_token(cfg) == jcm.tagged_bytes_per_token(jcfg)
        assert cm.tagged_scale_elems_per_token(cfg) == jcm.tagged_scale_elems_per_token(jcfg)
        assert cm.kv_bytes_per_token(cfg) == jcm.kv_bytes_per_token(jcfg)
        assert cm.count_active_params(build_model(cfg), 1) == \
            jspecs.count_active_params(jbuild_model(jcfg), 1, 1)
    for dtype in ("float32", "bfloat16"):
        assert cm.moment_bytes_per_param(dtype) == jcm.moment_bytes_per_param(dtype)
        shapes = [(7, 5), (3,)]
        assert cm.moment_bytes_from_shapes(shapes, dtype) == \
            jcm.moment_bytes_from_shapes(shapes, dtype)
    assert get_config(ARCH) and runner.resolve_cell(
        get_config(ARCH), ShapeConfig("t", 8192, 1, "train"),
        overrides=dict(pp=1, dp=1, n_chunks=4)).plan.opt_dtype == "bfloat16"
