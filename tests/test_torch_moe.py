"""The port's MoE family (granite-moe-1b-a400m: GQA, a routed expert block,
a tied embedding) against the JAX reference, on the CPU.

The reduced granite (2 layers, d 64, 4 experts, top-2, FFN 32) at fp32.
What is held, and how:

- ``moe_block`` against the reference's at the reduced granite and the
  reduced deepseek-v3's MoE config (a shared expert), at capacity factor 8
  (no copy dropped) and 0.5 (copies dropped): the output within 2e-5, the
  balance loss, the expert ids exactly, and the gradients of x and of every
  leaf through ``jax.vjp`` within 1e-5 x max |leaf|;
- the train step at pp = 1, S = 256 in 2 chunks, with offload off and
  under the default plan (offload on, remat "sppo", prefetch "ahead"):
  loss and every gradient against the reference's ``value_and_grad`` of
  ``run_pipeline`` plus its balance term (``make_train_step``'s
  ``0.01 · aux / (data_size · pods · sp · n_chunks · n_slots)``) at 1e-5.
  The slot gate is the one leaf held apart: the reference's ``aux · gate``
  hands it a gradient although its docstring calls the gate a structural
  constant; the port keeps it a constant (no gradient);
- pp = 2 plain and with MSP (2 ranks), dp = 2 x pp = 2 (4 ranks): loss and
  every gradient at 1e-5 against the reference's single-device
  ``run_pipeline`` on each dp group's rows with the balance term at
  data_size = dp x pp (the function the reference's pp = 2 step computes;
  tests/test_pipeline_equivalence.py holds that step to the single device
  within 3e-4).  The tied table is used by stage 0 (embedding) and the last
  stage (head): its gradient is all-reduced over the stages;
- sp = 2 expert parallelism (2 ranks): loss and every gradient, gathered
  to full leaves, at 1e-5 against the reference's own sp = 2 program run
  under ``jax.vmap`` over a named model axis (its collectives, the
  all-to-all included, then act on the vmapped axis, and ``jax.grad``
  gives the gradient of the global loss; its loss is the reference's
  ``shard_map`` loss at data 1 x model 2).  The drop set depends on the
  expert-parallel width, so sp = 1 is no oracle here.  The all-to-alls'
  calls and bytes are held to their closed form;
- static serving (prefill, greedy decode) against the reference's
  (tests/test_torch_serve.py's harness): caches and the last hidden state
  at 1e-5, tokens identical.

The ranks run ``tests/_torch_moe_workers.py`` (no JAX); every spawn has a
deadline.
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
from repro.models import moe as JM
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel import runner as jrunner
from repro.parallel.ctx import SINGLE as JSINGLE
from repro.parallel.ctx import Ctx as JCtx
from repro_torch.configs.base import MLAConfig, MoEConfig, ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import tree
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch import mesh
from repro_torch.models import moe as M
from repro_torch.models.convert import gather_model_shards, params_from_numpy
from repro_torch.models.model_zoo import build_model, marker_dim
from repro_torch.parallel import runner

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)
import _torch_moe_workers as W  # noqa: E402

ARCH = W.ARCH
S, B, N = 256, 2, 2
TOL = 1e-5
Y_TOL = 2e-5
DEADLINE_S = 400.0
ALPHAS = (0.6, 0.0)   # the default plan's rows: fractional / reserved
LAYOUTS_2 = {
    "pp2": dict(pp=2, n_chunks=N, S=S, B=B),
    "pp2_msp": dict(pp=2, n_chunks=N, S=S, B=B, msp=True),
    "sp2": dict(sp=2, n_chunks=N, S=S, B=B),
    "sp2_remat_none": dict(sp=2, n_chunks=N, S=S, B=B, plan=dict(offload=False, remat="none")),
}
LAYOUTS_4 = {"dp2_pp2": dict(dp=2, pp=2, n_chunks=N, S=S, B=B)}
LAYOUTS = {**LAYOUTS_2, **LAYOUTS_4}


def _batch(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, -1] = -1
    labels[1, 60:90] = -1            # the label sentinel: no loss there
    return tokens, labels


def _to_np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


@functools.lru_cache(maxsize=None)
def _jax_params():
    cfg = jget_config(ARCH).reduced()
    mdef = jbuild_model(cfg)
    key = jax.random.PRNGKey(0)
    params = {"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
              "globals": mdef.init_globals(key, jnp.float32)}
    return params, _batch(cfg.vocab_size)


def _jcell(model_size=1):
    mdef = jbuild_model(jget_config(ARCH).reduced())
    cell = jrunner.resolve_cell(
        mdef, JShapeConfig("t", S, B, "train"), data_size=1, model_size=model_size,
        overrides=dict(pp=1, dp=1, n_chunks=N, partition="length", grad_accum=1,
                       offload=False, remat="none"))
    return mdef, dataclasses.replace(cell, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _jax_step(n_groups: int):
    """The jitted reference loss and gradients over ``n_groups`` dp groups
    of rows: its single-device ``run_pipeline`` on each group's rows
    (vmapped over the groups), the token losses over the token count of all
    of them, plus ``w`` times the summed balance loss."""
    mdef, cell = _jcell()

    def loss_fn(p, toks, labs, w):
        def one(tok, lab):
            out = jrunner.run_pipeline(cell, JSINGLE, p["stages"], p["globals"], tok, lab,
                                       None, with_loss=True)
            return out["loss"], out["denom"], out["aux"]

        num, den, aux = jax.vmap(one)(toks, labs)
        return jnp.sum(num) / jnp.maximum(jnp.sum(den), 1.0) + w * jnp.sum(aux)

    return jax.jit(jax.value_and_grad(loss_fn)), cell.sched, mdef.n_slots


@functools.lru_cache(maxsize=None)
def _jax_oracle(dp: int, pp: int):
    """The reference's loss and gradients of the dp x pp step: the balance
    term at data_size = dp x pp (``make_train_step``'s)."""
    params, (tokens, labels) = _jax_params()
    fn, sched, n_slots = _jax_step(dp)
    lay = shard_batch(tokens, labels, pods=1, data_size=dp * pp, pp=pp)
    rows = [g * pp for g in range(dp)]
    loss, grads = fn(params, jnp.asarray(lay["tokens"][0, rows]),
                     jnp.asarray(lay["labels"][0, rows]),
                     jnp.float32(0.01 / (dp * pp * sched.n * n_slots)))
    return dict(params=_to_np(params), grads=_to_np(grads), loss=float(loss),
                tokens=tokens, labels=labels, lengths=sched.lengths)


@functools.lru_cache(maxsize=None)
def _jax_sp_oracle(sp: int = 2):
    """The reference's sp = ``sp`` step, loss and gradients: its
    ``run_pipeline`` on each model rank's shards under ``jax.vmap`` over the
    named model axis (the collectives act on it), the loss the
    ``psum_loss_all`` sums of ``make_train_step``."""
    params, (tokens, labels) = _jax_params()
    mdef, cell = _jcell(model_size=sp)
    spec = {"stages": mdef.stage_spec(), "globals": mdef.globals_spec()}

    def body(p, _):
        ctx = JCtx(model_axis="model", sp=sp, attn_mode=cell.plan.attn_mode)
        r = ctx.model_index()

        def shard(t, m, lead):
            d = marker_dim(m)
            if d is None:
                return t
            n = t.shape[d + lead] // sp
            return jax.lax.dynamic_slice_in_dim(t, r * n, n, axis=d + lead)

        st = jax.tree_util.tree_map(lambda t, m: shard(t, m, 1), p["stages"], spec["stages"])
        gl = jax.tree_util.tree_map(lambda t, m: shard(t, m, 0), p["globals"], spec["globals"])
        out = jrunner.run_pipeline(cell, ctx, st, gl, jnp.asarray(tokens), jnp.asarray(labels),
                                   None, with_loss=True)
        num, den, aux = (ctx.psum_model(out[k]) for k in ("loss", "denom", "aux"))
        return num / jnp.maximum(den, 1.0) + 0.01 * aux / (sp * cell.sched.n * mdef.n_slots)

    def loss_fn(p):
        return jax.vmap(body, in_axes=(None, 0), axis_name="model")(p, jnp.arange(sp))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(loss=float(loss), grads=_to_np(grads))


@functools.lru_cache(maxsize=None)
def _spawned(world):
    ref = _jax_oracle(1, 1)
    layouts = LAYOUTS_2 if world == 2 else LAYOUTS_4
    return mesh.spawn(W.moe_rank, world, backend="gloo", device="cpu",
                      args=(layouts, ref["params"], ref["tokens"], ref["labels"]),
                      timeout_s=DEADLINE_S)


def _ranks(name):
    world = 2 if name in LAYOUTS_2 else 4
    return [r[name] for r in _spawned(world)]


def _jax_leaf(grads, path, layer=None):
    node = grads["stages"] if layer is not None else grads["globals"]
    for k in path.split("/"):
        node = node[k]
    return node if layer is None else node[layer]


def _assert_slot(got_slot, grads, layer, what):
    """A slot's gradients against the reference's layer ``layer`` (the
    gate: 0 in the port, see the module docstring)."""
    for path, got in tree.items(got_slot):
        if path == "gate":
            assert (np.asarray(got) == 0).all(), what
            continue
        want = _jax_leaf(grads, path, layer)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=f"{what} {path}")


def _assert_globals(got_glob, grads, what):
    assert set(dict(tree.items(got_glob))) == {"embed/table", "final_norm/scale"}, what
    for path, got in tree.items(got_glob):
        np.testing.assert_allclose(got, _jax_leaf(grads, path), rtol=0, atol=TOL,
                                   err_msg=f"{what} {path}")


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

BLOCK_ARCHS = ("granite-moe-1b-a400m", "deepseek-v3-671b")


def _block_cfgs(arch, cf):
    jcfg = jget_config(arch).reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    # the block alone: the reference's reduced MoEConfig on granite's widths
    tcfg = dataclasses.replace(get_config(ARCH).reduced(),
                               moe=MoEConfig(**dataclasses.asdict(jcfg.moe)))
    assert (tcfg.d_model, tcfg.moe) == (jcfg.d_model, MoEConfig(**dataclasses.asdict(jcfg.moe)))
    return jcfg, tcfg


def _block_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    d, m = cfg.d_model, cfg.moe
    E, ff = m.num_experts, m.d_ff_expert
    p = {"router": rng.normal(size=(d, E)) / 8, "w1": rng.normal(size=(E, d, ff)) / 8,
         "w3": rng.normal(size=(E, d, ff)) / 8, "w2": rng.normal(size=(E, ff, d)) / 6}
    if m.n_shared_experts:
        sf = ff * m.n_shared_experts
        p.update(ws1=rng.normal(size=(d, sf)) / 8, ws3=rng.normal(size=(d, sf)) / 8,
                 ws2=rng.normal(size=(sf, d)) / 6)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 24, d)).astype(np.float32)
    dy = rng.normal(size=(2, 24, d)).astype(np.float32)
    return p, x, dy


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_moe_block_against_the_reference(arch, cf):
    jcfg, tcfg = _block_cfgs(arch, cf)
    p, x, dy = _block_inputs(jcfg)
    daux = 0.7

    def ref(x_, p_):
        return JM.moe_block(x_, p_, jcfg, JSINGLE)

    (y, aux), vjp = jax.vjp(ref, jnp.asarray(x), jax.tree_util.tree_map(jnp.asarray, p))
    gx, gp = vjp((jnp.asarray(dy), jnp.float32(daux)))
    # the reference's routing, its own lines: the expert ids and the copies
    # that overflow a capacity
    xt = jnp.asarray(x).reshape(-1, jcfg.d_model)
    probs = jax.nn.softmax((xt @ jnp.asarray(p["router"])).astype(jnp.float32), axis=-1)
    _, top_e = jax.lax.top_k(probs, jcfg.moe.top_k)

    xt_t = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    _, t_e, _ = M.route(xt_t.detach().reshape(-1, tcfg.d_model), pt["router"].detach(), tcfg)
    np.testing.assert_array_equal(t_e.numpy(), np.asarray(top_e))
    y_t, aux_t = M.moe_block(xt_t, pt, tcfg)
    torch.autograd.backward([y_t, aux_t], [torch.from_numpy(dy), torch.tensor(daux)])
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y), rtol=0, atol=Y_TOL)
    np.testing.assert_allclose(float(aux_t.detach()), float(aux), rtol=0, atol=Y_TOL)
    scale = np.abs(np.asarray(gx)).max()
    np.testing.assert_allclose(xt_t.grad.numpy(), np.asarray(gx), rtol=0, atol=TOL * scale)
    for k in p:
        want = np.asarray(gp[k])
        np.testing.assert_allclose(pt[k].grad.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max(), err_msg=k)
    # the capacities drop copies at cf 0.5, none at 8
    n = x.shape[0] * x.shape[1]
    C, Ce = M.capacities(tcfg, n, 1)
    counts = np.bincount(np.asarray(top_e).reshape(-1), minlength=tcfg.moe.num_experts)
    assert (counts.max() > Ce) == (cf < 1), (counts, C, Ce)


def test_moe_block_refuses_experts_that_do_not_split():
    cfg = get_config(ARCH).reduced()
    with pytest.raises(ValueError, match="must divide"):
        M.moe_dims(cfg, 3)
    assert M.moe_dims(cfg, 2) == (4, 2)


# ---------------------------------------------------------------------------
# the train step at pp = 1
# ---------------------------------------------------------------------------


def _cell(**kw):
    return runner.resolve_cell(get_config(ARCH).reduced(),
                               ShapeConfig("t", S, B, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=N, grad_accum=1,
                                              partition="length", **kw),
                               dtype=torch.float32)


@pytest.mark.parametrize("plan", ["offload_off", "default"])
def test_train_step_matches_the_reference(plan):
    ref = _jax_oracle(1, 1)
    assert ref["lengths"] == (128,) * N
    if plan == "default":
        cell = dataclasses.replace(_cell(), alphas=ALPHAS)
        assert (cell.plan.offload, cell.plan.remat, cell.plan.prefetch) == (True, "sppo",
                                                                            "ahead")
    else:
        cell = _cell(offload=False, remat="none")
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    loss, grads = runner.loss_and_grads(cell, params, torch.from_numpy(ref["tokens"]),
                                        torch.from_numpy(ref["labels"]))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=0, atol=TOL)
    for j, slot in enumerate(grads["stages"]):
        _assert_slot(tree.map_(lambda t: t.numpy(), slot), ref["grads"], j, f"{plan} slot {j}")
    _assert_globals(tree.map_(lambda t: t.numpy(), grads["globals"]), ref["grads"], plan)
    # the reference hands the gate a gradient through aux · gate
    assert np.abs(ref["grads"]["stages"]["gate"]).max() > 0


@pytest.mark.parametrize("plan", [{}, dict(offload_moments=True, moments_dtype="fp8",
                                          offload_dtype="int8")])
def test_router_stays_fp32_in_a_bf16_model_and_trains(plan):
    """``params_from_numpy`` keeps the router (and the gate) fp32 in a bf16
    tree, as the reference does; AdamW steps the mixed tree, with its
    moments on the device or in host memory under a codec, the rows under
    one; the loss is finite."""
    ref = _jax_oracle(1, 1)
    params = params_from_numpy(ref["params"], dtype=torch.bfloat16, device="cpu")
    dtypes = {p: t.dtype for p, t in tree.items(params)}
    assert all(dtypes[p] == (torch.float32 if p.endswith(("router", "gate")) else torch.bfloat16)
               for p in dtypes)
    cell = dataclasses.replace(_cell(**plan), dtype=torch.bfloat16, alphas=ALPHAS)
    opt = runner.init_opt_state(cell, params)
    step = runner.make_train_step(cell, lr_kwargs=dict(peak=1e-3, warmup=1, total=10))
    losses = []
    for _ in range(2):
        params, opt, met = step(params, opt, torch.from_numpy(ref["tokens"]),
                                torch.from_numpy(ref["labels"]))
        losses.append(float(met["loss"]))
    assert np.isfinite(losses).all() and abs(losses[0] - ref["loss"]) < 2e-2
    assert all(t.dtype == dtypes[p] for p, t in tree.items(params))


def test_active_params_and_tagged_bytes():
    """The MFU's N counts the routed experts at top_k / E (the reference's
    ``specs.count_active_params``) and the tied table not at all; the cost
    model prices the expert hidden at top_k x d_ff_expert a token."""
    from repro.core import costmodel as jcm
    from repro.parallel import specs as jspecs

    for reduced in (False, True):
        jcfg, cfg = jget_config(ARCH), get_config(ARCH)
        if reduced:
            jcfg, cfg = jcfg.reduced(), cfg.reduced()
        for pp in (1, 2, 5):
            assert cm.count_active_params(build_model(cfg), pp) == \
                jspecs.count_active_params(jbuild_model(jcfg), pp, pp)
        assert cm.tagged_bytes_per_token(cfg) == jcm.tagged_bytes_per_token(jcfg)
    ref = _jax_oracle(1, 1)
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    cfg = get_config(ARCH).reduced()
    assert cm.count_active_params(params, cfg=cfg) == jspecs.count_active_params(
        jbuild_model(jget_config(ARCH).reduced()), 1, 1)
    with pytest.raises(ValueError, match="cfg"):
        cm.count_active_params(params)
    full = build_model(get_config(ARCH))
    assert 1.33e9 < cm.count_params(full) < 1.34e9
    assert 0.378e9 < cm.count_active_params(full) < 0.379e9


# ---------------------------------------------------------------------------
# multi-rank: pp = 2, MSP, dp x pp, sp = 2 expert parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["pp2", "pp2_msp", "dp2_pp2"])
def test_pipeline_layouts_match_the_reference(name):
    lay = LAYOUTS[name]
    dp, pp = lay.get("dp", 1), lay["pp"]
    ref = _jax_oracle(dp, pp)
    ranks = _ranks(name)
    assert sorted((r["dp_index"], r["stage"]) for r in ranks) == [
        (g, s) for g in range(dp) for s in range(pp)]
    for r in ranks:
        what = f"{name} rank {r['stage']}/{r['dp_index']}"
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=0, atol=TOL, err_msg=what)
        spp = len(r["grads"]["stages"])
        for i, slot in enumerate(r["grads"]["stages"]):
            _assert_slot(slot, ref["grads"], r["stage"] * spp + i, what)
        # the tied table, used on both stages: its gradient summed over them
        _assert_globals(r["grads"]["globals"], ref["grads"], what)


def test_tied_table_is_all_reduced_over_the_stages():
    """``Ctx.psum_globals``' shared path: the tied table's gradient comes
    from stage 0 (the embedding) and the last stage (the head), so it is
    all-reduced over the data axis; the final norm, which the last stage
    alone uses, is sent from there.  Every rank's reduced bytes: the loss's
    two scalars and the balance loss's one, the stage-usage mask, the
    table, and at dp > 1 the stage's and its owned globals' gradients over
    its dp group."""
    ref = _jax_oracle(1, 1)
    table = ref["params"]["globals"]["embed"]["table"].nbytes
    norm = ref["params"]["globals"]["final_norm"]["scale"].nbytes
    for name in ("pp2", "pp2_msp", "dp2_pp2"):
        lay = LAYOUTS[name]
        dp, pp = lay.get("dp", 1), lay["pp"]
        ranks = _ranks(name)
        assert sum(r["ctx_counts"]["bcast_bytes"] for r in ranks) == dp * (pp - 1) * norm
        for r in ranks:
            want = 2 * 4 + 4 + pp * 2 * 4 + table
            if dp > 1:
                want += sum(a.nbytes for a in tree.leaves(r["grads"]["stages"]))
                want += norm if r["stage"] == pp - 1 else 0
            assert r["ctx_counts"]["reduce_bytes"] == want, (name, r["stage"])


@pytest.mark.parametrize("name", ["sp2", "sp2_remat_none"])
def test_expert_parallel_sp2_matches_the_reference(name):
    ref = _jax_sp_oracle(2)
    ranks = sorted(_ranks(name), key=lambda r: r["model_index"])
    assert [r["model_index"] for r in ranks] == [0, 1]
    cfg = get_config(ARCH).reduced()
    full = gather_model_shards([r["grads"] for r in ranks], cfg)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=0, atol=TOL)
    for j, slot in enumerate(full["stages"]):
        _assert_slot(slot, ref["grads"], j, f"{name} slot {j}")
    _assert_globals(full["globals"], ref["grads"], name)
    # each rank holds its half of every expert stack
    assert full["stages"][0]["moe"]["w1"].shape[0] == 4
    assert ranks[0]["grads"]["stages"][0]["moe"]["w1"].shape[0] == 2
    # the sp = 2 loss is another function than sp = 1's (the drop set and
    # the balance loss follow the expert-parallel width)
    assert abs(ref["loss"] - _jax_oracle(1, 1)["loss"]) > 10 * TOL


@pytest.mark.parametrize("name", ["sp2", "sp2_remat_none"])
def test_all_to_all_counts_at_their_closed_form(name):
    cell = W.layout_cell(LAYOUTS[name])
    want = W.all_to_all_closed_form(cell, replay=cell.plan.remat != "none")
    for r in _ranks(name):
        c = r["ctx_counts"]
        assert (c["model_all_to_all_calls"], c["model_all_to_all_bytes"]) == (
            want["calls"], want["bytes"]), name
        assert c["model_all_to_all_s"] > 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_static_serving_matches_the_reference():
    ref = TS._jax_run(ARCH)
    got = TS._torch_run(ref, ARCH)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])
    for state in ("state_pre", "state_dec"):
        for name in ("k", "v"):
            np.testing.assert_allclose(got[state][name], ref[state][name], rtol=TOL, atol=TOL,
                                       err_msg=f"{state} {name}")
        np.testing.assert_array_equal(got[state]["pos"], ref[state]["pos"])
    np.testing.assert_allclose(got["last"], ref["last"], rtol=TOL, atol=TOL)


def test_build_model_takes_gqa_moe_and_refuses_mla():
    """granite's GQA MoE and deepseek-v3's MLA MoE build; MLA is refused at
    sp > 1 (its model-axis shards are a later slice) when the cell
    resolves, naming the ROADMAP item."""
    mdef = build_model(ARCH)
    assert mdef.cfg.tie_embeddings and "head" not in mdef.globals_spec()
    assert mdef.stage_spec()["moe"] == {"router": "rep", "w1": "keep0", "w3": "keep0",
                                        "w2": "keep0"}
    arch = "deepseek-v3-671b"
    ds = build_model(arch)
    assert ds.cfg.mla == MLAConfig(**dataclasses.asdict(jget_config(arch).mla))
    assert ds.stage_spec()["attn"] == jbuild_model(jget_config(arch)).stage_spec()["attn"]
    assert "head" in ds.globals_spec() and ds.stage_spec()["moe"]["ws1"] == 1
    with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
        runner.resolve_cell(get_config(arch).reduced(), ShapeConfig("t", S, B, "train"),
                            model_size=2, overrides=dict(sp=2, n_chunks=N),
                            dtype=torch.float32)
