"""The reference's runs that tests/test_torch_vlm.py (llama-3.2-vision-11b)
and tests/test_torch_audio.py (whisper-tiny) hold the port against, on the
CPU, and the port's counterparts.

The reduced configs at fp32: the VLM at one group (5 self layers and the
gated cross layer; d 64, 4 heads of 16 over 2, a context of 8 patches),
whisper at 2 decoder and 2 encoder layers (d 64, 4 heads of 16 over 2, 16
frames, learned positions).  The VLM's cross gates are set to
``GATES`` (0.5, -0.3) in the numpy tree both packages load: at their init
of 0 the cross layer adds nothing, and a wrong cross path would pass.  The
context is numpy from a seed, standard normal (not the stub's x 0.02, so
the cross path moves the loss).  Every case is computed once per test
process (``functools.lru_cache``); the parameters are the reference's
(``jax.random.PRNGKey(0)``) carried across through
``convert.params_from_numpy``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding

from _torch_cases import XATTN_GATES
from _torch_ssm_cases import decayed_by_stacking, ref_leaf, slot_leaf, to_np
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.core import costmodel as jcm
from repro.launch.mesh import make_test_mesh
from repro.launch.serve import gather_decode_tokens as jgather
from repro.launch.serve import shard_rows as jshard_rows
from repro.launch.train import build_params as jbuild_params
from repro.models.model_zoo import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.parallel import runner as jrunner
from repro.parallel import specs as jspecs
from repro.parallel.ctx import SINGLE as JSINGLE
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import offload as ofl
from repro_torch.core import tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import runner
from repro_torch.runtime import kvpool

VLM, AUDIO = "llama-3.2-vision-11b", "whisper-tiny"
S, B, N = 384, 2, 3          # the train step: 3 chunks of 128
SERVE_S, DECODE = 128, 4     # serving: a 128-token prompt in 2 chunks, 4 decode steps
LR = dict(peak=1e-3, warmup=1, total=10)
WEIGHT_DECAY = 0.1           # adamw.apply_update's default, both sides
GATES = XATTN_GATES
PLANS = {"none": dict(offload=False, remat="none"), "b": dict(offload=False, remat="sppo"),
         "d": {}}


def jcfg(arch):
    return jget_config(arch).reduced()


def tcfg(arch):
    return get_config(arch).reduced()


def n_context(cfg) -> int:
    return cfg.n_frames if cfg.encoder_layers else cfg.cross_attn.n_context_tokens


def context(arch, seed=5):
    """[B, N_ctx, d] float32, standard normal from ``seed``."""
    cfg = jcfg(arch)
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n_context(cfg), cfg.d_model)).astype(np.float32)


def _gate(params):
    """The reference's parameters with the VLM's cross gates set to GATES."""
    st = dict(params["stages"])
    for name, val in GATES.items():
        if name in st:
            st[name] = jnp.full_like(st[name], val)
    return {**params, "stages": st}


def _jcell(arch, shape, **ov):
    cell = jrunner.resolve_cell(jbuild_model(jcfg(arch)), shape, data_size=1, model_size=1,
                                overrides=dict(pp=1, dp=1, **ov))
    return dataclasses.replace(cell, dtype=jnp.float32)


def _batch(vocab):
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, -1] = -1
    labels[1, 100:170] = -1
    return tokens, labels


def _put(mesh, bspecs, arrays):
    return {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, bspecs[k]))
            for k, v in arrays.items()}


@functools.lru_cache(maxsize=None)
def jax_train(arch):
    """The reference's step at 1 x 1: ``make_train_step`` (loss, and the
    parameters after its AdamW update) and ``jax.value_and_grad`` of the
    same loss over its ``run_pipeline`` for the gradients.  Offload off and
    remat "none": every plan computes the same function."""
    cell = _jcell(arch, JShapeConfig("t", S, B, "train"), n_chunks=N, partition="length",
                  grad_accum=1, offload=False, remat="none")
    mesh = make_test_mesh(1, 1)
    params = _gate(jbuild_params(cell, mesh)[0])
    tokens, labels = _batch(cell.cfg.vocab_size)
    ctxt = context(arch)
    start = to_np(params)

    def loss_fn(p):
        out = jrunner.run_pipeline(cell, JSINGLE, p["stages"], p["globals"],
                                   jnp.asarray(tokens), jnp.asarray(labels), jnp.asarray(ctxt),
                                   with_loss=True)
        return out["loss"] / jnp.maximum(out["denom"], 1.0)

    flat = {"stages": jax.tree_util.tree_map(lambda a: a[0], params["stages"]),
            "globals": params["globals"]}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(flat)
    _, bspecs = jrunner.batch_struct(cell)
    batch = _put(mesh, bspecs, {"tokens": jshard_rows(tokens, 1, 1),
                                "labels": jshard_rows(labels, 1, 1), "context": ctxt[None, None]})
    opt = jadamw.init_state(params, jnp.float32)
    step = jax.jit(jrunner.make_train_step(cell, mesh, lr_kwargs=LR))
    new, _, met = step(params, opt, batch)
    new = to_np(new)
    for part in (start, new):
        part["stages"] = jax.tree_util.tree_map(lambda a: a[0], part["stages"])
    return dict(params=start, tokens=tokens, labels=labels, context=ctxt, loss=float(loss),
                grads=to_np(grads), step_loss=float(met["loss"]), lr=float(met["lr"]),
                new=new, lengths=tuple(cell.sched.lengths))


def port_cell(arch, **ov):
    return runner.resolve_cell(tcfg(arch), ShapeConfig("t", S, B, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=N, grad_accum=1,
                                              partition="length", **ov),
                               dtype=torch.float32)


def xattn_offload_elems(cell) -> int:
    """Elements of a step's off rows by the tag shapes the cross-attention
    families use: per chunk and slot, split_rows of the chunk's rows (B of
    each) of every self layer's q, k, v, attention output and MLP hidden,
    and of the cross layer's q and output (and for the VLM its MLP's
    hidden): not the cost model's dense pricing (PERF.md §7)."""
    cfg = cell.cfg
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layer = 2 * H * hd + 2 * Hkv * hd + cfg.d_ff
    per_row = (cfg.cross_attn.every * layer + 2 * H * hd + cfg.d_ff if cfg.family == "vlm"
               else layer + 2 * H * hd)
    return cell.mdef.n_slots * sum(ofl.split_rows(ln, a) * cell.b_loc * per_row
                                   for ln, a in zip(cell.sched.lengths, cell.alphas))


def check_step(arch, got_loss, got_grads, got_new=None):
    """The port's loss and gradients (and, where given, its parameters
    after one ``make_train_step``) against the reference's: the loss within
    1e-5, each gradient leaf within 1e-4 x its max |reference| (the
    structural gates get none in the port; whisper's unread ``xattn``
    biases are exactly 0 on both sides; its k biases' gradients, zero up to
    rounding, are held under 1e-4 x their layer's q bias's), each
    parameter within 1e-6 after the reference's update, the decay that only
    its stacked layout applies added back (``decayed_by_stacking``), and
    where a gradient element is under 1e-3 x its leaf's max (a k bias's
    everywhere), AdamW's sign-like first update held to its bound
    (tests/_torch_ssm_cases.py::check_step says why)."""
    ref = jax_train(arch)
    np.testing.assert_allclose(float(got_loss), ref["loss"], rtol=0, atol=1e-5)
    items = ([(f"{j}/{p}", t, j, p) for j, slot in enumerate(got_grads["stages"])
              for p, t in tree.items(slot)]
             + [(p, t, None, p) for p, t in tree.items(got_grads["globals"])])
    for name, got, j, path in items:
        if path.endswith(("gate", "gate_shared")):
            assert (got == 0).all(), name
            continue
        want = (slot_leaf(ref["grads"], path, j) if j is not None
                else ref_leaf(ref["grads"]["globals"], path))
        err = np.abs(got.numpy() - want).max()
        if path.endswith("attn/bk"):
            # zero up to rounding on both sides (a k bias shifts every score
            # of a query alike, and the softmax drops the shift): both held
            # within 1e-4 x the max |reference| of the layer's q bias
            bq = path[:-2] + "bq"
            scale = np.abs(slot_leaf(ref["grads"], bq, j) if j is not None
                           else ref_leaf(ref["grads"]["globals"], bq)).max()
            assert max(np.abs(got.numpy()).max(), np.abs(want).max()) <= 1e-4 * scale, name
            continue
        assert err <= 1e-4 * max(np.abs(want).max(), 1e-30), f"{name}: {err}"
        if runner.unread(tcfg(arch), path):
            assert (got == 0).all() and (want == 0).all(), name
    if got_new is None:
        return
    np.testing.assert_allclose(float(got_new["loss"]), ref["step_loss"], rtol=0, atol=1e-5)
    lr = ref["lr"]

    def held(got, want, g, what):
        sure = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-30)
        err = np.abs(got - want)
        assert err[sure].max(initial=0.0) <= 1e-6, f"{what}: {err[sure].max()}"
        assert err[~sure].max(initial=0.0) <= 2 * lr + 1e-6, f"{what}: {err[~sure].max()}"
        moved = g != 0
        assert not moved.any() or sure[moved].mean() > 0.8, f"{what}: {sure[moved].mean()}"

    for j, slot in enumerate(got_new["params"]["stages"]):
        for path, t in tree.items(slot):
            want = slot_leaf(ref["new"], path, j)
            if decayed_by_stacking(path, t):
                want = want + lr * WEIGHT_DECAY * slot_leaf(ref["params"], path, j)
            # a gate gets no gradient; a k bias's is rounding, so its update's
            # sign is too: both held to the update's bound alone
            g = (np.zeros_like(want) if path.endswith(("gate", "gate_shared", "attn/bk"))
                 else slot_leaf(ref["grads"], path, j))
            held(t.numpy(), want, g, f"stage {j} {path}")
    for path, t in tree.items(got_new["params"]["globals"]):
        g = ref_leaf(ref["grads"]["globals"], path)
        held(t.numpy(), ref_leaf(ref["new"]["globals"], path),
             np.zeros_like(g) if path.endswith("attn/bk") else g, path)


def run_train_step(arch, plan):
    """The port's loss and gradients and one ``make_train_step`` under
    ``plan`` (PLANS; plan (d) with every chunk but the last offloading
    rows), held to the reference's; returns the D2H and H2D bytes of the
    gradients call."""
    from repro_torch.runtime import hostmem

    ref = jax_train(arch)
    assert ref["lengths"] == (128, 128, 128)
    cell = port_cell(arch, **PLANS[plan])
    if plan == "d":
        assert (cell.plan.offload, cell.plan.remat, cell.plan.prefetch) == (True, "sppo", "ahead")
        cell = dataclasses.replace(cell, alphas=(0.6, 1.0, 0.0))
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    tokens, labels = torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["labels"])
    ctxt = torch.from_numpy(ref["context"])
    hostmem.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, tokens, labels, context=ctxt)
    copied = hostmem.counts()
    n_bytes = xattn_offload_elems(cell) * 4
    assert copied["d2h_bytes"] == copied["h2d_bytes"] == n_bytes
    assert (n_bytes > 0) == (plan == "d")
    step = runner.make_train_step(cell, lr_kwargs=LR)
    new, _, met = step(params, runner.init_opt_state(cell, params), tokens, labels,
                       context=ctxt)
    check_step(arch, loss, grads, dict(loss=met["loss"], params=new))


@functools.lru_cache(maxsize=None)
def jax_serve(arch):
    """The reference's static serving: ``make_prefill_step`` on a 128-token
    prompt in 2 chunks with the context, then DECODE greedy
    ``make_serve_step`` steps; the tokens, the prefill's last hidden state
    and the decode's final state."""
    pre = _jcell(arch, JShapeConfig("p", SERVE_S, B, "prefill"), n_chunks=SERVE_S // 64,
                 offload=False, remat="none")
    dec = _jcell(arch, JShapeConfig("d", SERVE_S, B, "decode"))
    mesh = make_test_mesh(1, 1)
    params = _gate(jbuild_params(pre, mesh)[0])
    prompts = np.random.default_rng(3).integers(2, pre.cfg.vocab_size,
                                                size=(B, SERVE_S)).astype(np.int32)
    ctxt = context(arch, seed=6)
    prefill, _, _ = jrunner.make_prefill_step(pre, mesh)
    _, bspecs = jrunner.batch_struct(pre)
    tok = jshard_rows(prompts, 1, 1)
    state, last = jax.jit(prefill)(params, _put(mesh, bspecs, {
        "tokens": tok, "labels": tok, "context": ctxt[None, None]}))
    serve_fn, _, _ = jrunner.make_serve_step(dec, mesh, decode_steps=DECODE)
    serve_fn = jax.jit(serve_fn)
    _, dspecs = jrunner.batch_struct(dec)
    cur = jnp.asarray(jshard_rows(prompts[:, -1:], 1, 1))
    toks = []
    for step in range(DECODE):
        # the decode batch carries the context its specs name; the step
        # reads the K/V the prefill left in the state
        batch = {"tokens": cur, "pos": jnp.int32(SERVE_S + step),
                 "context": _put(mesh, dspecs, {"context": ctxt[None, None]})["context"]}
        state, nxt = serve_fn(params, state, batch)
        cur = nxt[None]
        toks.append(jgather(np.asarray(nxt), 1, 1, B))
    np_params = to_np(params)
    np_params["stages"] = jax.tree_util.tree_map(lambda a: a[0], np_params["stages"])
    return dict(params=np_params, prompts=prompts, context=ctxt, last=np.asarray(last)[0],
                tokens=np.stack(toks, axis=1), state=to_np(state))


def port_serve(ref, arch):
    cfg = tcfg(arch)
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    pre = runner.resolve_cell(cfg, ShapeConfig("p", SERVE_S, B, "prefill"),
                              overrides=dict(pp=1, dp=1, n_chunks=SERVE_S // 64, offload=False,
                                             remat="none"), dtype=torch.float32)
    dec = runner.resolve_cell(cfg, ShapeConfig("d", SERVE_S, B, "decode"),
                              overrides=dict(pp=1, dp=1), dtype=torch.float32)
    state, last = runner.make_prefill_step(pre)(params, torch.from_numpy(ref["prompts"]),
                                                torch.from_numpy(ref["context"]))
    serve_fn = runner.make_serve_step(dec, decode_steps=DECODE)
    cur = torch.from_numpy(ref["prompts"][:, -1:])
    toks = []
    for step in range(DECODE):
        state, cur = serve_fn(params, state, cur, SERVE_S + step)
        toks.append(cur[:, 0].numpy())
    return dict(last=last.numpy(), tokens=np.stack(toks, axis=1), state=state)


def check_serving(arch):
    """The tokens equal, the last hidden state, every slot's self caches
    and its cross K/V within 1e-4 x max |reference|, the positions equal."""
    ref = jax_serve(arch)
    got = port_serve(ref, arch)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])

    def close(a, want, what):
        err = np.abs(a - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1.0), f"{what}: {err}"

    close(got["last"], ref["last"], "last hidden")
    rs = ref["state"]
    for j, s in enumerate(got["state"]):
        caches = s["self"] if "self" in s else [s["kv"]]
        for i, c in enumerate(caches):
            want = rs["self"] if "self" in s else rs["kv"]
            sl = (0, j, i) if "self" in s else (0, j)
            for name in ("k", "v"):
                close(getattr(c, name).numpy(), getattr(want, name)[sl], f"slot {j} self {i} {name}")
            np.testing.assert_array_equal(c.pos.numpy(), want.pos[sl])
        for name in ("k", "v"):
            close(s["xkv"][name].numpy(), rs["xkv"][name][0, j], f"slot {j} xkv {name}")
        np.testing.assert_array_equal(s["xkv"]["pos"].numpy(), rs["xkv"]["pos"][0, j])


def check_params_and_markers(arch):
    """Shapes of every leaf of the reduced model (the port's slots against
    the reference's stack), the fp32 leaves after conversion, and the
    markers of the reduced and the full model."""
    jmdef, mdef = jbuild_model(jcfg(arch)), build_model(tcfg(arch))
    assert mdef.n_slots == jmdef.n_slots
    key = jax.random.PRNGKey(0)
    jp = to_np({"stages": jmdef.init_stage_params(key, 0, 1, jnp.float32),
                "globals": jmdef.init_globals(key, jnp.float32)})
    mine = {"stages": mdef.init_stage_params(torch.Generator(), torch.float32, "meta"),
            "globals": mdef.init_globals(torch.Generator(), torch.float32, "meta")}
    for j, slot in enumerate(mine["stages"]):
        assert {p for p, _ in tree.items(slot)} == {p for p, _ in tree.items(jp["stages"])}
        for path, t in tree.items(slot):
            assert tuple(t.shape) == slot_leaf(jp, path, j).shape, path
    for path, t in tree.items(mine["globals"]):
        assert tuple(t.shape) == ref_leaf(jp["globals"], path).shape, path
    assert {p for p, _ in tree.items(mine["globals"])} == {p for p, _ in tree.items(jp["globals"])}
    bf16 = params_from_numpy(jp, dtype=torch.bfloat16, device="cpu")
    jf = jmdef.init_stage_params(key, 0, 1, jnp.bfloat16)
    for path, t in tree.items(bf16["stages"][0]):
        assert t.dtype == (torch.float32 if ref_leaf(jf, path).dtype == jnp.float32
                           else torch.bfloat16), path
    for full in (False, True):
        jm = jbuild_model(jget_config(arch)) if full else jmdef
        m = build_model(get_config(arch)) if full else mdef
        assert m.stage_spec() == jm.stage_spec()
        assert m.globals_spec() == jm.globals_spec()


def check_costmodel(arch):
    """The cost model's terms for the family equal to the reference's, full
    and reduced: the reference prices a VLM or whisper layer as a dense
    one, n_layers times, and the port copies that as it is (PERF.md §7)."""
    for reduced in (False, True):
        jc, c = jget_config(arch), get_config(arch)
        if reduced:
            jc, c = jc.reduced(), c.reduced()
        assert cm.tagged_bytes_per_token(c) == jcm.tagged_bytes_per_token(jc)
        assert cm.tagged_scale_elems_per_token(c) == jcm.tagged_scale_elems_per_token(jc)
        assert cm.chunk_act_bytes(c, [128, 256], batch=2, pp=1, sp=1) == \
            jcm.chunk_act_bytes(jc, [128, 256], batch=2, pp=1, sp=1)
        assert cm.count_active_params(build_model(c), 1) == \
            jspecs.count_active_params(jbuild_model(jc), 1, 1)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.requires_grad_() if grad else t


def _noisy(p, seed):
    """A parameter tree (numpy) with every leaf perturbed, so zero biases
    and unit norms are exercised too."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), p)


def check_cross_attention(arch, T=24, extra=3, seed=11):
    """``attention.cross_attention`` of a [B, T, d] chunk over
    ``make_cross_kv``'s K/V of a context of N_ctx + ``extra`` rows, the last
    ``extra`` PAD (n_valid = N_ctx), on slot 0's ``xattn`` leaves (perturbed),
    against the reference's: the output and the K/V within 2e-5, the
    positions equal, the gradients of x, the context and every ``xattn``
    leaf within 1e-4 x max |reference| (``jax.vjp`` of the same
    cotangent)."""
    from repro.models import attention as JA
    from repro_torch.models import attention as A

    jc, cfg = jcfg(arch), tcfg(arch)
    key = jax.random.PRNGKey(0)
    p = _noisy(to_np(jbuild_model(jc).init_stage_params(key, 0, 1, jnp.float32)["xattn"]),
               seed)
    p = jax.tree_util.tree_map(lambda a: a[0], p)
    rng = np.random.default_rng(seed)
    n = n_context(jc)
    x = rng.standard_normal((B, T, jc.d_model)).astype(np.float32)
    ctxt = rng.standard_normal((B, n + extra, jc.d_model)).astype(np.float32)
    dy = rng.standard_normal((B, T, jc.d_model)).astype(np.float32)

    def jfn(xx, cc, pp):
        xkv = JA.make_cross_kv(cc, pp, jc, JSINGLE, n)
        return JA.cross_attention(xx, pp, jc, JSINGLE, xkv), xkv

    want, wkv = jfn(jnp.asarray(x), jnp.asarray(ctxt), p)
    _, vjp = jax.vjp(lambda xx, cc, pp: jfn(xx, cc, pp)[0], jnp.asarray(x), jnp.asarray(ctxt),
                     jax.tree_util.tree_map(jnp.asarray, p))
    gx, gc, gp = vjp(jnp.asarray(dy))
    tx, tc = _t(x, True), _t(ctxt, True)
    tp = {k: _t(v, True) for k, v in p.items()}
    xkv = A.make_cross_kv(tc, tp, cfg, n)
    got = A.cross_attention(tx, tp, cfg, xkv)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(xkv[name].detach().numpy(), np.asarray(wkv[name]), rtol=0,
                                   atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(xkv["pos"].numpy(), np.asarray(wkv["pos"]))
    assert (xkv["pos"][n:] == A.PAD).all() and (xkv["pos"][:n] == torch.arange(n)).all()
    (got * _t(dy)).sum().backward()
    pairs = [("x", tx.grad, gx), ("context", tc.grad, gc)]
    pairs += [(k, tp[k].grad, gp[k]) for k in p]
    for name, g, w in pairs:
        w = np.asarray(w)
        g = np.zeros_like(w) if g is None else g.numpy()
        err = np.abs(g - w).max()
        assert err <= 1e-4 * max(np.abs(w).max(), 1e-30) or np.abs(w).max() == 0, \
            f"{name}: {err}"
        if name.startswith("b"):   # unread biases: no gradient on either side
            assert (g == 0).all() and (w == 0).all(), name


def check_clis(arch):
    """The serve and train CLIs at the reduced config on the CPU."""
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--prompt-len", "128",
                      "--batch", "2", "--decode-steps", "2"])
    tokens = np.asarray(out["tokens"])
    assert tokens.shape == (2, 2) and ((tokens >= 0) & (tokens < 256)).all()
    hist = train.main(["--arch", arch, "--reduced", "--steps", "2", "--seq", "256",
                       "--batch", "2", "--n-chunks", "2", "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)


def check_refusals(arch, kind):
    """sp > 1 and pp > 1 raise NotImplementedError naming ROADMAP Queue 1
    item 7; a decode cell's paged engine raises ValueError, as the
    reference asserts."""
    import pytest

    cfg = tcfg(arch)
    for kw in (dict(sp=2), dict(pp=2)):
        with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
            runner.resolve_cell(cfg, ShapeConfig("t", 256, 2, kind),
                                data_size=kw.get("pp", 1), model_size=kw.get("sp", 1),
                                overrides=dict(n_chunks=2, dp=1, **kw))
    if kind != "decode":
        return
    dec = runner.resolve_cell(cfg, ShapeConfig("d", 256, 2, kind), overrides=dict(pp=1, dp=1))
    geo = kvpool.PoolGeometry(s_bucket=256, sp=1, max_new=4, block_tokens=4, n_blocks=8,
                              n_slots=2)
    with pytest.raises(ValueError, match="dense GQA"):
        runner.check_pool_cell(dec, geo)
    with pytest.raises(ValueError, match="dense GQA"):
        serve.ServeEngine(cfg, (1, 1), s_bucket=64, slots=2, max_new=2, device="cpu")
