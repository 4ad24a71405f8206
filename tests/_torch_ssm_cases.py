"""The reference's runs that tests/test_torch_ssm.py (rwkv6-3b) and
tests/test_torch_hybrid.py (zamba2-7b) hold the port against, on the CPU,
and the port's counterparts.

The reduced configs at fp32: rwkv6 at its 2 layers (d 64, 4 heads of 16,
d_ff 128); zamba2 at 5 mixers in groups of 2 (3 slots, the last with one
ghost mixer at gate 0, so the shared block runs 3 times a chunk), d 64, 4
heads of 16, d_state 16.  Every case is computed once per test process
(``functools.lru_cache``); inputs are numpy arrays from a seed, the
parameters the reference's (``jax.random.PRNGKey(0)``) carried across
through ``convert.params_from_numpy``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import NamedSharding

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
from repro_torch.core import tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import runner

S, B, N = 384, 2, 3          # the train step: 3 chunks of 128
SERVE_S, DECODE = 128, 4     # serving: a 128-token prompt in 2 chunks, 4 decode steps
LR = dict(peak=1e-3, warmup=1, total=10)
WEIGHT_DECAY = 0.1           # adamw.apply_update's default, both sides
REDUCED = {"rwkv6-3b": {}, "zamba2-7b": dict(n_layers=5)}


def jcfg(arch):
    return jget_config(arch).reduced(**REDUCED[arch])


def tcfg(arch):
    return get_config(arch).reduced(**REDUCED[arch])


def to_np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)


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


@functools.lru_cache(maxsize=None)
def jax_train(arch):
    """The reference's step at 1 x 1: ``make_train_step`` (loss, and the
    parameters after its AdamW update) and, for the gradients it does not
    return, ``jax.value_and_grad`` of the same loss over its
    ``run_pipeline``.  Offload off and remat "none": every plan computes
    the same function."""
    cell = _jcell(arch, JShapeConfig("t", S, B, "train"), n_chunks=N, partition="length",
                  grad_accum=1, offload=False, remat="none")
    mesh = make_test_mesh(1, 1)
    params, _, _ = jbuild_params(cell, mesh)
    tokens, labels = _batch(cell.cfg.vocab_size)
    start = to_np(params)

    def loss_fn(p):
        out = jrunner.run_pipeline(cell, JSINGLE, p["stages"], p["globals"],
                                   jnp.asarray(tokens), jnp.asarray(labels), None,
                                   with_loss=True)
        return out["loss"] / jnp.maximum(out["denom"], 1.0)

    flat = {"stages": jax.tree_util.tree_map(lambda a: a[0], params["stages"]),
            "globals": params["globals"]}
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(flat)
    _, bspecs = jrunner.batch_struct(cell)
    batch = {k: jax.device_put(jnp.asarray(jshard_rows(v, 1, 1)), NamedSharding(mesh, bspecs[k]))
             for k, v in (("tokens", tokens), ("labels", labels))}
    opt = jadamw.init_state(params, jnp.float32)
    step = jax.jit(jrunner.make_train_step(cell, mesh, lr_kwargs=LR))
    new, _, met = step(params, opt, batch)
    new = to_np(new)
    for part in (start, new):
        part["stages"] = jax.tree_util.tree_map(lambda a: a[0], part["stages"])
    return dict(params=start, tokens=tokens, labels=labels, loss=float(loss),
                grads=to_np(grads), step_loss=float(met["loss"]), lr=float(met["lr"]),
                new=new, lengths=tuple(cell.sched.lengths))


def port_cell(arch, **ov):
    return runner.resolve_cell(tcfg(arch), ShapeConfig("t", S, B, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=N, grad_accum=1,
                                              partition="length", **ov),
                               dtype=torch.float32)


def ref_leaf(ref_tree, path):
    for k in path.split("/"):
        ref_tree = ref_tree[int(k)] if isinstance(ref_tree, list) else ref_tree[k]
    return ref_tree


def slot_leaf(ref_tree, path, j):
    """The reference's stacked stage leaf at ``path``, slot ``j``."""
    return ref_leaf(ref_tree["stages"], path)[j]


def decayed_by_stacking(path: str, t) -> bool:
    """Whether the reference's AdamW decays a stage leaf that the port's
    does not: the reference decays leaves of ndim >= 2 after stacking the
    slots (and a data dim) in front, so every stage leaf; the port decays
    by the per-slot ndim, so not a slot's 1-D leaves (norms, biases, an
    RWKV layer's lerp and bonus vectors, the gates)."""
    return t.dim() < 2


def jax_serve(arch):
    """The reference's static serving: ``make_prefill_step`` on a 128-token
    prompt in 2 chunks, then DECODE greedy ``make_serve_step`` steps; the
    tokens and the prefill's last hidden state."""
    return _jax_serve(arch)


@functools.lru_cache(maxsize=None)
def _jax_serve(arch):
    pre = _jcell(arch, JShapeConfig("p", SERVE_S, B, "prefill"), n_chunks=SERVE_S // 64,
                 offload=False, remat="none")
    dec = _jcell(arch, JShapeConfig("d", SERVE_S, B, "decode"))
    mesh = make_test_mesh(1, 1)
    params, _, _ = jbuild_params(pre, mesh)
    prompts = np.random.default_rng(3).integers(2, pre.cfg.vocab_size,
                                                size=(B, SERVE_S)).astype(np.int32)
    prefill, _, _ = jrunner.make_prefill_step(pre, mesh)
    _, bspecs = jrunner.batch_struct(pre)
    tok = jnp.asarray(jshard_rows(prompts, 1, 1))
    batch = {k: jax.device_put(tok, NamedSharding(mesh, bspecs[k])) for k in ("tokens", "labels")}
    state, last = jax.jit(prefill)(params, batch)
    serve_fn, _, _ = jrunner.make_serve_step(dec, mesh, decode_steps=DECODE)
    serve_fn = jax.jit(serve_fn)
    cur = jnp.asarray(jshard_rows(prompts[:, -1:], 1, 1))
    toks = []
    for step in range(DECODE):
        state, nxt = serve_fn(params, state, {"tokens": cur, "pos": jnp.int32(SERVE_S + step)})
        cur = nxt[None]
        toks.append(jgather(np.asarray(nxt), 1, 1, B))
    np_params = to_np(params)
    np_params["stages"] = jax.tree_util.tree_map(lambda a: a[0], np_params["stages"])
    return dict(params=np_params, prompts=prompts, last=np.asarray(last)[0],
                tokens=np.stack(toks, axis=1), state=to_np(state))


def port_serve(ref, arch):
    cfg = tcfg(arch)
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    pre = runner.resolve_cell(cfg, ShapeConfig("p", SERVE_S, B, "prefill"),
                              overrides=dict(pp=1, dp=1, n_chunks=SERVE_S // 64, offload=False,
                                             remat="none"), dtype=torch.float32)
    dec = runner.resolve_cell(cfg, ShapeConfig("d", SERVE_S, B, "decode"),
                              overrides=dict(pp=1, dp=1), dtype=torch.float32)
    state, last = runner.make_prefill_step(pre)(params, torch.from_numpy(ref["prompts"]))
    serve_fn = runner.make_serve_step(dec, decode_steps=DECODE)
    cur = torch.from_numpy(ref["prompts"][:, -1:])
    toks = []
    for step in range(DECODE):
        state, cur = serve_fn(params, state, cur, SERVE_S + step)
        toks.append(cur[:, 0].numpy())
    return dict(last=last.numpy(), tokens=np.stack(toks, axis=1), state=state)


def check_step(arch, cell, got_loss, got_grads, got_new=None):
    """The port's loss and gradients (and, where given, its parameters
    after one ``make_train_step``) against the reference's: the loss within
    1e-5, each gradient leaf within 1e-4 x its max |reference| (the gates,
    structural constants, get none in the port), each parameter within
    1e-6 after the reference's update, the decay that only its stacked
    layout applies added back (``decayed_by_stacking``).

    AdamW's first update is g / (|g| + eps) a element, the sign of the
    gradient wherever |g| >> eps: where a gradient element is under 1e-3 x
    its leaf's max |reference| (ten times the gradients' tolerance) its
    sign is set by rounding, and there the update is held to its bound,
    lr x (1 + eps-free slack), not to 1e-6."""
    ref = jax_train(arch)
    np.testing.assert_allclose(float(got_loss), ref["loss"], rtol=0, atol=1e-5)
    for part in ("stages", "globals"):
        items = ([(f"{j}/{p}", t, j, p) for j, slot in enumerate(got_grads["stages"])
                  for p, t in tree.items(slot)] if part == "stages"
                 else [(p, t, None, p) for p, t in tree.items(got_grads["globals"])])
        for name, got, j, path in items:
            if path.endswith(("gate", "gate_shared")):
                assert (got == 0).all(), name
                continue
            want = (slot_leaf(ref["grads"], path, j) if j is not None
                    else ref_leaf(ref["grads"]["globals"], path))
            err = np.abs(got.numpy() - want).max()
            assert err <= 1e-4 * max(np.abs(want).max(), 1e-30), f"{part} {name}: {err}"
    if got_new is None:
        return
    np.testing.assert_allclose(float(got_new["loss"]), ref["step_loss"], rtol=0, atol=1e-5)
    lr = ref["lr"]

    def held(got, want, g, what):
        sure = np.abs(g) > 1e-3 * max(np.abs(g).max(), 1e-30)
        err = np.abs(got - want)
        assert err[sure].max(initial=0.0) <= 1e-6, f"{what}: {err[sure].max()}"
        assert err[~sure].max(initial=0.0) <= 2 * lr + 1e-6, f"{what}: {err[~sure].max()}"
        # most of a leaf's moved elements are held at 1e-6
        moved = g != 0
        assert not moved.any() or sure[moved].mean() > 0.8, f"{what}: {sure[moved].mean()}"

    for j, slot in enumerate(got_new["params"]["stages"]):
        for path, t in tree.items(slot):
            want = slot_leaf(ref["new"], path, j)
            if decayed_by_stacking(path, t):
                want = want + lr * WEIGHT_DECAY * slot_leaf(ref["params"], path, j)
            g = (np.zeros_like(want) if path.endswith(("gate", "gate_shared"))
                 else slot_leaf(ref["grads"], path, j))
            held(t.numpy(), want, g, f"stage {j} {path}")
    for path, t in tree.items(got_new["params"]["globals"]):
        held(t.numpy(), ref_leaf(ref["new"]["globals"], path),
             ref_leaf(ref["grads"]["globals"], path), path)


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
    """The cost model's SSM branches equal to the reference's, full and
    reduced."""
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
