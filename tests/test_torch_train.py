"""The port's training slice against the JAX reference, on the CPU.

JAX-built fp32 parameters (carried across through
``convert.params_from_numpy``) and the same numpy tokens and labels go
through ``jax.value_and_grad`` of the reference's
``run_pipeline(cell, SINGLE, ..., with_loss=True)`` and through the port's
``runner.loss_and_grads``.  B = 2, S = 448: three FLOPs-balanced chunks of
128, 128 and 192 tokens (the last ragged), so every chunk's attention reads
the K/V of the chunks before it and sends them gradients.  The loss and every
gradient leaf agree at 1e-5 (fp32: the reference's own bar,
tests/test_offload_exec.py).  Also held against the reference: the
optimizer update and schedule, the synthetic data stream, the cross
entropy, the parameter count; and the CPU training CLI must lower the loss.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jget_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import layers as JL
from repro.models.model_zoo import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.parallel import runner as jrunner
from repro.parallel import specs as jspecs
from repro.parallel.ctx import SINGLE
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import tree
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw
from repro_torch.parallel import runner
from repro_torch.parallel.ctx import _later
from repro_torch.runtime import kvpool

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

S, B, N_CHUNKS = 448, 2, 3
TOL = 1e-5
ARCHS = ["qwen2-7b", "sppo-gpt-7b"]


def _overrides(**kw):
    return {**dict(pp=1, dp=1, n_chunks=N_CHUNKS, grad_accum=1, offload=False,
                   remat="none"), **kw}


def _batch(vocab, *, sentinel=True, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    if sentinel:  # label sentinel: some tokens carry no loss
        labels[0, -1] = -1
        labels[1, 100:140] = -1
    return tokens, labels


@functools.lru_cache(maxsize=None)
def _jax_run(arch):
    """JAX reference: numpy params, the batch, loss and grads (numpy)."""
    cfg = jget_config(arch).reduced()
    mdef = jbuild_model(cfg)
    cell = dataclasses.replace(jrunner.resolve_cell(
        mdef, JShapeConfig("t", S, B, "train"), data_size=1, model_size=1,
        overrides=_overrides()), dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    params = {"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
              "globals": mdef.init_globals(key, jnp.float32)}
    tokens, labels = _batch(cfg.vocab_size)

    def loss_fn(p):
        out = jrunner.run_pipeline(cell, SINGLE, p["stages"], p["globals"],
                                   jnp.asarray(tokens), jnp.asarray(labels),
                                   None, with_loss=True)
        return out["loss"] / jnp.maximum(out["denom"], 1.0)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float32))
    return dict(params=to_np(params), grads=to_np(grads), loss=float(loss),
                tokens=tokens, labels=labels, lengths=cell.sched.lengths,
                n_active=jspecs.count_active_params(mdef, 1, 1))


def _torch_cell(arch, **kw):
    cfg = get_config(arch).reduced()
    return runner.resolve_cell(cfg, ShapeConfig("t", S, B, "train"),
                               overrides=_overrides(**kw), dtype=torch.float32)


def _torch_params(ref):
    return params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")


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


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_grad_match_jax(arch):
    ref = _jax_run(arch)
    cell = _torch_cell(arch)
    assert cell.sched.lengths == ref["lengths"] == (128, 128, 192)
    loss, grads = runner.loss_and_grads(cell, _torch_params(ref),
                                        torch.from_numpy(ref["tokens"]),
                                        torch.from_numpy(ref["labels"]))
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=0, atol=TOL)
    n = 0
    for path, g in tree.items(grads):
        want = _jax_leaf(ref["grads"], path)
        assert g.shape == want.shape, path
        np.testing.assert_allclose(g.numpy(), want, rtol=0, atol=TOL, err_msg=path)
        n += 1
    n_slots = len(ref["grads"]["stages"]["gate"])
    assert n == (n_slots * len(jax.tree_util.tree_leaves(ref["grads"]["stages"]))
                 + len(jax.tree_util.tree_leaves(ref["grads"]["globals"])))


def test_gate_gets_no_gradient():
    """The slot gate is a structural constant: ``_res`` stops its gradient,
    as the reference does, so AdamW never moves it."""
    ref = _jax_run("qwen2-7b")
    params = _torch_params(ref)
    gates = [slot["gate"].requires_grad_() for slot in params["stages"]]
    wq = params["stages"][0]["attn"]["wq"].requires_grad_()
    cell = _torch_cell("qwen2-7b")
    with torch.enable_grad():
        out = runner.run_pipeline(cell, params["stages"], params["globals"],
                                  torch.from_numpy(ref["tokens"]),
                                  torch.from_numpy(ref["labels"]), with_loss=True)
        grads = torch.autograd.grad(out["loss"], [wq, *gates], allow_unused=True)
    assert grads[0] is not None and all(g is None for g in grads[1:])
    x = torch.randn(2, 3, requires_grad=True)
    gate = torch.tensor(1.0, requires_grad=True)
    y = T._res(x, torch.ones(2, 3), gate)
    assert torch.autograd.grad(y.sum(), gate, allow_unused=True)[0] is None
    _, g = runner.loss_and_grads(cell, _torch_params(ref),
                                 torch.from_numpy(ref["tokens"]),
                                 torch.from_numpy(ref["labels"]))
    for i, slot in enumerate(g["stages"]):
        assert (slot["gate"] == 0).all()
        assert (ref["grads"]["stages"]["gate"][i] == 0).all()


@pytest.mark.parametrize("kind,extra", [("train", 0), ("prefill", 128), ("decode", 128)])
def test_cache_loc_matches_reference(kind, extra):
    """Training never decodes: its cache holds S slots, no decode budget."""
    cfg = get_config("qwen2-7b").reduced()
    ov = (dict(pp=1, dp=1) if kind == "decode" else
          dict(pp=1, dp=1, offload=False, remat="none", n_chunks=2))
    cell = runner.resolve_cell(cfg, ShapeConfig("c", 256, 2, kind), overrides=ov)
    jcell = jrunner.resolve_cell(jbuild_model(jget_config("qwen2-7b").reduced()),
                                 JShapeConfig("c", 256, 2, kind), data_size=1,
                                 model_size=1, overrides=ov)
    assert cell.cache_loc == jcell.cache_loc == 256 + extra


def test_grad_accum_2_equals_1():
    ref = _jax_run("qwen2-7b")
    tokens, labels = _batch(256, sentinel=False, seed=1)
    out = {}
    for A_ in (1, 2):
        cell = _torch_cell("qwen2-7b", grad_accum=A_)
        assert cell.plan.grad_accum == A_
        out[A_] = runner.loss_and_grads(cell, _torch_params(ref), torch.from_numpy(tokens),
                                        torch.from_numpy(labels))
    np.testing.assert_allclose(float(out[2][0]), float(out[1][0]), rtol=0, atol=TOL)
    for (path, a), b in zip(tree.items(out[2][1]), tree.leaves(out[1][1])):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL, err_msg=path)


def test_chunk_attention_equals_attention_over_the_concatenated_chunks():
    """The in-place training cache (one buffer, chunk K/V as the Function's
    inputs) gives the loss and grads of attention over torch.cat of the
    chunks, for every chunk's k and v."""
    rng = np.random.default_rng(4)
    Bq, H, Hkv, hd, lens = 2, 4, 2, 16, (5, 7, 9)
    qs = [torch.from_numpy(rng.standard_normal((Bq, n, H, hd), np.float32)) for n in lens]
    ks = [torch.from_numpy(rng.standard_normal((Bq, n, Hkv, hd), np.float32)) for n in lens]
    vs = [torch.from_numpy(rng.standard_normal((Bq, n, Hkv, hd), np.float32)) for n in lens]
    w = [torch.from_numpy(rng.standard_normal((Bq, n, H, hd), np.float32)) for n in lens]

    def run(cached):
        leaves = [t.clone().requires_grad_() for t in ks + vs]
        k_in, v_in = leaves[:3], leaves[3:]
        cache = A.init_cache(Bq, sum(lens), Hkv, hd, hd, torch.float32, "cpu", train=True)
        loss, off = 0.0, 0
        for c, n in enumerate(lens):
            pos = off + torch.arange(n, dtype=torch.int32)
            if cached:
                out = A.chunk_attention(qs[c], k_in[c], v_in[c], pos, cache, off, off + n)
            else:
                k = torch.cat(k_in[:c + 1], dim=1)
                v = torch.cat(v_in[:c + 1], dim=1)
                out = A.dist_attention(qs[c], k, v, pos, torch.arange(off + n, dtype=torch.int32))
            loss = loss + (out * w[c]).sum()
            off += n
        return loss, torch.autograd.grad(loss, leaves)

    (l1, g1), (l2, g2) = run(True), run(False)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


def test_xent_matches_jax_with_padded_vocab_and_sentinels():
    rng = np.random.default_rng(2)
    Bx, Tx, d, V, Vp = 2, 6, 8, 50, 64
    x = rng.standard_normal((Bx, Tx, d), np.float32)
    head = rng.standard_normal((d, Vp), np.float32)
    labels = rng.integers(0, V, size=(Bx, Tx)).astype(np.int32)
    labels[0, 1], labels[1, 4] = -1, Vp + 3          # sentinel, out of table
    mask = (labels >= 0).astype(np.float32)

    def jloss(x, h):
        s, c = JL.vocab_parallel_xent(x, h, jnp.asarray(labels), jnp.asarray(mask),
                                      SINGLE, real_vocab=V)
        return s / c

    jl, (jgx, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    xt, ht = (torch.from_numpy(a).requires_grad_() for a in (x, head))
    s, c = L.vocab_parallel_xent(xt, ht, torch.from_numpy(labels), torch.from_numpy(mask),
                                 real_vocab=V)
    loss = s / c
    gx, gh = torch.autograd.grad(loss, (xt, ht))
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), rtol=0, atol=1e-6)
    np.testing.assert_allclose(gh.numpy(), np.asarray(jgh), rtol=0, atol=1e-6)
    assert (gh[:, V:] == 0).all()


def _opt_case():
    rng = np.random.default_rng(5)
    shapes = {"w": (6, 5), "b": (5,), "e": (3, 4, 2), "s": ()}
    params = {k: np.asarray(rng.standard_normal(s), np.float32) for k, s in shapes.items()}
    grads = [{k: np.asarray(3.0 * rng.standard_normal(s), np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def test_apply_update_matches_jax_over_three_clipped_steps():
    params, grads = _opt_case()
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jadamw.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adamw.init_state(tp)
    for step, g in enumerate(grads):
        jlr = jadamw.cosine_lr(js.step, peak=1e-2, warmup=2, total=10)
        tlr = adamw.cosine_lr(ts.step, peak=1e-2, warmup=2, total=10)
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=1e-6)
        jp, js, jm = jadamw.apply_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                         js, lr=jlr)
        tp, ts, tm = adamw.apply_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                                        ts, lr=tlr)
        assert float(jm["grad_norm"]) > 1.0          # clipping is active
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert int(ts.step) == int(js.step) == step + 1
        for k in params:
            for a, b in ((tp[k], jp[k]), (ts.m[k], js.m[k]), (ts.v[k], js.v[k])):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6,
                                           err_msg=f"step {step} {k}")


@pytest.mark.parametrize("kw", [dict(peak=3e-4, warmup=20, total=100),
                                dict(peak=1e-2, warmup=5, total=12, floor=0.2)])
def test_cosine_lr_matches_jax(kw):
    """Equal up to the last bit of fp32: the two frameworks' cos differ
    there at a few steps."""
    steps = np.arange(0, kw["total"] + 5, dtype=np.int32)
    want = np.asarray([jadamw.cosine_lr(jnp.int32(s), **kw) for s in steps])
    got = np.asarray([adamw.cosine_lr(torch.tensor(int(s), dtype=torch.int32), **kw)
                      for s in steps])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)


def test_moment_offload_raises_naming_the_item():
    """The moment offload runs (tests/test_torch_optstate.py); what still
    raises, saying why: the reference's ``moments_mode="xla"`` (placement
    through XLA shardings) and a moment codec without the offload."""
    params = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="'xla' is the reference's placement"):
        adamw.init_state(params, offload_moments=True, moments_mode="xla")
    state = adamw.init_state(params, offload_moments=True)
    with pytest.raises(ValueError, match="'xla' is the reference's placement"):
        adamw.apply_update(params, params, state, lr=1e-3, offload_moments=True,
                           moments_mode="xla")
    with pytest.raises(ValueError, match="requires offload_moments"):
        adamw.init_state(params, moments_dtype="fp8")


@pytest.mark.parametrize("seed,steps", [(0, (0, 1, 7)), (3, (2,))])
def test_synthetic_lm_matches_reference(seed, steps):
    ours, theirs = SyntheticLM(1000, 300, 3, seed=seed), JSyntheticLM(1000, 300, 3, seed=seed)
    for step in steps:
        for a, b in zip(ours.sample_step(step), theirs.sample_step(step)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_active_param_count_matches_reference(arch):
    ref = _jax_run(arch)
    assert cm.count_active_params(_torch_params(ref)) == ref["n_active"]


def _queue1_titles():
    """ROADMAP.md's Queue 1 items: number -> the item's bold title."""
    import pathlib
    import re

    text = (pathlib.Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    queue = text.split("### Queue 1", 1)[1].split("### Queue 2", 1)[0]
    return {int(n): title for n, title in re.findall(r"^(\d+)\. \*\*([^*]+)\*\*", queue,
                                                     flags=re.M)}


def test_resolve_cell_refuses_what_later_slices_bring():
    """The moment offload and the codecs run (tests/test_torch_optstate.py,
    tests/test_torch_offload.py), as do the executed activation offload and
    remat "sppo" / "full", the model axis with its attention modes
    (tests/test_torch_model_axis.py), and ring attention (item 4) and
    ZeRO-1 over the pod axis (item 3's last part; tests/test_torch_ring.py).
    Prefill and decode at sp > 1 and decode at pp > 1 (item 5, paged
    serving) resolve (tests/test_torch_paged.py); the paged engine refuses
    pp > 1, more than one pod and other families than dense GQA, as the
    reference does, with a ValueError (no later item lifts them).  What
    later slices bring is refused naming its ROADMAP Queue 1 item as
    ROADMAP.md numbers it: the auditor and checkpointing (item 7,
    tooling)."""
    cfg = get_config("qwen2-7b").reduced()
    shape = ShapeConfig("t", 256, 2, "train")
    for ov in (dict(offload_moments=True), dict(offload_dtype="fp8"),
               dict(offload_moments=True, moments_dtype="int8")):
        cell = runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, **ov))
        assert all(getattr(cell.plan, k) == v for k, v in ov.items())
    cell = runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1))
    assert (cell.plan.offload, cell.plan.remat, cell.plan.prefetch) == (True, "sppo", "ahead")
    titles = _queue1_titles()
    assert titles[3].startswith("Multi-rank pipeline")
    assert titles[4].startswith("Ring attention")
    assert titles[7].startswith("Remaining families and tooling")
    assert {item for _, item in train.LATER.values()} == {7}
    assert runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1), pods=2).plan.zero1
    assert runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, attn_mode="ring"),
                               model_size=2).plan.attn_mode == "ring"
    assert titles[5].startswith("Paged serving")
    ring_prefill = runner.resolve_cell(cfg, ShapeConfig("p", 256, 2, "prefill"),
                                       overrides=dict(pp=1, dp=1, attn_mode="ring"),
                                       model_size=2)
    assert ring_prefill.plan.attn_mode == "ring" and ring_prefill.plan.sp == 2
    geo = kvpool.PoolGeometry(s_bucket=256, sp=1, max_new=4, block_tokens=4, n_blocks=8,
                              n_slots=2)
    dense = runner.resolve_cell(cfg, ShapeConfig("d", 256, 2, "decode"), overrides=dict(pp=1, dp=1))
    runner.check_pool_cell(dense, geo)
    for served, what in (
            (runner.resolve_cell(cfg, ShapeConfig("d", 256, 2, "decode"),
                                 overrides=dict(pp=2, dp=1), data_size=2), "pp = 1"),
            (runner.resolve_cell(cfg, ShapeConfig("d", 256, 4, "decode"),
                                 overrides=dict(pp=1, dp=1), pods=2), "single-pod"),
            (dataclasses.replace(dense, mdef=dataclasses.replace(
                dense.mdef, cfg=dataclasses.replace(cfg, family="moe"))), "dense GQA")):
        with pytest.raises(ValueError, match=what):
            runner.check_pool_cell(served, geo)
    assert {dest for dest, (_, item) in train.LATER.items() if item == 7} == {
        "audit", "ckpt_dir", "ckpt_every", "resume"}
    assert "item 3" in str(_later("pp = 2 (pipeline stages)", 3))


def test_cli_trains_on_cpu_and_the_loss_falls():
    hist = train.main(["--reduced", "--steps", "12", "--seq", "256", "--batch", "8",
                       "--device", "cpu", "--log-every", "4"])
    assert len(hist) == 12
    losses = [r["loss"] for r in hist]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.3
    assert all(r["tgs"] > 0 and r["mfu"] > 0 for r in hist)


def test_cli_counts_no_kernel_launch_on_cpu():
    fa.reset_counts()
    train.main(["--reduced", "--steps", "1", "--seq", "128", "--batch", "2",
                "--device", "cpu", "--n-chunks", "1"])
    assert fa.counts() == {"fwd": 0, "merge": 0, "fwd_tc": 0, "merged_in_kernel": 0,
                           "bwd_dq": 0, "bwd_dkv": 0, "bwd_dq_tc": 0, "bwd_dkv_tc": 0}


@pytest.mark.parametrize("flag,item", [(["--mesh", "1x2", "--attn-mode", "ring", "--ckpt-dir", "x"], 7),
                                       (["--attn-mode", "ring", "--audit"], 7),
                                       (["--ckpt-every", "5"], 7), (["--ckpt-dir", "x"], 7),
                                       (["--audit"], 7),
                                       (["--mesh", "2x2", "--attn-mode", "ring", "--resume", "x"], 7),
                                       (["--resume", "x"], 7)],
                         ids=[f"flag{i}" for i in range(7)])
def test_cli_refuses_flags_of_later_slices(flag, item, capsys):
    """What the CLI still refuses: checkpointing and the auditor (item 7),
    beside ring attention too.  A model axis in ``--mesh`` and every
    attention mode run (tests/test_torch_model_axis.py; ``--attn-mode ring``
    in tests/test_torch_ring.py)."""
    with pytest.raises(SystemExit):
        train.main(["--reduced", "--steps", "1", "--device", "cpu", *flag])
    assert f"ROADMAP Queue 1, item {item}" in capsys.readouterr().err


def test_cli_targets_cuda():
    """Asked for nothing, the train entry point targets the card; with no
    card it fails instead of running on the CPU."""
    assert train.build_parser().parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--reduced", "--steps", "1"])
