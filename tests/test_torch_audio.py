"""The port's audio family, whisper-tiny (a bidirectional encoder over stub
frame embeddings, then decoder layers of causal self-attention,
cross-attention over the encoder's output and an MLP, learned positions),
against the JAX reference, on the CPU, at fp32.

The reduced config of tests/_torch_xattn_cases.py: 2 decoder and 2
encoder layers, 16 frames, d 64, 4 heads of 16 over 2, q/k/v and MLP
biases, LayerNorm, GeLU.  What is held, and how:

- ``transformer.encoder_layer`` (frames past ``n_valid`` PAD) and the
  whole ``encode`` within 2e-5, the encoder layer's gradients within 1e-4
  x max |reference|; ``attention.cross_attention`` over ``make_cross_kv``
  as in tests/test_torch_vlm.py (whisper's ``xattn`` biases unread on both
  sides); the learned positions' embedding at [T] and [B, T] positions,
  clipped to the table;
- the train step at S 384 in 3 chunks under remat "none", plan (b) and
  plan (d): the loss, the gradient of every leaf (the encoder's, ``pos``
  and ``xattn`` included) and the parameters after one AdamW step; D2H =
  H2D at the closed form of whisper's tag shapes (each decoder layer's
  cross q and output beside its self layer's);
- static serving: the encoder once in the prefill, 4 greedy decode steps
  reading the cross K/V from the state, the tokens equal, the last hidden
  state, the caches and the cross K/V within 1e-4 x max;
- the CLIs with ``--arch whisper-tiny --reduced --device cpu``; the full
  model's shapes; the parameters' shapes, fp32 leaves and markers, the
  cost model's terms equal to the reference's;
- what is refused: sp > 1 and pp > 1 (NotImplementedError naming ROADMAP
  Queue 1 item 7), the paged engine (ValueError).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_xattn_cases as C
from repro.models import transformer as JT
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel.ctx import SINGLE as JSINGLE
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import tree
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import runner

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

ARCH = C.AUDIO


def _globals(seed=12):
    """The reduced model's globals (the reference's draws, perturbed) as
    numpy."""
    key = jax.random.PRNGKey(0)
    g = C.to_np(jbuild_model(C.jcfg(ARCH)).init_globals(key, jnp.float32))
    return C._noisy(g, seed)


@pytest.mark.parametrize("n_valid", [16, 11])
def test_encoder_layer_and_encode_match_the_reference(n_valid):
    jc, cfg = C.jcfg(ARCH), C.tcfg(ARCH)
    g = _globals()
    p0 = jax.tree_util.tree_map(lambda a: a[0], g["encoder"])
    rng = np.random.default_rng(13)
    x = rng.standard_normal((C.B, jc.n_frames, jc.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda xx, pp: JT.encoder_layer(jc, pp, xx, JSINGLE, n_valid),
                        jnp.asarray(x), p0)
    gx, gp = vjp(jnp.asarray(dy))
    tx = C._t(x, True)
    tp = jax.tree_util.tree_map(lambda a: C._t(a, True), p0)
    got = T.encoder_layer(cfg, tp, tx, n_valid)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-5)
    (got * C._t(dy)).sum().backward()
    pairs = [("x", tx.grad, gx)] + [(path, t.grad, C.ref_leaf(gp, path))
                                    for path, t in tree.items(tp)]
    for name, gt, w in pairs:
        w = np.asarray(w)
        if name.endswith("attn/bk"):   # zero up to rounding (the softmax's shift)
            assert np.abs(gt.numpy()).max() <= 1e-4 * np.abs(np.asarray(gp["attn"]["bq"])).max()
            continue
        err = np.abs(gt.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), f"{name}: {err}"
    if n_valid == jc.n_frames:
        # the whole encoder: every layer, then enc_final
        jm, m = jbuild_model(jc), build_model(cfg)
        want = jm.encode(jax.tree_util.tree_map(jnp.asarray, g), jnp.asarray(x), JSINGLE)
        got = m.encode(jax.tree_util.tree_map(C._t, g), C._t(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)


def test_cross_attention_and_its_kv_match_the_reference():
    C.check_cross_attention(ARCH)


def test_learned_positions_match_the_reference():
    """``embed`` adds the position table's rows: a chunk's [T] positions, a
    decode step's [1], per-row [B, T] positions, clipped to the table."""
    jc, cfg = C.jcfg(ARCH), C.tcfg(ARCH)
    g = _globals()
    jm, m = jbuild_model(jc), build_model(cfg)
    jg, tg = jax.tree_util.tree_map(jnp.asarray, g), jax.tree_util.tree_map(C._t, g)
    rng = np.random.default_rng(14)
    ids = rng.integers(0, jc.vocab_size, size=(C.B, 5)).astype(np.int32)
    top = jc.max_position
    for pos, decode in ((np.arange(100, 105), False), (np.array([top + 7]), True),
                        (np.array([[3, 4, 5, 6, 7], [top - 2, top - 1, top, top + 1, top + 2]]),
                         False)):
        i = ids[:, :1] if decode else ids
        want = jm.embed(jg, jnp.asarray(i), jnp.asarray(pos, jnp.int32), JSINGLE, decode=decode)
        got = m.embed(tg, torch.from_numpy(i).long(), decode=decode,
                      q_pos=torch.from_numpy(pos.astype(np.int32)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="q_pos"):
        m.embed(tg, torch.from_numpy(ids).long())


@pytest.mark.parametrize("plan", list(C.PLANS))
def test_train_step_matches_the_reference(plan):
    C.run_train_step(ARCH, plan)


def test_static_serving_matches_the_reference():
    C.check_serving(ARCH)


def test_serve_and_train_clis_take_whisper():
    C.check_clis(ARCH)


def test_full_model_shapes():
    """whisper-tiny builds 4 decoder slots and the globals' 4 stacked
    encoder layers, a 65536-row position table, a 53248-row padded vocab;
    it resolves train, prefill and decode cells at sp = pp = 1 over 1500
    frames."""
    mdef = build_model(ARCH)
    assert mdef.n_slots == 4
    g = mdef.init_globals(torch.Generator(), device="meta")
    assert tuple(g["encoder"]["attn"]["wq"].shape) == (4, 384, 384)
    assert tuple(g["pos"]["table"].shape) == (65536, 384)
    assert tuple(g["embed"]["table"].shape) == (53248, 384)
    s0 = mdef.init_stage_params(torch.Generator(), device="meta")[0]
    assert {"ln1", "ln2", "xln", "attn", "xattn", "mlp", "gate"} == set(s0)
    for kind in ("train", "prefill", "decode"):
        cell = runner.resolve_cell(ARCH, ShapeConfig("c", 8192, 4, kind), overrides=dict(pp=1, dp=1))
        assert (cell.plan.sp, cell.plan.pp, cell.mdef.n_context()) == (1, 1, 1500)


@pytest.mark.parametrize("arch", [ARCH])
def test_params_and_markers_match_the_reference_leaf_by_leaf(arch):
    C.check_params_and_markers(arch)


@pytest.mark.parametrize("arch", [ARCH])
def test_costmodel_matches_the_reference(arch):
    C.check_costmodel(arch)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_whisper_refuses_what_later_slices_bring(kind):
    """sp > 1 and pp > 1 raise NotImplementedError naming ROADMAP Queue 1
    item 7; the paged engine raises ValueError, as the reference asserts."""
    C.check_refusals(ARCH, kind)
