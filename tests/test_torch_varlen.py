"""Packed variable-length training in the port against the JAX reference, on
the CPU (DESIGN.md §13).

- The packed half of ``core/partition.py`` and the packing half of
  ``data/pipeline.py`` are copies (numpy), held identical to the
  reference's on fixed cases, array for array: one seed gives one corpus in
  both packages.
- ``resolve_cell(doc_lens=)`` deploys the reference's chunks and α at the
  port's H100 numbers (tests/test_varlen.py::test_varlen_cell_profile_drives_schedule).
- The packed step on reduced qwen2-7b in fp32 (S = 256, n_chunks = 4: the
  128-token multiple leaves two chunks, as in the reference's test; the
  plain kernels): its loss and every gradient equal JAX's ``run_pipeline(...,
  doc_start=)`` at 1e-5 with offload off and under the default plan, and
  the port's own pad-to-max oracle (each document alone in a row, at its
  packed offsets) at 1e-5
  (tests/test_varlen.py::test_packed_equals_pad_to_max_oracle_pp1); under
  ``grad_accum`` the document windows are split by microbatch as the
  tokens are.  JAX runs once per case for the whole module.
- The attention's document window: the port's plain kernels against the
  reference's on a packed chunk with a dead padding tail, forward and
  gradients, and ``q_start=None`` identical to zeros
  (tests/test_varlen.py::test_qstart_none_is_identity).
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
from repro.core import costmodel as jcm
from repro.core import partition as jpart
from repro.data import pipeline as jpipe
from repro.kernels import ref as jref
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel import runner as jrunner
from repro.parallel.ctx import SINGLE
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import partition as part
from repro_torch.core import tree
from repro_torch.data import pipeline as dpipe
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import train
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import runner

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

TOL = 1e-5
S = 256


def _same_batch(a, b):
    for f in ("tokens", "labels", "seg_ids", "doc_start"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.spans == b.spans and a.n_real_tokens == b.n_real_tokens


# ---------------------------------------------------------------------------
# partition.py (packed half) and data/pipeline.py (packing half)
# ---------------------------------------------------------------------------

LENGTH_CASES = [([5, 3, 2], 8), ([200, 27, 7, 5, 5, 5, 2, 2, 2, 2], 256),
                ([64] * 9 + [1, 255], 256), ([4625, 3567, 3171, 1982, 1850, 1057, 925, 132], 8192)]


@pytest.mark.parametrize("lengths,seq", LENGTH_CASES)
def test_packed_partition_matches_reference(lengths, seq):
    rows = part.pack_lengths(lengths, seq)
    assert rows == jpart.pack_lengths(lengths, seq)
    row_lens = [[lengths[i] for i in row] for row in rows] + [[]]
    for r in (0.0, 0.03125, 0.25):
        prof = part.packed_cost_profile(row_lens, seq, r)
        want = jpart.packed_cost_profile(row_lens, seq, r)
        assert prof.dtype == want.dtype
        np.testing.assert_array_equal(prof, want)
        bounds = part.aligned_doc_bounds(row_lens, seq)
        assert bounds == jpart.aligned_doc_bounds(row_lens, seq)
        for n, mult in ((4, 1), (4, 128), (3, 16), (1, 1)):
            for db in (None, bounds):
                got = part.partition_profile(prof, n, mult, doc_bounds=db)
                ref = jpart.partition_profile(want, n, mult, doc_bounds=db)
                assert dataclasses.astuple(got) == dataclasses.astuple(ref)
                assert part.profile_chunk_costs(prof, got) == jpart.profile_chunk_costs(want, ref)
                costs = part.profile_chunk_costs(prof, got)
                assert part.imbalance(costs) == jpart.imbalance(costs)


def test_pack_lengths_refuses_a_document_longer_than_a_row():
    with pytest.raises(AssertionError):
        part.pack_lengths([4, 300], 256)


@pytest.mark.parametrize("kw", [dict(n_docs=10, seed=3, dist="zipf", mean_len=48, max_len=200),
                                dict(n_docs=32, seed=0, dist="zipf", mean_len=768, max_len=8192),
                                dict(n_docs=16, seed=5, dist="lognormal", mean_len=40,
                                     sigma=0.7)])
def test_corpus_packing_and_padding_match_reference(kw):
    np.testing.assert_array_equal(dpipe.sample_doc_lengths(**kw), jpipe.sample_doc_lengths(**kw))
    vocab = 152064 if kw["mean_len"] > 100 else 256
    docs = dpipe.sample_corpus(vocab_size=vocab, **kw)
    jdocs = jpipe.sample_corpus(vocab_size=vocab, **kw)
    assert len(docs) == len(jdocs)
    for a, b in zip(docs, jdocs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    seq = max(256, int(max(len(d) for d in docs)))
    seq = -(-seq // 128) * 128
    pk = dpipe.pack_documents(docs, seq)
    _same_batch(pk, jpipe.pack_documents(docs, seq))
    _same_batch(dpipe.pack_documents(docs, seq, rows=len(pk.tokens) + 2, pad_id=3),
                jpipe.pack_documents(docs, seq, rows=len(pk.tokens) + 2, pad_id=3))
    _same_batch(dpipe.pad_to_max(docs, seq), jpipe.pad_to_max(docs, seq))
    _same_batch(dpipe.pad_to_max(docs, seq, at_packed_offsets=pk, rows=len(docs) + 1),
                jpipe.pad_to_max(docs, seq, at_packed_offsets=jpipe.pack_documents(docs, seq),
                                 rows=len(docs) + 1))
    lens = [len(d) for d in docs]
    _same_batch(dpipe.packed_batch_for(lens, seq, rows=len(pk.tokens), vocab_size=vocab, seed=2),
                jpipe.packed_batch_for(lens, seq, rows=len(pk.tokens), vocab_size=vocab, seed=2))
    assert (dpipe.PAD_START, dpipe.IGNORE_LABEL) == (jpipe.PAD_START, jpipe.IGNORE_LABEL)


# ---------------------------------------------------------------------------
# resolve_cell(doc_lens=)
# ---------------------------------------------------------------------------


def _corpus(vocab, n_docs=10, seed=3):
    """tests/test_varlen.py::_corpus: 10 Zipf documents, mean 48, max 200."""
    docs = dpipe.sample_corpus(n_docs, vocab_size=vocab, seed=seed, dist="zipf", mean_len=48,
                               max_len=200)
    return docs, [len(d) for d in docs]


CHIP_LENS = [int(x) for x in dpipe.sample_doc_lengths(32, seed=0, dist="zipf", mean_len=768,
                                                      max_len=8192)]
CELL_CASES = [  # (arch, reduced, seq, batch, n_chunks, grad_accum, partition, doc lens)
    ("qwen2-7b", True, 256, 4, 2, 1, "flops", "corpus"),
    ("qwen2-7b", True, 512, 4, 4, 2, "flops", "corpus"),
    ("qwen2-7b", True, 256, 10, 4, 1, "length", "corpus"),
    ("sppo-gpt-7b", True, 512, 2, 4, 1, "flops", "corpus"),
    ("qwen2-7b", False, 8192, 3, 4, 3, "flops", "chip"),      # chip_smoke's packed cell
    ("qwen2-7b", False, 8192, 32, 4, 32, "flops", "chip"),    # and its pad-to-max baseline
]


@pytest.mark.parametrize("case", CELL_CASES, ids=[f"cell{i}" for i in range(len(CELL_CASES))])
@pytest.mark.parametrize("offload", [True, False])
def test_varlen_cell_deploys_reference_schedule_and_alphas(case, offload):
    arch, reduced, seq, batch, n_chunks, accum, policy, which = case
    cfg, jcfg = get_config(arch), jget_config(arch)
    cfg, jcfg = ((cfg.reduced(), jcfg.reduced()) if reduced else
                 (dataclasses.replace(cfg, n_layers=4), dataclasses.replace(jcfg, n_layers=4)))
    lens = _corpus(cfg.vocab_size)[1] if which == "corpus" else CHIP_LENS
    h100 = dataclasses.replace(jcm.V5E, name="h100", peak_flops_bf16=cm.H100.peak_flops_bf16,
                               hbm_bw=cm.H100.hbm_bw, d2h_bw=cm.H100.d2h_bw)
    ov = dict(pp=1, dp=1, n_chunks=n_chunks, grad_accum=accum, partition=policy,
              offload=offload)
    got = runner.resolve_cell(cfg, ShapeConfig("t", seq, batch, "train"), overrides=ov,
                              doc_lens=lens)
    want = jrunner.resolve_cell(jbuild_model(jcfg), JShapeConfig("t", seq, batch, "train"),
                                data_size=1, model_size=1, overrides=ov, hw=h100, doc_lens=lens)
    assert got.varlen and got.doc_lens == want.doc_lens == tuple(lens)
    assert dataclasses.astuple(got.sched) == dataclasses.astuple(want.sched)
    np.testing.assert_allclose(got.alphas, want.alphas, rtol=0, atol=1e-12)
    assert any(got.alphas) == offload
    uniform = runner.resolve_cell(cfg, ShapeConfig("t", seq, batch, "train"), overrides=ov)
    assert not uniform.varlen and uniform.doc_lens == ()


def test_varlen_cell_refusals():
    cfg = get_config("qwen2-7b").reduced()
    with pytest.raises(ValueError, match="train/prefill only"):
        runner.resolve_cell(cfg, ShapeConfig("d", 256, 2, "decode"), overrides=dict(pp=1, dp=1),
                            doc_lens=[5, 6])
    with pytest.raises(ValueError, match="packing needs 3 rows > global_batch 2"):
        runner.resolve_cell(cfg, ShapeConfig("t", 256, 2, "train"), overrides=dict(pp=1, dp=1),
                            doc_lens=[200, 200, 200])


# ---------------------------------------------------------------------------
# The attention's document window in the plain kernels
# ---------------------------------------------------------------------------


def _window_case():
    """tests/test_varlen.py::_varlen_attn_case with numpy inputs: [B = 2, T =
    S = 32], two documents in row 0, one and a dead padding tail in row 1."""
    rng = np.random.default_rng(0)
    B, T, H, Hkv, hd = 2, 32, 4, 2, 16
    q = rng.standard_normal((B, T, H, hd), np.float32)
    k = rng.standard_normal((B, T, Hkv, hd), np.float32)
    v = rng.standard_normal((B, T, Hkv, hd), np.float32)
    w = rng.standard_normal((B, T, H, hd), np.float32)
    pos = np.arange(T, dtype=np.int32)
    q_start = np.zeros((B, T), np.int32)
    q_start[0, 20:] = 20
    q_start[1, 24:] = dpipe.PAD_START
    return q, k, v, w, pos, q_start


def test_window_plain_kernels_match_reference_forward_and_grads():
    q, k, v, w, pos, qs = _window_case()

    def jloss(q, k, v):
        o, m, l = jref.attention_partial_ref(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                                             q_start=jnp.asarray(qs))
        return jnp.sum(jref.normalize(o, l) * w), (o, m, l)

    (_, (jo, jm, jl)), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    o, m, l = fa.FlashPartial.apply(*leaves, torch.from_numpy(pos), torch.from_numpy(pos),
                                    torch.from_numpy(qs), True, None, 512)
    out = o / l.clamp_min(1e-30)[..., None]
    val = (out * torch.from_numpy(w)).sum()
    grads = torch.autograd.grad(val, leaves)
    # the scalar sums 4096 products in two orders: held elementwise instead
    jout = jref.normalize(jo, jl)
    for got, want in ((out, jout), (o, jo), (m, jm), (l, jl), *zip(grads, jg)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)
    # a dead query (padding) gives exactly zero output and gradient
    assert (out[1, 24:] == 0).all() and (grads[0][1, 24:] == 0).all()
    assert (m[1, 24:] == -1e30).all() and (l[1, 24:] == 0).all()


def test_window_none_is_identical_to_zeros():
    q, k, v, w, pos, _ = _window_case()
    ins = [torch.from_numpy(a) for a in (q, k, v)]
    p = torch.from_numpy(pos)
    zeros = torch.zeros(q.shape[:2], dtype=torch.int32)
    fwd = [fa.partial_forward(*ins, p, p, qs, causal=True, scale=0.25) for qs in (None, zeros)]
    for a, b in zip(*fwd):
        assert torch.equal(a, b)
    do = torch.from_numpy(w)
    dl = torch.ones(q.shape[:3])
    bwd = [fa.partial_backward(*ins, p, p, qs, do, fwd[0][1], dl, causal=True, scale=0.25)
           for qs in (None, zeros)]
    for a, b in zip(*bwd):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The packed step against JAX and against the pad-to-max oracle
# ---------------------------------------------------------------------------

ALPHAS = (1.0, 0.0)   # the default plan, every row of chunk 0 offloaded


def _overrides(layout, plan, accum=1):
    ov = dict(pp=1, dp=1, n_chunks=4, grad_accum=accum, partition="flops")
    if plan == "off":
        ov.update(offload=False, remat="none")
    return ov


def _batches(vocab):
    docs, lens = _corpus(vocab)
    packed = dpipe.pack_documents(docs, S)
    oracle = dpipe.pad_to_max(docs, S, at_packed_offsets=packed)
    return lens, {"packed": packed, "oracle": oracle}


def _jax_case(mdef, params, layout, plan):
    lens, batches = _batches(mdef.cfg.vocab_size)
    pb = batches[layout]
    cell = jrunner.resolve_cell(mdef, JShapeConfig("t", S, pb.tokens.shape[0], "train"),
                                data_size=1, model_size=1, overrides=_overrides(layout, plan),
                                doc_lens=lens)
    cell = dataclasses.replace(cell, dtype=jnp.float32)
    if plan == "default":
        cell = dataclasses.replace(cell, alphas=ALPHAS)
    tok, lab, ds = (jnp.asarray(a) for a in (pb.tokens, pb.labels, pb.doc_start))

    def f(st, gl):
        out = jrunner.run_pipeline(cell, SINGLE, st, gl, tok, lab, None, with_loss=True,
                                   doc_start=ds)
        return out["loss"] / jnp.maximum(out["denom"], 1.0)

    loss, (gs, gg) = jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(params["stages"],
                                                                    params["globals"])
    to_np = functools.partial(jax.tree_util.tree_map, lambda a: np.asarray(a, np.float32))
    return float(loss), to_np({"stages": gs, "globals": gg}), cell.sched.lengths


JAX_CASES = [("packed", "off"), ("packed", "default")]


@pytest.fixture(scope="module")
def jax_ref():
    """The reference's fp32 parameters and, for each case of JAX_CASES, its
    loss, gradients and chunk lengths: JAX runs once per case for the
    module."""
    mdef = jbuild_model(jget_config("qwen2-7b").reduced())
    key = jax.random.PRNGKey(0)
    params = {"stages": mdef.init_stage_params(key, 0, 1, jnp.float32),
              "globals": mdef.init_globals(key, jnp.float32)}
    out = {case: _jax_case(mdef, params, *case) for case in JAX_CASES}
    out["params"] = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    return out


def _jax_leaf(grads, path):
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


def _port(params_np, layout, plan, accum=1, rows=slice(None)):
    cfg = get_config("qwen2-7b").reduced()
    lens, batches = _batches(cfg.vocab_size)
    pb = batches[layout]
    tok, lab, ds = (torch.from_numpy(a[rows]) for a in (pb.tokens, pb.labels, pb.doc_start))
    cell = runner.resolve_cell(cfg, ShapeConfig("t", S, len(tok), "train"),
                               overrides=_overrides(layout, plan, accum), dtype=torch.float32,
                               doc_lens=lens)
    if plan == "default":
        cell = dataclasses.replace(cell, alphas=ALPHAS)
    params = params_from_numpy(params_np, dtype=torch.float32, device="cpu")
    loss, grads = runner.loss_and_grads(cell, params, tok, lab, ds)
    return float(loss), grads, cell


@pytest.mark.parametrize("layout,plan", JAX_CASES)
def test_packed_loss_and_every_grad_match_jax(jax_ref, layout, plan):
    want_loss, want, lengths = jax_ref[(layout, plan)]
    loss, grads, cell = _port(jax_ref["params"], layout, plan)
    assert cell.sched.lengths == lengths == (128, 128)
    assert (cell.plan.offload, cell.plan.remat) == ((True, "sppo") if plan == "default"
                                                    else (False, "none"))
    np.testing.assert_allclose(loss, want_loss, rtol=0, atol=TOL)
    n = 0
    for path, g in tree.items(grads):
        np.testing.assert_allclose(g.numpy(), _jax_leaf(want, path), rtol=0, atol=TOL,
                                   err_msg=path)
        n += 1
    assert n == len(tree.leaves(grads)) > 20


@pytest.mark.parametrize("plan", ["off", "default"])
def test_packed_equals_pad_to_max_oracle(jax_ref, plan):
    """Packed rows and one document a row at the packed offsets (positions,
    RoPE angles and causal windows the same) give the same loss and
    gradients at 1e-5, in the port alone."""
    lp, gp, _ = _port(jax_ref["params"], "packed", plan)
    lo, go, cell = _port(jax_ref["params"], "oracle", plan)
    assert cell.shape.global_batch == 10
    np.testing.assert_allclose(lp, lo, rtol=0, atol=TOL)
    for (path, a), b in zip(tree.items(gp), tree.leaves(go)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL, err_msg=path)


def test_grad_accum_splits_the_windows_by_microbatch(jax_ref):
    """Under grad_accum = 2 the oracle's 10 rows run as two microbatches of
    5, each with its own rows' document windows: the loss and gradients
    are the means of the two halves run alone."""
    la, ga, cell = _port(jax_ref["params"], "oracle", "default", accum=2)
    assert cell.plan.grad_accum == 2
    halves = [_port(jax_ref["params"], "oracle", "default", rows=slice(a, a + 5))
              for a in (0, 5)]
    np.testing.assert_allclose(la, (halves[0][0] + halves[1][0]) / 2, rtol=0, atol=TOL)
    for (path, g), h0, h1 in zip(tree.items(ga), tree.leaves(halves[0][1]),
                                 tree.leaves(halves[1][1])):
        np.testing.assert_allclose(g.numpy(), ((h0.float() + h1.float()) / 2).numpy(),
                                   rtol=0, atol=TOL, err_msg=path)


def test_doc_start_reaches_attention_only_in_a_varlen_cell(jax_ref):
    """A uniform cell ignores doc_start, as the reference's train step
    passes it only when ``cell.varlen``; a varlen cell's window changes the
    loss."""
    cfg = get_config("qwen2-7b").reduced()
    lens, batches = _batches(cfg.vocab_size)
    pb = batches["packed"]
    params = params_from_numpy(jax_ref["params"], dtype=torch.float32, device="cpu")
    tok, lab, ds = (torch.from_numpy(a) for a in (pb.tokens, pb.labels, pb.doc_start))
    ov = _overrides("packed", "off")
    shape = ShapeConfig("t", S, pb.tokens.shape[0], "train")
    uniform = runner.resolve_cell(cfg, shape, overrides=ov, dtype=torch.float32)
    varlen = runner.resolve_cell(cfg, shape, overrides=ov, dtype=torch.float32, doc_lens=lens)
    with_ds = float(runner.loss_and_grads(uniform, params, tok, lab, ds)[0])
    without = float(runner.loss_and_grads(uniform, params, tok, lab)[0])
    assert with_ds == without
    assert float(runner.loss_and_grads(varlen, params, tok, lab, ds)[0]) != without


def test_train_body_takes_a_packed_batch_on_cpu():
    """``launch.train.train(packed=)``: the default plan on packed rows, the
    same batch every step; the loss falls."""
    cfg = get_config("qwen2-7b").reduced()
    docs, _ = _corpus(cfg.vocab_size)
    pb = dpipe.pack_documents(docs, 512)
    out = train.train(cfg, steps=4, seq=512, batch=pb.tokens.shape[0], n_chunks=4,
                      lr=3e-3, log_every=4, device="cpu", packed=pb)
    cell, losses = out["cell"], [r["loss"] for r in out["history"]]
    assert cell.varlen and cell.sched.n == 4 and any(cell.alphas)
    assert (cell.plan.offload, cell.plan.remat, cell.plan.prefetch) == (True, "sppo", "ahead")
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="is not"):
        train.train(cfg, steps=1, seq=256, batch=2, device="cpu", packed=pb)
