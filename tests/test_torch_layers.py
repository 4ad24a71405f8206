"""The port's model layers against the JAX reference at 1e-5 (fp32, CPU).

Norms (RMSNorm's ``1 + scale``, LayerNorm), interleaved-pair RoPE, the MLP
variants (swiglu, tanh-gelu), the masked embedding gather and the LM head
logits, on the same numpy inputs in both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import layers as JL
from repro.models.model_zoo import build_model as jbuild_model
from repro.parallel.ctx import SINGLE
from repro_torch.configs.base import get_config
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

TOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _normal(rng, shape, std=1.0):
    return (rng.standard_normal(shape) * std).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def test_norms_match_jax():
    rng = _rng()
    x = rng.standard_normal((2, 5, 48), np.float32) * 3 + 0.5
    scale = rng.standard_normal(48).astype(np.float32) * 0.1
    bias = rng.standard_normal(48).astype(np.float32)
    t = torch.from_numpy
    _close(L.rms_norm(t(x), t(scale)), JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    _close(L.layer_norm(t(x), t(scale), t(bias)),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
    for kind, p in (("rmsnorm", {"scale": scale}),
                    ("layernorm", {"scale": scale, "bias": bias})):
        _close(L.apply_norm(t(x), {k: t(v) for k, v in p.items()}, kind),
               JL.apply_norm(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()},
                             kind))


@pytest.mark.parametrize("theta,fraction,per_row", [
    (1e6, 1.0, False), (1e4, 1.0, True), (1e4, 0.5, False)])
def test_rope_matches_jax(theta, fraction, per_row):
    rng = _rng(1)
    B, T, H, hd = 2, 7, 3, 16
    x = rng.standard_normal((B, T, H, hd), np.float32)
    pos = (rng.integers(0, 4000, size=(B, T)) if per_row
           else np.arange(T) + 300).astype(np.int32)
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, fraction)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, fraction)
    _close(got, want)
    inv, rot = L.rope_freqs(hd, theta, fraction)
    jinv, jrot = JL.rope_freqs(hd, theta, fraction)
    assert rot == jrot
    _close(inv, jinv)


@pytest.mark.parametrize("act,bias", [("swiglu", False), ("gelu", False),
                                      ("gelu", True), ("geglu", False),
                                      ("relu2", True)])
def test_mlp_matches_jax(act, bias):
    rng = _rng(2)
    d, ff = 32, 64
    x = rng.standard_normal((2, 5, d), np.float32)
    p = {"w1": _normal(rng, (d, ff), d ** -0.5),
         "w2": _normal(rng, (ff, d), ff ** -0.5)}
    if act in ("swiglu", "geglu"):
        p["w3"] = _normal(rng, (d, ff), d ** -0.5)
    if bias:
        p["b1"] = rng.standard_normal(ff).astype(np.float32)
        p["b2"] = rng.standard_normal(d).astype(np.float32)
    got = L.mlp(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()}, act)
    want = JL.mlp(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, act)
    _close(got, want)


def test_embed_matches_jax_including_out_of_range_ids():
    rng = _rng(3)
    table = rng.standard_normal((40, 16), np.float32)
    ids = rng.integers(0, 40, size=(3, 9)).astype(np.int32)
    ids[0, 0], ids[1, 4], ids[2, 8] = -1, 40, 1000   # gathered as zero rows
    got = L.embed_tokens(torch.from_numpy(ids), torch.from_numpy(table),
                         out_dtype=torch.float32)
    want = JL.embed_tokens(jnp.asarray(ids), jnp.asarray(table), SINGLE,
                           out_dtype=jnp.float32)
    _close(got, want)
    assert (got[0, 0] == 0).all() and (got[2, 8] == 0).all()
    assert L.pad_vocab(152064, 2048) == JL.pad_vocab(152064, 2048) == 153600


@pytest.mark.parametrize("arch", ["qwen2-7b", "sppo-gpt-7b"])
def test_head_logits_and_embed_match_jax(arch):
    cfg_t, cfg_j = get_config(arch).reduced(), jget_config(arch).reduced()
    rng = _rng(4)
    d, vp = cfg_t.d_model, L.pad_vocab(cfg_t.vocab_size, 2048)
    g = {"embed": {"table": _normal(rng, (vp, d), 0.02)},
         "final_norm": {"scale": _normal(rng, d, 0.1)},
         "head": {"w": _normal(rng, (d, vp), d ** -0.5)}}
    if cfg_t.norm == "layernorm":
        g["final_norm"]["bias"] = rng.standard_normal(d).astype(np.float32)
    gt = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in g.items()}
    gj = {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in g.items()}
    x = rng.standard_normal((2, 3, d), np.float32)
    got = build_model(cfg_t).head_logits(gt, torch.from_numpy(x))
    want = jbuild_model(cfg_j).head_logits(gj, jnp.asarray(x), SINGLE)
    assert got.shape[-1] == cfg_t.vocab_size and got.dtype == torch.float32
    _close(got, want)
    ids = rng.integers(0, cfg_t.vocab_size, size=(2, 6)).astype(np.int32)
    q_pos = jnp.arange(6, dtype=jnp.int32)
    _close(build_model(cfg_t).embed(gt, torch.from_numpy(ids)),
           jbuild_model(cfg_j).embed(gj, jnp.asarray(ids), q_pos, SINGLE))
