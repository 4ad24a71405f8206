"""Parameter init and ModelDef for the dense family (port of ``repro/models/model_zoo.py``).

Parameters are plain dicts of tensors in the reference's names and layouts
(weights ``[in, out]``).  The stage is a list with one dict per slot; the
reference stacks slots on a leading dim for its scan, and
``models/convert.py`` unstacks a JAX pytree into this form.

Init draws from an explicit ``torch.Generator`` with the reference's
distributions (truncated normal at +-2 sigma, the same standard deviations,
zero biases, zero RMSNorm scales), not its bits.  Values are drawn in fp32
and cast to the model dtype, as the reference does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def trunc_normal(gen, shape, std, dtype, device):
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


def dense_init(gen, d_in, d_out, dtype, device, *, std=None):
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    return trunc_normal(gen, (d_in, d_out), std, dtype, device)


def _norm(cfg, dtype, device):
    d = cfg.d_model
    if cfg.norm == "rmsnorm":
        return {"scale": torch.zeros((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def _attn(gen, cfg, dtype, device, out_scale=1.0):
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": dense_init(gen, d, H * hd, dtype, device),
        "wk": dense_init(gen, d, Hkv * hd, dtype, device),
        "wv": dense_init(gen, d, Hkv * hd, dtype, device),
        "wo": dense_init(gen, H * hd, d, dtype, device,
                         std=out_scale / math.sqrt(H * hd)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", H * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
            p[name] = torch.zeros((width,), dtype=dtype, device=device)
    return p


def _mlp(gen, cfg, dtype, device, out_scale=1.0):
    d, ff = cfg.d_model, cfg.d_ff
    p = {"w1": dense_init(gen, d, ff, dtype, device),
         "w2": dense_init(gen, ff, d, dtype, device,
                          std=out_scale / math.sqrt(ff))}
    if cfg.act in ("swiglu", "geglu"):
        p["w3"] = dense_init(gen, d, ff, dtype, device)
    elif cfg.mlp_bias:
        p["b1"] = torch.zeros((ff,), dtype=dtype, device=device)
        p["b2"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def _out_scale(cfg):
    return 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))


def init_slot(cfg: ModelConfig, gen, dtype, device):
    """One dense slot's params.  The gate is 1 for a real layer; the ghost
    slots that pad pipeline stages (gate 0) come with the multi-rank slice."""
    os_ = _out_scale(cfg)
    return {"ln1": _norm(cfg, dtype, device), "ln2": _norm(cfg, dtype, device),
            "attn": _attn(gen, cfg, dtype, device, os_),
            "mlp": _mlp(gen, cfg, dtype, device, out_scale=os_),
            "gate": torch.tensor(1.0, dtype=torch.float32, device=device)}


def init_globals(cfg: ModelConfig, gen, dtype, device):
    d = cfg.d_model
    vp = L.pad_vocab(cfg.vocab_size, 2048)
    return {
        "embed": {"table": trunc_normal(gen, (vp, d), 0.02, dtype, device)},
        "final_norm": _norm(cfg, dtype, device),
        "head": {"w": trunc_normal(gen, (d, vp), 1 / math.sqrt(d), dtype,
                                   device)},
    }


@dataclass(frozen=True)
class ModelDef:
    cfg: ModelConfig
    n_slots: int

    def init_stage_params(self, gen, dtype=torch.bfloat16, device="cuda"):
        return [init_slot(self.cfg, gen, dtype, device) for _ in range(self.n_slots)]

    def init_globals(self, gen, dtype=torch.bfloat16, device="cuda"):
        return init_globals(self.cfg, gen, dtype, device)

    def embed(self, g, ids):
        table = g["embed"]["table"]
        return L.embed_tokens(ids, table, out_dtype=table.dtype)

    def head_logits(self, g, x):
        """Full-vocab fp32 logits (padding columns sliced off) for sampling."""
        x = L.apply_norm(x, g["final_norm"], self.cfg.norm)
        logits = (x @ g["head"]["w"]).float()
        return logits[..., :self.cfg.vocab_size]

    def init_state(self, batch: int, cache_loc: int, dtype, device):
        cfg = self.cfg
        return [{"kv": A.init_cache(batch, cache_loc, cfg.n_kv_heads, cfg.hd,
                                    cfg.hd, dtype, device)}
                for _ in range(self.n_slots)]

    def stage_apply(self, stage_params, state, x, meta):
        return T.stage_apply(self.cfg, stage_params, state, x, meta)


def build_model(name_or_cfg) -> ModelDef:
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    if (cfg.family != "dense" or cfg.pos_emb != "rope" or cfg.tie_embeddings
            or not cfg.rope):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense decoders with RoPE and an untied "
            "head; other families come with later slices")
    return ModelDef(cfg, cfg.n_layers)
