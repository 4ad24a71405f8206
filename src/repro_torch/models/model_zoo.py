"""Parameter init and ModelDef for the dense, MoE, SSM, hybrid, VLM and
audio families (port of ``repro/models/model_zoo.py``).

Parameters are plain dicts of tensors in the reference's names and layouts
(weights ``[in, out]``).  The stage is a list with one dict per slot; the
reference stacks slots on a leading dim for its scan, and
``models/convert.py`` unstacks a JAX pytree into this form.

Init draws from an explicit ``torch.Generator`` with the reference's
distributions (truncated normal at +-2 sigma, the same standard deviations,
zero biases, zero RMSNorm scales), not its bits.  Values are drawn in fp32
and cast to the model dtype, as the reference does.

Shard-dim markers (the reference's, leaves of a tree mirroring the params):

- int d: "ag", stored sharded on dim d over the model axis, all-gathered
  at each use (``transformer.gather_params``);
- ``"keepN"``: stored and used sharded on dim N (the embedding table on
  the vocab, the head's vocab columns, an MoE slot's expert stacks on the
  expert dim: expert parallelism, never gathered);
- ``"rep"``: replicated over the model axis; each model rank's gradient is
  its own shard's, summed over the model group by the runner.

The markers describe one slot's (or one global leaf's) layout; a model
rank holds slice ``rank`` of ``sp`` of every marked dim (``shard_params``).

An MoE slot is a GQA layer (granite) or an MLA layer (deepseek-v3,
``_mla``: the LoRA queries, the latent kv and the absorbed up-projections)
whose MLP is ``models/moe.py``'s block: the router fp32 and replicated, the
expert stacks [E, d, ff] / [E, ff, d], and, for deepseek's shared experts,
"ag" leaves like an MLP's.  An MLA slot's cache is the latent
[B, L, 1, dc + dr] alone, its v the view of the first dc columns.
A tied embedding (``cfg.tie_embeddings``) has no head leaf: the head is
the table transposed, at sp > 1 the rank's vocab rows.

An SSM slot (rwkv6-3b) is an RWKV6 layer: a time-mix (``_rwkv_tmix``,
whose LoRA, decay, bonus and group-norm leaves are fp32 whatever the model
dtype) and a channel-mix (``_rwkv_cmix``), LayerNorm before each.  A
hybrid slot (zamba2-7b) is a group of ``shared_attn_every`` Mamba2 mixers,
their leaves stacked on a leading [6, ...] dim as the reference stacks
them (``A_log`` and ``D`` fp32), each with its norm and gate, then the
weight-shared attention block, the globals' ``shared`` leaf (its own norms,
GQA and MLP), applied under the slot's ``gate_shared``.  ⌈n_layers / 6⌉
slots hold the mixers; the last slot's mixers past ``n_layers`` carry gate
0 (zamba2's 81 mixers: 14 slots, 3 ghost mixers).  The slots' state is the
mixers' fp32 recurrent state (``models/ssm.py``) and, in a hybrid slot,
the shared block's KV cache under "kv" (the reference's ``shared_kv``).

A VLM slot (llama-3.2-vision-11b) is a group of ``cross_attn.every`` self
layers, their leaves stacked [every, ...] under "self", then the
cross-attention layer (``xattn``, ``xln1``, ``xmlp``, ``xln2``) under its
fp32 tanh gates ``xgate_attn`` / ``xgate_mlp`` (0 at init, as in the
reference): ⌈n_layers / every⌉ slots.  An audio slot (whisper-tiny) is a
decoder layer with ``xattn`` and ``xln`` beside its self attention; the
globals hold the learned ``pos`` table, the stacked ``encoder`` layers and
``enc_final``.  Their state holds "xkv", the context's K/V by each slot's
``xattn`` (``init_state(stage_params=, context=)``), beside the self
caches (a list under "self" for a VLM group).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import tree
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.parallel.ctx import SINGLE
from repro_torch.runtime.kvpool import SINK_SLOTS


# a leaf of more elements than this is drawn a slice of its leading dim at a
# time: deepseek-v3's [256, 7168, 2048] expert stacks would otherwise take
# two fp32 copies (30 GB) on the way to their 7.5 GB of bf16
CHUNKED_DRAW = 2**31


def trunc_normal(gen, shape, std, dtype, device):
    if math.prod(shape) > CHUNKED_DRAW:
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            out[i] = trunc_normal(gen, shape[1:], std, dtype, device)
        return out
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


def _mla(gen, cfg, dtype, device, out_scale=1.0):
    """MLA's leaves (reference ``model_zoo.py:86-98``): the query LoRA
    (``wq_a``, its RMSNorm ``q_norm``, ``wq_b`` to H x (nope + rope)), the
    latent down-projection ``wkv_a`` to dc + dr with its RMSNorm ``kv_norm``
    on the dc part, the per-head absorbed ``w_uk`` [H, dn, dc] and ``w_uv``
    [H, dc, dv], and ``wo``."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    dn, dr, dv, dc, qr = (m.nope_head_dim, m.rope_head_dim, m.v_head_dim,
                          m.kv_lora_rank, m.q_lora_rank)
    return {
        "wq_a": dense_init(gen, d, qr, dtype, device),
        "q_norm": torch.zeros((qr,), dtype=dtype, device=device),
        "wq_b": dense_init(gen, qr, H * (dn + dr), dtype, device),
        "wkv_a": dense_init(gen, d, dc + dr, dtype, device),
        "kv_norm": torch.zeros((dc,), dtype=dtype, device=device),
        "w_uk": trunc_normal(gen, (H, dn, dc), 1 / math.sqrt(dn), dtype, device),
        "w_uv": trunc_normal(gen, (H, dc, dv), 1 / math.sqrt(dc), dtype, device),
        "wo": dense_init(gen, H * dv, d, dtype, device, std=out_scale / math.sqrt(H * dv)),
    }


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


def _moe(gen, cfg, dtype, device, out_scale=1.0):
    m, d = cfg.moe, cfg.d_model
    E, ff = m.num_experts, m.d_ff_expert
    p = {"router": dense_init(gen, d, E, torch.float32, device),
         "w1": trunc_normal(gen, (E, d, ff), 1 / math.sqrt(d), dtype, device),
         "w3": trunc_normal(gen, (E, d, ff), 1 / math.sqrt(d), dtype, device),
         "w2": trunc_normal(gen, (E, ff, d), out_scale / math.sqrt(ff), dtype, device)}
    if m.n_shared_experts:
        sf = ff * m.n_shared_experts
        p["ws1"] = dense_init(gen, d, sf, dtype, device)
        p["ws3"] = dense_init(gen, d, sf, dtype, device)
        p["ws2"] = dense_init(gen, sf, d, dtype, device, std=out_scale / math.sqrt(sf))
    return p


def _mamba(gen, cfg, dtype, device):
    """One Mamba2 mixer's leaves (reference ``model_zoo.py:158-177``)."""
    ssm, d = cfg.ssm, cfg.d_model
    d_in = ssm.expand * d
    H = d_in // ssm.head_dim
    ds, W = ssm.d_state, ssm.conv_width

    def const(a, dt):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dt)

    return {
        "in_x": dense_init(gen, d, d_in, dtype, device),
        "in_bc": dense_init(gen, d, 2 * ds, dtype, device),
        "in_dt": dense_init(gen, d, H, dtype, device),
        "in_z": dense_init(gen, d, d_in, dtype, device),
        "dt_bias": const(np.log(np.expm1(np.linspace(1e-3, 1e-1, H))), dtype),
        "conv_x": trunc_normal(gen, (W, d_in), 1 / math.sqrt(W), dtype, device),
        "conv_bc": trunc_normal(gen, (W, 2 * ds), 1 / math.sqrt(W), dtype, device),
        "A_log": const(np.log(np.linspace(1.0, 16.0, H)), torch.float32),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "norm_scale": torch.zeros((d_in,), dtype=dtype, device=device),
        "out": dense_init(gen, d_in, d, dtype, device),
    }


def _rwkv_tmix(gen, cfg, dtype, device):
    """An RWKV6 time-mix's leaves (reference ``model_zoo.py:187-206``): the
    lerp and decay LoRAs, w0, the bonus u and the group norm in fp32."""
    d, R, f32 = cfg.d_model, 64, torch.float32

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=device)

    return {
        "mu_x": zeros(d),
        "ddl_a": dense_init(gen, d, 5 * 32, f32, device),
        "ddl_b": trunc_normal(gen, (5 * 32, 5 * d), 0.01, f32, device),
        "mu_rkvwg": zeros(5, d),
        "wr": dense_init(gen, d, d, dtype, device),
        "wk": dense_init(gen, d, d, dtype, device),
        "wv": dense_init(gen, d, d, dtype, device),
        "wg": dense_init(gen, d, d, dtype, device),
        "dec_a": dense_init(gen, d, R, f32, device),
        "dec_b": trunc_normal(gen, (R, d), 0.01, f32, device),
        "w0": torch.linspace(-6.0, -1.0, d, dtype=f32, device=device),
        "u": trunc_normal(gen, (d,), 0.3, f32, device),
        "ln_x_scale": torch.ones((d,), dtype=f32, device=device),
        "ln_x_bias": zeros(d),
        "wo": dense_init(gen, d, d, dtype, device),
    }


def _rwkv_cmix(gen, cfg, dtype, device):
    d, ff = cfg.d_model, cfg.d_ff
    return {"mu_k": torch.zeros((d,), dtype=torch.float32, device=device),
            "mu_r": torch.zeros((d,), dtype=torch.float32, device=device),
            "wk_c": dense_init(gen, d, ff, dtype, device),
            "wv_c": dense_init(gen, ff, d, dtype, device),
            "wr_c": dense_init(gen, d, d, dtype, device)}


def keep(d: int) -> str:
    return f"keep{d}"


def _norm_spec(cfg):
    if cfg.norm == "rmsnorm":
        return {"scale": "rep"}
    return {"scale": "rep", "bias": "rep"}


def _attn_spec(cfg):
    s = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
    if cfg.qkv_bias:
        s.update({"bq": "rep", "bk": "rep", "bv": "rep"})
    return s


def _mla_spec(cfg):
    """The reference's ``_mla_spec``: the query projections and the per-head
    leaves sharded, the latent's replicated (the model-axis MLA is a later
    slice, ``runner.resolve_cell``)."""
    return {"wq_a": 1, "q_norm": "rep", "wq_b": 1, "wkv_a": "rep",
            "kv_norm": "rep", "w_uk": 0, "w_uv": 0, "wo": 0}


def _mlp_spec(cfg):
    s = {"w1": 1, "w2": 0}
    if cfg.act in ("swiglu", "geglu"):
        s["w3"] = 1
    elif cfg.mlp_bias:
        s.update({"b1": "rep", "b2": "rep"})
    return s


def _moe_spec(cfg):
    s = {"router": "rep", "w1": keep(0), "w3": keep(0), "w2": keep(0)}
    if cfg.moe.n_shared_experts:
        s.update({"ws1": 1, "ws3": 1, "ws2": 0})
    return s


def _mamba_spec():
    return {"in_x": keep(1), "in_bc": "rep", "in_dt": keep(1),
            "in_z": keep(1), "dt_bias": keep(0), "conv_x": keep(1),
            "conv_bc": "rep", "A_log": keep(0), "D": keep(0),
            "norm_scale": keep(0), "out": keep(0)}


def _rwkv_tmix_spec():
    return {"mu_x": "rep", "ddl_a": "rep", "ddl_b": 1, "mu_rkvwg": "rep",
            "wr": 1, "wk": 1, "wv": 1, "wg": 1, "dec_a": "rep", "dec_b": 1,
            "w0": "rep", "u": "rep", "ln_x_scale": "rep", "ln_x_bias": "rep",
            "wo": 0}


def _rwkv_cmix_spec():
    return {"mu_k": "rep", "mu_r": "rep", "wk_c": 1, "wv_c": 0, "wr_c": 1}


def _shift_spec(spec):
    """The markers of a leaf stacked on an extra leading dim: the sharded
    dim shifts by one (reference ``_shift_spec``)."""
    def f(m):
        if isinstance(m, int):
            return m + 1
        if isinstance(m, str) and m.startswith("keep"):
            return keep(int(m[4:]) + 1)
        return m
    return tree.map_(f, spec)


def _layer_spec(cfg):
    """A dense layer's markers without the gate (a VLM self layer's and a
    whisper encoder layer's)."""
    return {"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg), "attn": _attn_spec(cfg),
            "mlp": _mlp_spec(cfg)}


def slot_spec(cfg: ModelConfig):
    """The markers of one slot (reference ``slot_spec``)."""
    if cfg.family == "vlm":
        return {"self": _shift_spec({**_layer_spec(cfg), "gate": "rep"}),
                "xln1": _norm_spec(cfg), "xln2": _norm_spec(cfg), "xattn": _attn_spec(cfg),
                "xmlp": _mlp_spec(cfg), "xgate_attn": "rep", "xgate_mlp": "rep",
                "gate": "rep"}
    if cfg.family == "audio":
        return {"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg), "xln": _norm_spec(cfg),
                "attn": _attn_spec(cfg), "xattn": _attn_spec(cfg), "mlp": _mlp_spec(cfg),
                "gate": "rep"}
    if cfg.family == "hybrid":
        mamba = _shift_spec({"ln": _norm_spec(cfg), "mix": _mamba_spec(), "gate": "rep"})
        return {"mamba": mamba, "gate_shared": "rep", "gate": "rep"}
    if cfg.family == "ssm":
        return {"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg), "tmix": _rwkv_tmix_spec(),
                "cmix": _rwkv_cmix_spec(), "gate": "rep"}
    ffn = {"moe": _moe_spec(cfg)} if cfg.family == "moe" else {"mlp": _mlp_spec(cfg)}
    attn = _mla_spec(cfg) if cfg.mla is not None else _attn_spec(cfg)
    return {"ln1": _norm_spec(cfg), "ln2": _norm_spec(cfg), "attn": attn,
            **ffn, "gate": "rep"}


def globals_spec(cfg: ModelConfig):
    """The globals' markers (reference ``globals_spec``): no head where the
    embedding is tied."""
    g = {"embed": {"table": keep(0)}, "final_norm": _norm_spec(cfg)}
    if not cfg.tie_embeddings:
        g["head"] = {"w": keep(1)}
    if cfg.pos_emb == "learned":
        g["pos"] = {"table": "rep"}
    if cfg.shared_attn_every:
        g["shared"] = _layer_spec(cfg)
    if cfg.encoder_layers:
        g["encoder"] = _shift_spec(_layer_spec(cfg))
        g["enc_final"] = _norm_spec(cfg)
    return g


def marker_dim(marker):
    """The sharded dim of a marker, None for "rep" (the reference's
    ``parallel/specs.py::_marker_spec`` without its ``NamedSharding``)."""
    if isinstance(marker, int):
        return marker
    if isinstance(marker, str) and marker.startswith("keep"):
        return int(marker[4:])
    if marker == "rep":
        return None
    raise ValueError(f"unknown shard marker {marker!r}")


def shard_leaf(t, marker, sp: int, rank: int):
    """Model rank ``rank``'s slice of ``t`` (a contiguous copy), ``t`` itself
    where it is replicated or sp = 1."""
    dim = marker_dim(marker)
    if dim is None or sp == 1:
        return t
    if t.shape[dim] % sp:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split over {sp} model ranks")
    return t.chunk(sp, dim=dim)[rank].contiguous()


def shard_params(params, mdef, sp: int, rank: int):
    """``params`` (a stage's slots and the globals, full leaves) -> model
    rank ``rank``'s shard of every leaf."""
    if sp == 1:
        return params
    spec = mdef.stage_spec()
    return {"stages": [tree.map_(lambda t, m: shard_leaf(t, m, sp, rank), slot, spec)
                       for slot in params["stages"]],
            "globals": tree.map_(lambda t, m: shard_leaf(t, m, sp, rank),
                                 params["globals"], mdef.globals_spec())}


def param_markers(mdef, params):
    """A tree like ``params`` (a stage's slots and the globals, or their
    gradients), in its key order, of the leaves' markers."""
    spec = mdef.stage_spec()
    return {"stages": [tree.map_(lambda _, m: m, slot, spec) for slot in params["stages"]],
            "globals": tree.map_(lambda _, m: m, params["globals"], mdef.globals_spec())}


def _out_scale(cfg):
    return 1.0 / math.sqrt(2 * max(cfg.n_layers, 1))


def init_slot(cfg: ModelConfig, gen, dtype, device, index: int = 0):
    """Slot ``index``'s params by family (a dense layer, an MoE layer: GQA
    or MLA and the expert block, an RWKV6 layer, or a hybrid group of
    Mamba2 mixers, those past ``cfg.n_layers`` at gate 0), gate 1 (a real
    slot; ``ghost_slot`` pads a pipeline stage)."""
    one = torch.tensor(1.0, dtype=torch.float32, device=device)
    if cfg.family == "vlm":
        os_ = _out_scale(cfg)
        selfs = [{**_layer(gen, cfg, dtype, device, os_), "gate": one.clone()}
                 for _ in range(cfg.cross_attn.every)]
        zero = torch.zeros((), dtype=torch.float32, device=device)
        return {"self": tree.map_(lambda *a: torch.stack(a), *selfs),
                "xln1": _norm(cfg, dtype, device), "xln2": _norm(cfg, dtype, device),
                "xattn": _attn(gen, cfg, dtype, device, os_),
                "xmlp": _mlp(gen, cfg, dtype, device, out_scale=os_),
                "xgate_attn": zero, "xgate_mlp": zero.clone(), "gate": one}
    if cfg.family == "audio":
        os_ = _out_scale(cfg)
        return {**_layer(gen, cfg, dtype, device, os_), "xln": _norm(cfg, dtype, device),
                "xattn": _attn(gen, cfg, dtype, device, os_), "gate": one}
    if cfg.family == "hybrid":
        n_m = cfg.shared_attn_every
        mixers = [{"ln": _norm(cfg, dtype, device), "mix": _mamba(gen, cfg, dtype, device),
                   "gate": torch.tensor(float(index * n_m + i < cfg.n_layers),
                                        dtype=torch.float32, device=device)}
                  for i in range(n_m)]
        return {"mamba": tree.map_(lambda *a: torch.stack(a), *mixers),
                "gate_shared": one.clone(), "gate": one}
    if cfg.family == "ssm":
        return {"ln1": _norm(cfg, dtype, device), "ln2": _norm(cfg, dtype, device),
                "tmix": _rwkv_tmix(gen, cfg, dtype, device),
                "cmix": _rwkv_cmix(gen, cfg, dtype, device), "gate": one}
    os_ = _out_scale(cfg)
    attn = (_mla if cfg.mla is not None else _attn)(gen, cfg, dtype, device, os_)
    ffn = ({"moe": _moe(gen, cfg, dtype, device, out_scale=os_)} if cfg.family == "moe"
           else {"mlp": _mlp(gen, cfg, dtype, device, out_scale=os_)})
    return {"ln1": _norm(cfg, dtype, device), "ln2": _norm(cfg, dtype, device),
            "attn": attn, **ffn,
            "gate": torch.tensor(1.0, dtype=torch.float32, device=device)}


def ghost_slot(cfg: ModelConfig, dtype, device):
    """A slot that pads the last stages where ``n_layers % pp != 0``: gate
    0, so ``_res`` makes it the identity and no gradient reaches its
    weights.  Its weights are zeros (the reference draws them at random,
    which at gate 0 changes neither the output nor a gradient), so they take
    no draw from the generator and stay zero under AdamW."""
    shape = init_slot(cfg, torch.Generator(), dtype, "meta")
    slot = tree.map_(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), shape)
    slot["gate"] = torch.tensor(0.0, dtype=torch.float32, device=device)
    return slot


def _layer(gen, cfg, dtype, device, out_scale):
    """A dense layer's leaves without the gate: the hybrid family's shared
    block, a VLM self layer, a whisper layer's self part, an encoder
    layer."""
    return {"ln1": _norm(cfg, dtype, device), "ln2": _norm(cfg, dtype, device),
            "attn": _attn(gen, cfg, dtype, device, out_scale),
            "mlp": _mlp(gen, cfg, dtype, device, out_scale=out_scale)}


def init_globals(cfg: ModelConfig, gen, dtype, device):
    """The embedding, final norm and head, and by family the learned
    position table, the hybrid shared block, whisper's encoder layers
    (stacked [encoder_layers, ...]) and their final norm (reference
    ``init_globals``)."""
    d = cfg.d_model
    vp = L.pad_vocab(cfg.vocab_size, 2048)
    g = {"embed": {"table": trunc_normal(gen, (vp, d), 0.02, dtype, device)},
         "final_norm": _norm(cfg, dtype, device)}
    if not cfg.tie_embeddings:
        g["head"] = {"w": trunc_normal(gen, (d, vp), 1 / math.sqrt(d), dtype, device)}
    if cfg.pos_emb == "learned":
        g["pos"] = {"table": trunc_normal(gen, (cfg.max_position, d), 0.02, dtype, device)}
    if cfg.shared_attn_every:
        g["shared"] = _layer(gen, cfg, dtype, device, _out_scale(cfg))
    if cfg.encoder_layers:
        encs = [_layer(gen, cfg, dtype, device, _out_scale(cfg))
                for _ in range(cfg.encoder_layers)]
        g["encoder"] = tree.map_(lambda *a: torch.stack(a), *encs)
        g["enc_final"] = _norm(cfg, dtype, device)
    return g


@dataclass(frozen=True)
class ModelDef:
    cfg: ModelConfig
    n_slots: int

    # ---- structure (reference ``model_zoo.py:457-462``) --------------------
    def slots_per_stage(self, pp: int) -> int:
        return -(-self.n_slots // pp)

    def padded_slots(self, pp: int) -> int:
        return self.slots_per_stage(pp) * pp

    def init_stage_params(self, gen, dtype=torch.bfloat16, device="cuda", *,
                          stage: int = 0, pp: int = 1):
        """Stage ``stage`` of ``pp``: slots ``[stage * spp, (stage + 1) *
        spp)`` of the model, ghost slots (``ghost_slot``) past its last
        layer.  Every real slot is drawn from ``gen`` in layer order and the
        other stages' are dropped, so a stage holds the very tensors pp = 1
        draws for its layers, and ``gen`` ends where pp = 1 leaves it (the
        globals drawn next come out the same on every stage)."""
        spp = self.slots_per_stage(pp)
        if not 0 <= stage < pp:
            raise ValueError(f"stage {stage} outside [0, {pp})")
        lo = stage * spp
        slots = []
        for i in range(self.n_slots):
            slot = init_slot(self.cfg, gen, dtype, device, i)
            if lo <= i < lo + spp:
                slots.append(slot)
        return slots + [ghost_slot(self.cfg, dtype, device)
                        for _ in range(spp - len(slots))]

    def init_globals(self, gen, dtype=torch.bfloat16, device="cuda"):
        return init_globals(self.cfg, gen, dtype, device)

    def stage_spec(self):
        return slot_spec(self.cfg)

    def globals_spec(self):
        return globals_spec(self.cfg)

    def embed(self, g, ids, ctx=SINGLE, *, decode: bool = False, q_pos=None):
        """ids: [B, T] the chunk's token ids (every model rank's); returns
        this rank's sequence shard [B, T / sp, d] (``layers.embed_tokens``).
        With ``decode`` (one token a row, which cannot be sequence-sharded)
        every model rank returns the whole [B, T, d]: the masked lookup in
        its vocab shard, summed over the model group (reference
        ``model_zoo.py:480-490``).  A model with learned positions (whisper)
        adds the position table's rows at ``q_pos`` ([T], or [B, T] a
        position a row), clipped to the table (reference
        ``model_zoo.py:492-496``)."""
        table = g["embed"]["table"]
        if not decode:
            x = L.embed_tokens(ids, table, ctx, out_dtype=table.dtype)
        else:
            vloc = table.shape[0]
            lo = ctx.model_index() * vloc
            hit = ((ids >= lo) & (ids < lo + vloc))[..., None]
            rows = F.embedding((ids - lo).clamp(0, vloc - 1), table)
            x = ctx.psum_model(torch.where(hit, rows, 0).to(table.dtype))
        if self.cfg.pos_emb != "learned":
            return x
        if q_pos is None:
            raise ValueError(f"{self.cfg.name}: learned positions need the chunk's q_pos")
        pos = q_pos.long().clamp(0, self.cfg.max_position - 1)
        # F.embedding: a backward that sums repeated rows in a fixed order
        emb = F.embedding(pos, g["pos"]["table"])
        return x + (emb if pos.dim() == 2 else emb[None])

    def encode(self, g, frames, ctx=SINGLE):
        """Whisper's encoder over the stub frame embeddings [B, F, d]: its
        ``encoder_layers`` bidirectional layers, then ``enc_final`` (reference
        ``model_zoo.py:515-527``); the frames themselves for a model without
        one.  It runs once a pass, outside the chunks."""
        if not self.cfg.encoder_layers:
            return frames
        x = frames
        for i in range(self.cfg.encoder_layers):
            p = tree.map_(lambda a: a[i], g["encoder"])
            x = T.encoder_layer(self.cfg, p, x, self.cfg.n_frames, ctx)
        return L.apply_norm(x, g["enc_final"], self.cfg.norm)

    def n_context(self) -> int:
        """Rows of the context a cross-attention model reads: whisper's
        frames, the VLM's patches (0 without cross-attention)."""
        cfg = self.cfg
        if cfg.cross_attn is None:
            return 0
        return cfg.n_frames if cfg.encoder_layers else cfg.cross_attn.n_context_tokens

    def head(self, g):
        """The head [d, Vp / sp]: its own leaf, or the tied table
        transposed (at sp > 1 this rank's vocab rows of it)."""
        return g["embed"]["table"].T if self.cfg.tie_embeddings else g["head"]["w"]

    def head_loss(self, g, x, labels, mask, ctx=SINGLE):
        """(sum of token losses, sum of weights) of one chunk: the final
        norm on this rank's sequence shard x, then the fp32 vocab-parallel
        cross entropy over the real vocab, labels and mask the chunk's
        ([B, T]); the same sums on every model rank."""
        x = L.apply_norm(x, g["final_norm"], self.cfg.norm)
        return L.vocab_parallel_xent(x, self.head(g), labels, mask, ctx,
                                     real_vocab=self.cfg.vocab_size)

    def head_logits(self, g, x, ctx=SINGLE):
        """Full-vocab fp32 logits (padding columns sliced off) for sampling:
        the rank's vocab shard's logits, gathered over the model group
        (reference ``model_zoo.py:510-517``).  x: [B, T, d], every model
        rank's alike."""
        x = L.apply_norm(x, g["final_norm"], self.cfg.norm)
        logits = ctx.all_gather_model((x @ self.head(g)).float(), axis=x.dim() - 1)
        return logits[..., :self.cfg.vocab_size]

    def init_state(self, batch: int, cache_loc: int, dtype, device, *,
                   train: bool = False, n_slots=None, stage_params=None, context=None):
        """One state per slot: the model's (``n_slots`` None) or a pipeline
        stage's ``n_slots``; a GQA slot's is the dense KV cache, an MLA
        slot's the latent (``attention.init_latent_cache``), an RWKV6
        slot's its zero recurrent state, a hybrid slot's its mixers' zero
        states and the shared block's KV cache (reference
        ``init_slot_state``).  A cross-attention slot's also holds "xkv",
        the K/V of ``context`` ([B, N_ctx, d]: the VLM's patch embeddings,
        whisper's encoder output) by its own ``xattn`` projections of
        ``stage_params`` (``attention.make_cross_kv``, PAD past the
        config's context length), computed once here; a VLM group's self
        caches are a list under "self"."""
        cfg = self.cfg
        n = self.n_slots if n_slots is None else n_slots
        if cfg.cross_attn is not None:
            if stage_params is None or context is None:
                raise ValueError(f"{cfg.name}: the cross-attention state needs the stage "
                                 "parameters and the context")
            n_valid = self.n_context()

            def cache():
                return A.init_cache(batch, cache_loc, cfg.n_kv_heads, cfg.hd, cfg.hd, dtype,
                                    device, train=train)

            states = []
            for p in stage_params[:n]:
                xkv = A.make_cross_kv(context, p["xattn"], cfg, n_valid)
                states.append({"self": [cache() for _ in range(cfg.cross_attn.every)],
                               "xkv": xkv} if cfg.family == "vlm"
                              else {"kv": cache(), "xkv": xkv})
            return states
        if cfg.family == "ssm":
            return [{"rwkv": S.rwkv6_init_state(cfg, batch, device)} for _ in range(n)]
        if cfg.family == "hybrid":
            return [{"kv": A.init_cache(batch, cache_loc, cfg.n_kv_heads, cfg.hd, cfg.hd,
                                        dtype, device, train=train),
                     "mamba": [S.mamba2_init_state(cfg, batch, device)
                               for _ in range(cfg.shared_attn_every)]}
                    for _ in range(n)]
        if cfg.mla is not None:
            m = cfg.mla
            return [{"kv": A.init_latent_cache(batch, cache_loc, m.kv_lora_rank,
                                               m.rope_head_dim, dtype, device, train=train)}
                    for _ in range(n)]
        return [{"kv": A.init_cache(batch, cache_loc, cfg.n_kv_heads, cfg.hd,
                                    cfg.hd, dtype, device, train=train)}
                for _ in range(n)]

    def init_pool(self, geo, dtype, device, *, n_slots=None):
        """The paged KV pool of a rank (reference ``make_pool_state``): one
        ``attention.PooledKV`` a slot, zeros, ``geo.p_loc`` slots and the
        sink (``runtime/kvpool.py``)."""
        cfg = self.cfg
        shape = (geo.p_loc + SINK_SLOTS, cfg.n_kv_heads, cfg.hd)
        return [{"kv": A.PooledKV(k=torch.zeros(shape, dtype=dtype, device=device),
                                  v=torch.zeros(shape, dtype=dtype, device=device))}
                for _ in range(self.n_slots if n_slots is None else n_slots)]

    def stage_apply(self, stage_params, state, x, meta, *, remat="none",
                    offload=None, g=None):
        """The stack on one chunk: (x, state, aux), aux the slots' summed
        MoE balance loss (0.0 for a dense stack); at sp > 1 (``meta.ctx``)
        each slot's "ag" leaves are gathered at use
        (``transformer.gather_params``).  ``g``: the globals, whose shared
        block a hybrid stack hands every slot (reference ``_extras``)."""
        if meta.ctx is not None and meta.ctx.sp > 1 and meta.spec is None:
            meta = meta._replace(spec=self.stage_spec())
        extras = {}
        if self.cfg.shared_attn_every:
            if g is None:
                raise ValueError(f"{self.cfg.name}: the hybrid stack needs the globals (g=)")
            extras = {"shared": g["shared"]}
        return T.stage_apply(self.cfg, stage_params, state, x, meta,
                             remat=remat, offload=offload, extras=extras)


def build_model(name_or_cfg) -> ModelDef:
    """The ModelDef of a config: a slot a layer, a zamba2 group a slot
    (⌈n_layers / shared_attn_every⌉), a VLM group a slot (⌈n_layers /
    cross_attn.every⌉, reference ``model_zoo.py:587-590``)."""
    cfg = (name_or_cfg if isinstance(name_or_cfg, ModelConfig)
           else get_config(name_or_cfg))
    fam = cfg.family
    pos_ok = ((cfg.pos_emb == "rope" and cfg.rope)
              or (fam == "ssm" and cfg.pos_emb == "none" and not cfg.rope)
              or (fam == "audio" and cfg.pos_emb == "learned" and not cfg.rope))
    if (fam not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
            or (cfg.mla is not None and fam != "moe")
            or ((fam in ("vlm", "audio")) != (cfg.cross_attn is not None)) or not pos_ok):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense and MoE decoders (GQA or MLA) with RoPE, "
            "RWKV6 without positions, the Mamba2 hybrid, the cross-attention VLM with RoPE "
            "and whisper's encoder-decoder with learned positions")
    if fam == "hybrid":
        return ModelDef(cfg, -(-cfg.n_layers // cfg.shared_attn_every))
    if fam == "vlm":
        return ModelDef(cfg, -(-cfg.n_layers // cfg.cross_attn.every))
    return ModelDef(cfg, cfg.n_layers)
