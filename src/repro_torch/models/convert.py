"""Carry parameters across from the JAX reference.

``params_from_numpy`` takes the reference's ``{"stages": ..., "globals": ...}``
pytree as nested dicts of numpy arrays, in its names and layouts, with the
leading slot dim on every stage leaf (``ModelDef.init_stage_params`` at
pp = 1), and returns the port's parameters: the same globals, and the stage
as a list of per-slot dicts.  With ``stage=s, pp=P`` it returns pipeline
stage s of P: slots ``[s * spp, (s + 1) * spp)`` of that stack, ghost slots
(``model_zoo.ghost_slot``: gate 0) appended past the last layer, as the
reference's ``init_stage_params(rng, s, P)`` pads its stages.

With ``sp=P, model_rank=r`` every leaf is model rank r's shard of P along
its marker's dim (``model_zoo.shard_leaf``; replicated leaves whole), and
``gather_model_shards`` is the inverse: the P ranks' trees (of gradients,
say) back to full leaves.

The caller passes float32 arrays: ``np.asarray`` of a JAX bf16 array is an
``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` refuses.  The cast to
the model dtype happens here, on the torch side, and is exact for values
that came from bf16.  The gates, an MoE router and the SSM mixers' fp32
leaves stay float32, as in the reference (``FP32_LEAVES``).  An MoE slot's
expert stacks are sharded on their expert dim at sp > 1 (their "keep0"
markers); a tied embedding's globals have no head.  A hybrid slot's
Mamba2 leaves keep the reference's [6, ...] mixer stack, and the globals
its ``shared`` block.  A VLM slot's self layers keep the reference's
[every, ...] stack under "self" beside its ``xattn``, ``xmlp``, ``xln1``,
``xln2`` and the two cross gates; whisper's slots carry ``xattn`` and
``xln``, its globals the ``pos`` table, the stacked ``encoder`` layers and
``enc_final``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import tree as tree_mod
from repro_torch.core.tree import leaves
from repro_torch.models.model_zoo import (build_model, ghost_slot, marker_dim, param_markers,
                                         shard_params)


# leaves the reference keeps in fp32 whatever the model dtype, by their
# last path component: the gates (a slot's, a hybrid mixer's, the shared
# block's, a VLM self layer's, its learned cross gates), an MoE slot's
# router (``model_zoo._moe``), a Mamba2 mixer's A_log and D (``_mamba``),
# an RWKV6 layer's lerp, LoRA, decay, bonus and group-norm leaves
# (``_rwkv_tmix``, ``_rwkv_cmix``)
FP32_LEAVES = frozenset((
    "gate", "gate_shared", "xgate_attn", "xgate_mlp", "router", "A_log", "D", "mu_x",
    "ddl_a", "ddl_b", "mu_rkvwg", "dec_a", "dec_b", "w0", "u", "ln_x_scale", "ln_x_bias",
    "mu_k", "mu_r"))


def _tensor(a, name: str, dtype, device):
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f"{name}: expected a float32 array, got {a.dtype}")
    dt = torch.float32 if name.rsplit("/", 1)[-1] in FP32_LEAVES else dtype
    # np.array copies: JAX hands out read-only buffers
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dt)


def _map(tree, fn, prefix=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(tree, prefix.rstrip("/"))


def params_from_numpy(tree, *, dtype=torch.bfloat16, device="cuda", stage: int = 0,
                      pp: int = 1, cfg=None, sp: int = 1, model_rank: int = 0):
    """``cfg`` (the model's config) is needed where stage ``stage`` of
    ``pp`` has ghost slots and at ``sp`` > 1 (its markers)."""
    stages = tree["stages"]
    n_slots = {np.shape(a)[0] for a in leaves(stages)}
    if len(n_slots) != 1:
        raise ValueError(f"stage leaves disagree on the slot dim: {n_slots}")
    n = n_slots.pop()
    if not 0 <= stage < pp:
        raise ValueError(f"stage {stage} outside [0, {pp})")
    spp = -(-n // pp)
    lo, hi = stage * spp, min(n, (stage + 1) * spp)
    slots = [_map(stages, lambda a, name, i=i: _tensor(a[i], name, dtype, device))
             for i in range(lo, hi)]
    if len(slots) < spp:
        if cfg is None:
            raise ValueError(f"stage {stage} of {pp} pads {spp - len(slots)} ghost "
                             "slot(s): pass cfg")
        slots += [ghost_slot(cfg, dtype, device) for _ in range(spp - len(slots))]
    glob = _map(tree["globals"], lambda a, name: _tensor(a, name, dtype, device))
    params = {"stages": slots, "globals": glob}
    if sp == 1:
        return params
    if cfg is None:
        raise ValueError(f"model rank {model_rank} of {sp}: pass cfg (its shard markers)")
    if not 0 <= model_rank < sp:
        raise ValueError(f"model rank {model_rank} outside [0, {sp})")
    return shard_params(params, build_model(cfg), sp, model_rank)


def gather_model_shards(rank_trees, cfg):
    """The inverse of ``params_from_numpy(sp=, model_rank=)``: ``rank_trees``,
    one tree a model rank in rank order (a stage's slots and the globals,
    numpy arrays or tensors), concatenated along each leaf's marker dim;
    a replicated leaf is rank 0's."""
    first = rank_trees[0]
    flat = [tree_mod.leaves(t) for t in rank_trees]
    marks = iter(tree_mod.leaves(param_markers(build_model(cfg), first)))
    out = []
    for parts in zip(*flat):
        dim = marker_dim(next(marks))
        if dim is None:
            out.append(parts[0])
        elif isinstance(parts[0], torch.Tensor):
            out.append(torch.cat(parts, dim=dim))
        else:
            out.append(np.concatenate(parts, axis=dim))
    it = iter(out)
    return tree_mod.map_(lambda _: next(it), first)
