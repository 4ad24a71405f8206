"""AdamW with global-norm clipping and a cosine schedule (port of
``repro/optim/adamw.py``, moments on the device).

The update is the reference's, written out by hand: gradients clipped by
their global norm, bias-corrected moments, ``eps`` outside the square root,
decoupled weight decay on matrices only (``ndim >= 2``).
``torch.optim.AdamW`` puts ``eps`` and the decay elsewhere and computes a
different update.  The moments and the arithmetic are fp32 whatever the
parameter dtype (the reference's bf16 moments are deepseek's, not yet a
model of the port).  Parameters and moments
are updated in place (the reference returns new arrays): the moments are
the largest state of training, and no second copy of them is made.

Moment offload to host memory and the compressed moment codecs
(``offload_moments``, ``moments_dtype``) come with a later slice (ROADMAP
Queue 1, item 6) and raise until then.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import tree


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 [] on the parameters' device
    m: object            # tree like params
    v: object            # tree like params


def _no_offload(offload_moments, moments_dtype):
    if offload_moments or moments_dtype not in (None, "none"):
        raise NotImplementedError(
            "optimizer-moment offload and the moment codecs come with a later "
            "slice of the port (ROADMAP Queue 1, item 6)")


def init_state(params, *, offload_moments=False,
               moments_dtype="none") -> AdamWState:
    """Zero fp32 moments beside each parameter."""
    _no_offload(offload_moments, moments_dtype)
    dev = tree.leaves(params)[0].device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree.map_(zeros, params), v=tree.map_(zeros, params))


def cosine_lr(step, *, peak=3e-4, warmup=100, total=10000, floor=0.1):
    """Linear warmup to ``peak``, then cosine decay to ``floor * peak`` at
    ``total``: an fp32 tensor, computed as the reference computes it."""
    step = torch.as_tensor(step)
    warm = peak * (step + 1) / warmup
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos).to(torch.float32)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree.leaves(grads)))


@torch.no_grad()
def apply_update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0,
                 offload_moments=False, moments_dtype="none"):
    """One AdamW step, in place.  Returns (params, state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``."""
    _no_offload(offload_moments, moments_dtype)
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    for p, g, m, v in zip(*(tree.leaves(t) for t in (params, grads, state.m, state.v))):
        g32 = g.float() * scale
        m32 = b1 * m + (1 - b1) * g32
        v32 = b2 * v + (1 - b2) * g32 * g32
        del g32
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        m.copy_(m32)
        v.copy_(v32)
        del m32, v32
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            u = u + weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
