"""Dispatch for the attention kernels (port of ``repro/kernels/ops.py``).

``attention_partial`` goes through ``flash_attention.FlashPartial`` on both
devices whenever a gradient is wanted, so its backward is the same Function
everywhere; a call that needs none (serving) runs the forward directly and
pays no Function on the host.  The tensor's device decides, and nothing
else: for a CUDA tensor the forward and backward are the Hopper kernels
(which raise on anything they do not take), for a CPU tensor the plain
versions in kernels/ref.py.  There is no switch that could send CUDA tensors
to the plain path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa


def attention_partial(q, k, v, q_pos, kv_pos, *, causal=True, scale=None,
                      block_k=512, q_start=None):
    """Partial flash attention against a local KV shard (see kernels/ref.py):
    returns the un-normalized (o, m, l), differentiable in q, k and v with
    the max statistic m gradient-frozen.  ``block_k`` is the plain version's
    KV block; the kernels tile on their own."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _fa.FlashPartial.apply(q, k, v, q_pos, kv_pos, q_start, causal,
                                      scale, block_k)
    return _fa.partial_forward(q, k, v, q_pos, kv_pos, q_start, causal=causal,
                               scale=scale, block_k=block_k)
