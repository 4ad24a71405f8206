"""Dispatch for the attention kernel (port of ``repro/kernels/ops.py``).

The tensor's device decides, and nothing else: a CUDA tensor goes to the
Hopper kernel (which raises on anything it does not take), a CPU tensor to
the plain version.  There is no switch that could send CUDA tensors to the
plain path.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref


def attention_partial(q, k, v, q_pos, kv_pos, *, causal=True, scale=None,
                      block_k=512, q_start=None):
    """Partial flash attention against a local KV shard (see kernels/ref.py):
    returns the un-normalized (o, m, l).  ``block_k`` is the plain version's
    KV block; the kernel tiles on its own."""
    if q.device.type == "cuda":
        return _fa.flash_attention_partial(q, k, v, q_pos, kv_pos,
                                           causal=causal, scale=scale,
                                           q_start=q_start)
    if q.device.type == "cpu":
        return _ref.attention_partial_ref(q, k, v, q_pos, kv_pos,
                                          causal=causal, scale=scale,
                                          block_k=block_k, q_start=q_start)
    raise ValueError(f"attention_partial runs on cuda or cpu, not {q.device}")
