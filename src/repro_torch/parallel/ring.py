"""Ring-distributed chunked attention (port of ``repro/parallel/ring.py``;
DESIGN.md §15, FPDT arxiv 2408.16978).

The gather modes of ``models/attention.py`` move either the queries or the
whole visible KV through one collective, so some rank always holds the
chunk's full KV extent.  The ring never gathers: each model rank keeps its
sequence shard of (k, v, kv_pos) and the shards rotate around the model
group (``Ctx.ppermute_model`` along ``ring_perm``), one hop per step.  At
hop h rank r holds the block that started on rank (r - h) mod sp; the
resident block takes one ``ops.attention_partial`` call, whose (o, m, l) is
stored at that canonical source index, not in arrival order.  After the
last hop the blocks are folded once, in source order, through
``kernels/ref.py::merge_partials`` (the max statistics gradient-frozen, as
its contract says), and normalized.

Why fold from source-indexed slots: float addition is not associative, so
a running fold would depend on the arrival order, which differs from rank
to rank.  The canonical fold makes the output the same bits on every rank
and under every arrival order (``fold_arrivals``, held by
tests/test_torch_ring.py).  A block wholly in a row's future comes out of
its hop with m = -1e30 and l = o = 0, and the fold weighs it by exp(-1e30 -
max) = 0 exactly; a row that every hop leaves dead (padding) folds to o = l
= 0 and normalizes to 0, as the reference's ``normalize`` leaves it.

The queries, their positions and their document windows (``q_start``) are
query-side and never move; ``kv_pos`` rotates with k and v.  No hop is
skipped: every block carries visible KV for some rank, and the kernels'
positional masking zeroes the invisible pairs (the causality discount
lives in the pricing, ``core/costmodel.py::ring_hop_fractions``).

Overlap: hop h + 1's exchange is posted before hop h's kernel call, as in
the reference (the double buffer ``core/simulate.py::ring_overlap``
prices).  Under NCCL (a card per rank) the posted exchange stays in flight
under the kernel and is waited on before the next hop reads it.  Under
gloo, whose transfers of CUDA tensors are staged through pinned host
memory by synchronous copies, it is done before the kernel is called: there
the ring cannot overlap, and a step measures correctness and bytes, not
speed.

Gradients: each hop's partial is ``FlashPartial`` (the Hopper backward
kernels on the card), the permutations' backward sends dk and dv back
along the inverse rotation, and autograd sums each block's contributions.
At sp = 1 the function is one partial and a normalize.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF, merge_partials, normalize


def ring_perm(sp: int) -> List[Tuple[int, int]]:
    """One-hop rotation of the model group: rank i sends to rank i + 1, so
    after h hops rank r holds the block that started on (r - h) mod sp."""
    return [(i, (i + 1) % sp) for i in range(sp)]


def _merge_buffers(slots):
    """Fold source-indexed (o, m, l) slots in canonical block order: the
    ring's one fold, whose graph (and result, bitwise) does not depend on
    the order the blocks arrived in."""
    return merge_partials(list(slots))


def fold_arrivals(parts: Sequence[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
                  sources: Sequence[int], n_blocks: int = None):
    """Fold per-block partials as the executed ring does.

    ``parts``: (o, m, l) triples in arrival order; ``sources[i]`` is the
    canonical block id of ``parts[i]`` (each id written once).  A slot no
    part fills holds an empty block (o = l = 0, m = -1e30).  Returns the
    merged (o, m, l) in fp32, the same bits for every arrival order."""
    n = n_blocks if n_blocks is not None else len(parts)
    o0, m0, _ = parts[0]
    slots = [(torch.zeros(o0.shape, dtype=torch.float32, device=o0.device),
              torch.full(m0.shape, NEG_INF, dtype=torch.float32, device=m0.device),
              torch.zeros(m0.shape, dtype=torch.float32, device=m0.device))] * n
    for (o, m, l), s in zip(parts, sources):
        slots[s] = (o.float(), m.float(), l.float())
    return _merge_buffers(slots)


def ring_attention(q, k_loc, v_loc, q_pos, kv_pos, ctx, *, causal=True, scale=None,
                   q_start=None):
    """Ring attention over ``ctx``'s model group.  q: [B, Tq, H, hd] this
    rank's queries with their positions ``q_pos`` and document windows
    ``q_start`` (they stay); k_loc, v_loc: [B, S_loc, Hkv, hd] and kv_pos
    [S_loc], this rank's KV shard (it rotates).  Returns the normalized
    output for this rank's queries, [B, Tq, H, hd_v] in q's dtype."""
    sp = ctx.sp
    if not ctx.distributed or sp == 1:
        o, _, l = kops.attention_partial(q, k_loc, v_loc, q_pos, kv_pos, causal=causal,
                                         scale=scale, q_start=q_start)
        return normalize(o, l).to(q.dtype)
    perm = ring_perm(sp)
    rank = ctx.model_index()
    slots = [None] * sp
    cur = (k_loc, v_loc, kv_pos)
    for h in range(sp):
        pending = []
        if h + 1 < sp:
            # the next hop's rotation first: it has no dependency on this
            # hop's kernel call, which it then runs under (NCCL)
            nxt = ctx.ppermute_model(cur, perm, pending=pending)
        k, v, pos = cur
        # the canonical slot of the resident block: its source rank
        slots[(rank - h) % sp] = kops.attention_partial(q, k, v, q_pos, pos, causal=causal,
                                                        scale=scale, q_start=q_start)
        if h + 1 < sp:
            ctx.wait(pending)
            cur = nxt
    o, _, l = _merge_buffers(slots)
    return normalize(o, l).to(q.dtype)
