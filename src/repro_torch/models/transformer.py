"""Dense slot program and the stage engine (port of ``repro/models/transformer.py``).

A model is a sequence of uniform slots (one dense layer each here).  The
reference scans the slots under SPPO's checkpoint policy
(``core/offload.py::checkpoint_block``); the port runs them as a loop under
one of three remat policies (DESIGN.md §10, §12):

- "none": autograd keeps every residual;
- "sppo": SPPO's named-save policy.  The chunk's stack runs once without a
  graph, keeping only its input, its K/V and the tagged Type-1 rows (q, k,
  v after RoPE, the attention output, the MLP hidden); where the chunk
  offloads, the first ``split_rows(rows, α)`` rows of each go to pinned host
  memory (``stage_apply_capture``).  The chunk's backward replays the stack
  with the saved rows in place of the tagged tensors (``stage_apply_inject``)
  and differentiates the replay: q, k and v are not recomputed; the
  attention output and the MLP hidden are, since their producers' backward
  needs the attention's (o, l) and the MLP's gate and up projections, and
  the saved rows take their place;
- "full": the same seam with nothing saved but the chunk's input and K/V:
  the backward recomputes everything.

The seam is one ``torch.autograd.Function`` a chunk, the counterpart of the
reference's ``jax.checkpoint`` / ``prefetch_chunk`` ``custom_vjp``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import offload as ofl
from repro_torch.core import tree
from repro_torch.models import attention as A
from repro_torch.models import layers as L


class ChunkMeta(NamedTuple):
    q_pos: Any           # [T] int32 global positions of the chunk (decode: [1])
    cache_off: int       # cache slot of the chunk's first token
    kv_view: Optional[int]  # visible cache length after the append (decode: None = all)
    rope: Any            # layers.rope_tables(q_pos, ...): shared by every layer
    tag: Any = None      # the tag sites' function (core/offload.py), None: no tags
    # packed variable-length batches (DESIGN.md §13): [B, T] int32 start of
    # each query's document; attention masks kv_pos < q_start.  None: unpacked
    q_start: Any = None


def _res(x, delta, gate):
    """Gated residual add — ghost slots (gate = 0) become identity.  The
    gate is a structural constant (pipeline padding), not trainable: no
    gradient reaches it.  It is 0 or 1, so the fused x + gate * delta rounds
    as x + delta does."""
    return torch.addcmul(x, gate.detach().to(x.dtype), delta)


def dense_slot(cfg, p, s, x, meta: ChunkMeta):
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    a, kv = A.gqa_self_attention(h, p["attn"], cfg, s["kv"], meta.q_pos,
                                 meta.cache_off, meta.kv_view, meta.rope,
                                 name_tag=meta.tag, q_start=meta.q_start)
    x = _res(x, a, p["gate"])
    h2 = L.apply_norm(x, p["ln2"], cfg.norm)
    m = L.mlp(h2, p["mlp"], cfg.act, name_tag=meta.tag)
    x = _res(x, m, p["gate"])
    return x, {"kv": kv}


REMATS = ("none", "sppo", "full")


def stage_apply(cfg, stage_params, state, x, meta: ChunkMeta, *,
                remat: str = "none", offload: Optional[ofl.ChunkOffload] = None):
    """Run a stack of slots on one chunk.  ``stage_params`` and ``state`` are
    lists with one entry per slot; the caches are updated in place.
    Returns (x, state).

    Under remat "sppo" or "full", where a gradient is wanted, the stack runs
    through the chunk seam (``_StageSeam``); ``offload`` says how the sppo
    seam splits its tagged rows and where the off rows go (None: every row
    stays on the device).  Without a gradient there is nothing to save and
    every policy runs the plain loop."""
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}: expected one of {REMATS}")
    if offload is not None and remat != "sppo":
        raise ValueError(f"offload needs remat 'sppo' (got {remat!r}): it moves the "
                         "tagged rows that policy saves")
    if remat == "none" or not torch.is_grad_enabled():
        for i, (p, s) in enumerate(zip(stage_params, state)):
            x, state[i] = dense_slot(cfg, p, s, x, meta)
        return x, state
    if any(s["kv"].chunks is None for s in state):
        raise ValueError("the chunk seam needs training caches (init_state(train=True))")
    if offload is None:
        offload = ofl.ChunkOffload(chunk=len(state[0]["kv"].chunks), alpha=0.0)
    run = _SeamRun(cfg, stage_params, state, meta, remat, offload)
    params = tree.leaves(stage_params)
    prev = [t for s in state for kv in s["kv"].chunks for t in kv]
    y, *kvs = _StageSeam.apply(run, x, *params, *prev)
    # the chunk's own K/V, as the seam's outputs: later chunks' attention
    # sends their gradients back through them
    for s, k, v in zip(state, kvs[0::2], kvs[1::2]):
        s["kv"].chunks[-1] = (k, v)
    return y, state


def stage_apply_capture(cfg, stage_params, state, x, meta: ChunkMeta,
                        alpha: float, send):
    """The sppo seam's forward (no graph): the stack with the capture tag.
    After each slot, its off rows go to ``send`` (a D2H each) and its keep
    rows are kept, copied down to their own elements.  Returns (x, keep
    rows in traversal order)."""
    keep = []
    for i, (p, s) in enumerate(zip(stage_params, state)):
        collector = []
        meta_c = meta._replace(tag=ofl.CaptureTag(alpha, collector))
        x, state[i] = dense_slot(cfg, p, s, x, meta_c)
        for kind, t in collector:
            if kind == "off":
                send(t)
            else:
                keep.append(ofl.compact(t))
    return x, keep


def stage_apply_inject(cfg, stage_params, state, x, meta: ChunkMeta,
                       alpha: float, off_acts, keep_acts):
    """The sppo seam's backward replay: the stack with the inject tag, which
    hands out the reloaded off rows and the kept rows in traversal order in
    place of the tagged tensors.  Returns x."""
    meta_i = meta._replace(tag=ofl.InjectTag(alpha, off_acts, keep_acts))
    for i, (p, s) in enumerate(zip(stage_params, state)):
        x, state[i] = dense_slot(cfg, p, s, x, meta_i)
    return x


class _SeamRun(NamedTuple):
    """What a chunk's seam needs besides its tensors."""

    cfg: Any
    structure: Any        # the stage parameter tree (its shape; leaves unused)
    state: list
    meta: ChunkMeta
    remat: str
    offload: ofl.ChunkOffload


class _StageSeam(torch.autograd.Function):
    """One chunk's pass through the stack, checkpointed at the chunk.

    ``apply(run, x, *params, *prev)``: ``params`` are the stage's parameter
    leaves, ``prev`` the K/V of every earlier chunk, layer by layer (the
    seam outputs of those chunks).  Returns (y, k_0, v_0, ..., k_L, v_L):
    the chunk's output and its own K/V of every layer.

    Forward: the stack without a graph, writing the chunk's K/V into the
    caches.  Under "sppo" the capture tag keeps each tagged tensor's keep
    rows and sends its off rows to host through the offload's link
    (``ChunkOffload.send``: quantized under a codec, the scales kept on the
    device); under "full" nothing is kept.  Backward: ``Link.begin``, the
    previous chunk's reload issued ahead (the link decides), this chunk's
    rows taken (``ChunkOffload.restore``: dequantized under a codec), then
    the stack replayed with gradients on the staged rows (under "sppo" the
    replay writes the chunk's cache slots again with the staged K/V,
    bitwise the same, and no slot past ``kv_view``), and differentiated with respect to x, the
    parameters and the earlier chunks' K/V.  The replay re-runs the
    attention forward, whose (m, l) are not saved, as the reference's does.
    """

    @staticmethod
    def forward(ctx, run: _SeamRun, x, *inputs):
        ctx.set_materialize_grads(False)
        n_params = len(inputs) - sum(2 * len(s["kv"].chunks) for s in run.state)
        stage_p = _rebuild(run.structure, inputs[:n_params])
        off = run.offload
        if run.remat == "sppo":
            if off.link is None and ofl.split_rows(x.shape[1], off.alpha) > 0:
                raise ValueError("a chunk that offloads rows needs a link to send them")
            y, keep = stage_apply_capture(
                run.cfg, stage_p, run.state, x, run.meta, off.alpha, off.send)
        else:
            y, keep = x, []
            for i, (p, s) in enumerate(zip(stage_p, run.state)):
                y, run.state[i] = dense_slot(run.cfg, p, s, y, run.meta)
        ctx.save_for_backward(x, *inputs)
        ctx.run, ctx.keep, ctx.n_params = run, keep, n_params
        kvs = [t.clone() for s in run.state for t in s["kv"].chunks[-1]]
        return (y, *kvs)

    @staticmethod
    def backward(ctx, dy, *dkvs):
        run, keep = ctx.run, ctx.keep
        ctx.keep = None
        off = run.offload
        staged = []
        if off.link is not None:
            off.link.begin(off.chunk)
            if off.link.ahead and off.chunk > 0:
                off.link.prefetch(off.chunk - 1)
            staged = off.restore(off.link.take(off.chunk))
        x, *inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.requires_grad) for t in (x, *inputs)]
            xl, ins = leaves[0], leaves[1:]
            stage_p = _rebuild(run.structure, ins[:ctx.n_params])
            # each layer's chunk list: the earlier chunks' K/V as leaves (the
            # replay appends this chunk's)
            prev = iter(ins[ctx.n_params:])
            n_prev = (len(ins) - ctx.n_params) // (2 * len(run.state))
            for s in run.state:
                s["kv"].chunks[:] = [(next(prev), next(prev)) for _ in range(n_prev)]
            if run.remat == "sppo":
                y = stage_apply_inject(run.cfg, stage_p, run.state, xl, run.meta,
                                       off.alpha, staged, keep)
            else:
                y = xl
                for i, (p, s) in enumerate(zip(stage_p, run.state)):
                    y, run.state[i] = dense_slot(run.cfg, p, s, y, run.meta)
            del staged, keep
            kvs = [t for s in run.state for t in s["kv"].chunks[-1]]
            outs = [(o, g) for o, g in zip((y, *kvs), (dy, *dkvs)) if g is not None]
            wrt = [t for t in leaves if t.requires_grad]
            grads = iter(torch.autograd.grad([o for o, _ in outs], wrt,
                                             [g for _, g in outs], allow_unused=True))
        return (None, *(next(grads) if t.requires_grad else None for t in leaves))


def _rebuild(structure, leaves):
    it = iter(leaves)
    return tree.map_(lambda _: next(it), structure)
