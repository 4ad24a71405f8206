"""Slot programs and the stage engine (port of ``repro/models/transformer.py``).

A model is a sequence of uniform slots: a dense layer, an MoE layer whose
MLP is ``models/moe.py``'s expert block, an RWKV6 layer (``rwkv_slot``), a
zamba2 group of Mamba2 mixers and the weight-shared attention block
(``zamba_group_slot``), the block's parameters handed to every slot as
``extras``, a llama-3.2-vision group of self layers and a gated
cross-attention layer (``vlm_group_slot``) or a whisper decoder layer
(``whisper_dec_slot``); whisper's encoder layers (``encoder_layer``) run
once a pass, before the chunks.  Each slot returns its MoE balance loss
beside its output (0.0 but for an MoE slot, the block's aux times the
gate), and the stack sums them (the reference's ``aux`` scan output).  A
slot's state is its KV cache ("kv", a VLM group's list under "self"), its
mixers' recurrent state, or both, and a cross-attention slot's context
K/V ("xkv").  The
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
  the saved rows take their place (an MoE slot's tagged hidden is its
  experts' [E_loc, Ce, ff], split along its capacity rows; the replay
  routes the same rows again, so it reaches the same experts);
- "full": the same seam with nothing saved but the chunk's input and K/V:
  the backward recomputes everything.

The seam is one ``torch.autograd.Function`` a chunk, the counterpart of the
reference's ``jax.checkpoint`` / ``prefetch_chunk`` ``custom_vjp``.  It
takes the earlier chunks' K/V and the recurrent state as the chunk found
it as inputs, and returns the chunk's K/V and the state it leaves as
outputs, so that later chunks send their gradients back through both; its
replay starts from that incoming state.  The shared block's leaves are
inputs too, and their gradients, like the stage parameters', sum over the
groups and the chunks in the ``GradSink``.  A cross-attention slot's
context K/V ("xkv", made once a pass from the slot's ``xattn`` leaves and
the context) is a seam input too, never a tagged row: each seam's
backward returns its gradient, autograd sums it over the chunks and
carries it once into the K/V projections (and whisper's encoder), and the
replay reads the same K/V.

At sp > 1 (``ChunkMeta.ctx``) a stage's parameters are this model rank's
shards: each slot's "ag" leaves are all-gathered at use
(``gather_params``, reference ``transformer.py:265-274``), in the seam's
forward and again in its replay, so the replay recomputes the same values
and the gathers' backward reduce-scatters the weight gradients; x, the
tagged rows and the cache are the rank's sequence shard.
"""
from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core import offload as ofl
from repro_torch.core import tree
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.moe import moe_block
from repro_torch.parallel.ctx import SINGLE


class ChunkMeta(NamedTuple):
    q_pos: Any           # [T] int32 global positions of the chunk (decode: [1];
                         # paged decode: [B, 1], a position a request)
    # cache slot of the chunk's first token (decode: the striped write slot,
    # None on the model ranks that do not own the token)
    cache_off: Optional[int]
    kv_view: Optional[int]  # visible cache length after the append (decode: None = all)
    rope: Any            # layers.rope_tables(q_pos, ...): shared by every layer
    tag: Any = None      # the tag sites' function (core/offload.py), None: no tags
    # packed variable-length batches (DESIGN.md §13): [B, T] int32 start of
    # each query's document; attention masks kv_pos < q_start.  None: unpacked
    q_start: Any = None
    # the model axis (parallel/ctx.py::Ctx; None: one device) and the slot's
    # shard markers (model_zoo.slot_spec), for the gathers at sp > 1
    ctx: Any = None
    spec: Any = None
    # decode (DESIGN.md §16): one token a row, replicated over the model
    # ranks (``attention.gqa_decode_attention``); with ``paged`` (an
    # ``attention.PagedMeta``) against the paged pool the slot's state
    # holds (``attention.gqa_paged_decode_attention``)
    decode: bool = False
    paged: Any = None


def _res(x, delta, gate):
    """Gated residual add — ghost slots (gate = 0) become identity.  The
    gate is a structural constant (pipeline padding), not trainable: no
    gradient reaches it.  It is 0 or 1, so the fused x + gate * delta rounds
    as x + delta does."""
    return torch.addcmul(x, gate.detach().to(x.dtype), delta)


def gather_params(p_slot, spec, ctx):
    """All-gather the "ag" leaves (int marker: the gather dim) of one slot
    over the model axis; "rep" / "keepN" leaves pass through.  Under
    ``ctx.grad_compress`` the gathers' backward (the weight gradients'
    reduce-scatter) runs in bf16."""
    if ctx is None or ctx.sp == 1:
        return p_slot
    return tree.map_(lambda t, m: ctx.all_gather_param(t, m) if isinstance(m, int) else t,
                     p_slot, spec)


def _attention(cfg, p, s, h, meta: ChunkMeta):
    """The slot's GQA or MLA attention of h (prefill / train chunk, decode
    or paged decode): (output, the slot's new cache)."""
    ctx = meta.ctx or SINGLE
    if cfg.mla is not None:
        if meta.paged is not None:
            raise ValueError("the paged pool holds no MLA latent (runner.check_pool_cell)")
        if meta.decode:
            return A.mla_decode_attention(h, p["attn"], cfg, s["kv"], meta.q_pos,
                                          meta.cache_off, meta.rope, ctx=ctx)
        return A.mla_attention(h, p["attn"], cfg, s["kv"], meta.q_pos, meta.cache_off,
                               meta.kv_view, meta.rope, name_tag=meta.tag,
                               q_start=meta.q_start, ctx=ctx)
    if meta.paged is not None:
        return A.gqa_paged_decode_attention(h, p["attn"], cfg, s["kv"], meta.paged,
                                            meta.rope, ctx=ctx)
    if meta.decode:
        return A.gqa_decode_attention(h, p["attn"], cfg, s["kv"], meta.q_pos,
                                      meta.cache_off, meta.rope, ctx=ctx)
    return A.gqa_self_attention(h, p["attn"], cfg, s["kv"], meta.q_pos,
                                meta.cache_off, meta.kv_view, meta.rope,
                                name_tag=meta.tag, q_start=meta.q_start, ctx=ctx)


def dense_slot(cfg, p, s, x, meta: ChunkMeta, extras=None):
    """A dense layer: (x, state, aux = 0.0)."""
    p = gather_params(p, meta.spec, meta.ctx)
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    a, kv = _attention(cfg, p, s, h, meta)
    x = _res(x, a, p["gate"])
    h2 = L.apply_norm(x, p["ln2"], cfg.norm)
    m = L.mlp(h2, p["mlp"], cfg.act, name_tag=meta.tag)
    x = _res(x, m, p["gate"])
    return x, {"kv": kv}, 0.0


def moe_slot(cfg, p, s, x, meta: ChunkMeta, extras=None):
    """An MoE layer (reference ``transformer.py:88-108``, GQA or MLA):
    attention, then the expert block on the rank's rows; (x, state, aux x
    gate)."""
    p = gather_params(p, meta.spec, meta.ctx)
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    a, kv = _attention(cfg, p, s, h, meta)
    x = _res(x, a, p["gate"])
    h2 = L.apply_norm(x, p["ln2"], cfg.norm)
    m, aux = moe_block(h2, p["moe"], cfg, meta.ctx or SINGLE, name_tag=meta.tag)
    x = _res(x, m, p["gate"])
    return x, {"kv": kv}, aux * p["gate"]


def zamba_group_slot(cfg, p, s, x, meta: ChunkMeta, extras=None):
    """A zamba2 group (reference ``transformer.py:153-181``): the slot's
    ``shared_attn_every`` Mamba2 mixers, each under its own gate, then the
    shared attention block (``extras["shared"]``) under ``gate_shared``,
    attending the slot's own cache."""
    mctx = meta.ctx or SINGLE
    states = []
    for i, st in enumerate(s["mamba"]):
        pi = tree.map_(lambda a: a[i], p["mamba"])
        h = L.apply_norm(x, pi["ln"], cfg.norm)
        y, st = S.mamba2_mixer(h, pi["mix"], cfg, st, name_tag=meta.tag,
                               pre_gathered=meta.decode, ctx=mctx)
        x = _res(x, y, pi["gate"])
        states.append(st)
    shared = extras["shared"]
    h = L.apply_norm(x, shared["ln1"], cfg.norm)
    a, kv = _attention(cfg, shared, s, h, meta)
    x = _res(x, a, p["gate_shared"])
    h2 = L.apply_norm(x, shared["ln2"], cfg.norm)
    m = L.mlp(h2, shared["mlp"], cfg.act, name_tag=meta.tag)
    x = _res(x, m, p["gate_shared"])
    return x, {"kv": kv, "mamba": states}, 0.0


def rwkv_slot(cfg, p, s, x, meta: ChunkMeta, extras=None):
    """An RWKV6 layer (reference ``transformer.py:189-199``): the time-mix
    and the channel-mix, each after its LayerNorm, threading one state."""
    mctx = meta.ctx or SINGLE
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    y, st = S.rwkv6_time_mix(h, p["tmix"], cfg, s["rwkv"], name_tag=meta.tag,
                             pre_gathered=meta.decode, ctx=mctx)
    x = _res(x, y, p["gate"])
    h2 = L.apply_norm(x, p["ln2"], cfg.norm)
    y2, st = S.rwkv6_channel_mix(h2, p["cmix"], cfg, st, name_tag=meta.tag,
                                 pre_gathered=meta.decode, ctx=mctx)
    x = _res(x, y2, p["gate"])
    return x, {"rwkv": st}, 0.0


def _gated(gate, delta):
    """A cross sub-layer's output under its learned gate: tanh in fp32,
    cast to the activation dtype, then the product (reference
    ``transformer.py:139, 142``)."""
    return torch.tanh(gate).to(delta.dtype) * delta


def vlm_group_slot(cfg, p, s, x, meta: ChunkMeta, extras=None):
    """A llama-3.2-vision group (reference ``transformer.py:116-144``):
    ``cross_attn.every`` self-attention layers, their leaves stacked [every,
    ...] under "self" and their caches a list under "self", then the
    cross-attention layer over the context's K/V ("xkv") and its MLP, each
    under its tanh gate (``xgate_attn``, ``xgate_mlp``) and the slot's."""
    mctx = meta.ctx or SINGLE
    kvs = []
    for i, cache in enumerate(s["self"]):
        pi = tree.map_(lambda a: a[i], p["self"])
        h = L.apply_norm(x, pi["ln1"], cfg.norm)
        a, kv = _attention(cfg, pi, {"kv": cache}, h, meta)
        x = _res(x, a, pi["gate"])
        h2 = L.apply_norm(x, pi["ln2"], cfg.norm)
        m = L.mlp(h2, pi["mlp"], cfg.act, name_tag=meta.tag)
        x = _res(x, m, pi["gate"])
        kvs.append(kv)
    h = L.apply_norm(x, p["xln1"], cfg.norm)
    a = A.cross_attention(h, p["xattn"], cfg, s["xkv"], name_tag=meta.tag, ctx=mctx)
    x = _res(x, _gated(p["xgate_attn"], a), p["gate"])
    h2 = L.apply_norm(x, p["xln2"], cfg.norm)
    m = L.mlp(h2, p["xmlp"], cfg.act, name_tag=meta.tag)
    x = _res(x, _gated(p["xgate_mlp"], m), p["gate"])
    return x, {"self": kvs, "xkv": s["xkv"]}, 0.0


def whisper_dec_slot(cfg, p, s, x, meta: ChunkMeta, extras=None):
    """A whisper decoder layer (reference ``transformer.py:207-225``):
    causal self-attention on the slot's cache, cross-attention over the
    encoder output's K/V ("xkv"), the MLP."""
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    a, kv = _attention(cfg, p, s, h, meta)
    x = _res(x, a, p["gate"])
    hx = L.apply_norm(x, p["xln"], cfg.norm)
    a2 = A.cross_attention(hx, p["xattn"], cfg, s["xkv"], name_tag=meta.tag,
                           ctx=meta.ctx or SINGLE)
    x = _res(x, a2, p["gate"])
    h2 = L.apply_norm(x, p["ln2"], cfg.norm)
    m = L.mlp(h2, p["mlp"], cfg.act, name_tag=meta.tag)
    x = _res(x, m, p["gate"])
    return x, {"kv": kv, "xkv": s["xkv"]}, 0.0


def encoder_layer(cfg, p, x, n_valid: int, ctx=SINGLE):
    """A whisper encoder layer (reference ``transformer.py:228-248``) over
    the frames [B, F, d]: bidirectional attention (causal=False), each frame
    at its index as position and PAD past ``n_valid``, then the MLP; plain
    residuals, no gate, no tag (the encoder runs once a pass, outside the
    chunks)."""
    A._check_cross_ctx(ctx)
    B, F, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    q, k, v = A._qkv(h, p["attn"], cfg, None)
    idx = torch.arange(F, dtype=torch.int32, device=x.device)
    pos = torch.where(idx < n_valid, idx, A.PAD).to(torch.int32)
    out = A.dist_attention(q, k, v, pos, pos, ctx, causal=False)
    x = x + out.reshape(B, F, H * hd) @ p["attn"]["wo"]
    h2 = L.apply_norm(x, p["ln2"], cfg.norm)
    return x + L.mlp(h2, p["mlp"], cfg.act)


SLOT_FNS = {"dense": dense_slot, "moe": moe_slot, "vlm": vlm_group_slot,
            "hybrid": zamba_group_slot, "ssm": rwkv_slot, "audio": whisper_dec_slot}


def _slots(cfg, stage_params, state, x, meta: ChunkMeta, extras=None):
    """Every slot of the stack in turn, the caches updated in place and
    each slot's recurrent state replaced by the one it leaves; returns (x,
    the slots' summed aux)."""
    slot, aux = SLOT_FNS[cfg.family], 0.0
    for i, (p, s) in enumerate(zip(stage_params, state)):
        x, state[i], a = slot(cfg, p, s, x, meta, extras)
        aux = aux + a
    return x, aux


# the keys of a slot's state that are not recurrent: its caches ("kv", a
# VLM group's "self" list) and the cross-attention K/V ("xkv")
_NOT_RECURRENT = ("kv", "self", "xkv")


def _caches(s) -> list:
    """A slot state's KV caches in a fixed order: its "kv", or a VLM group's
    self-attention caches."""
    return [s["kv"]] if "kv" in s else list(s.get("self", ()))


def _recurrent(s) -> list:
    """A slot state's recurrent tensors, in a fixed order (none for a
    KV-only slot)."""
    return [t for k, v in s.items() if k not in _NOT_RECURRENT for t in tree.leaves(v)]


def _cross(s) -> list:
    """A slot state's cross-attention k and v (none without "xkv")."""
    return [s["xkv"]["k"], s["xkv"]["v"]] if "xkv" in s else []


def _set_cross(state, tensors) -> None:
    """Put ``tensors`` (``_cross``'s of every slot, in slot order) in place
    of the slots' cross-attention k and v."""
    it = iter(tensors)
    for i, s in enumerate(state):
        if "xkv" in s:
            state[i] = {**s, "xkv": {**s["xkv"], "k": next(it), "v": next(it)}}


def _refill(like, it):
    """``like`` (a slot state's recurrent part: dicts, lists, NamedTuples)
    with its tensors taken from ``it`` in ``_recurrent``'s order."""
    if isinstance(like, dict):
        return {k: _refill(v, it) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_refill(v, it) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_refill(v, it) for v in like)
    return next(it)


def _set_recurrent(state, tensors) -> None:
    """Put ``tensors`` (``_recurrent``'s of every slot, in slot order) in
    place of the slots' recurrent state."""
    it = iter(tensors)
    for i, s in enumerate(state):
        state[i] = {k: (v if k in _NOT_RECURRENT else _refill(v, it)) for k, v in s.items()}


REMATS = ("none", "sppo", "full")


class GradSink:
    """Where the chunk seams put the stage parameters' gradients of one
    differentiated call (``runner.loss_and_grads``, ``collect_param_grads``).

    Without a sink a seam's backward hands autograd the whole stage's
    parameter gradients at once, and autograd adds them to the sums of the
    chunks before: a layer's gradients held twice beside its weights
    (deepseek-v3's expert stacks are 22.5 GB a layer, so a 1-layer step
    would need 67.5 GB for them alone).  With one, the replay's gradients
    are added op by op, in place, into one buffer a parameter (autograd's
    in-place accumulation), in the order autograd would add them, and the
    seam returns none for the parameters."""

    def __init__(self):
        self.grads = {}   # id(parameter tensor) -> its gradient summed so far

    def take(self, param):
        """``param``'s summed gradient (None if no seam reached it)."""
        return self.grads.get(id(param))


_SINK: Optional[GradSink] = None


@contextlib.contextmanager
def collect_param_grads(sink: GradSink):
    """Seams built inside the block (their forwards) put their parameters'
    gradients into ``sink`` when their backwards run."""
    global _SINK
    prev, _SINK = _SINK, sink
    try:
        yield sink
    finally:
        _SINK = prev


def stage_apply(cfg, stage_params, state, x, meta: ChunkMeta, *,
                remat: str = "none", offload: Optional[ofl.ChunkOffload] = None,
                extras=None):
    """Run a stack of slots on one chunk.  ``stage_params`` and ``state`` are
    lists with one entry per slot; the caches are updated in place and the
    recurrent states replaced.  ``extras``: what every slot reads beside
    its own parameters (the hybrid family's shared block).  Returns (x,
    state, aux): aux the slots' summed MoE balance loss, 0.0 but for an MoE
    stack.

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
        x, aux = _slots(cfg, stage_params, state, x, meta, extras)
        return x, state, aux
    extras = {} if extras is None else extras
    caches = [c for s in state for c in _caches(s)]
    if any(c.chunks is None for c in caches):
        raise ValueError("the chunk seam needs training caches (init_state(train=True))")
    # the seam's inputs are the chunks before this one (a re-run chunk
    # replaces its own entry)
    for c in caches:
        A.truncate_chunks(c, meta.cache_off)
    if offload is None:
        offload = ofl.ChunkOffload(chunk=len(caches[0].chunks) if caches else 0, alpha=0.0)
    run = _SeamRun(cfg, stage_params, state, meta, remat, offload, _SINK, extras)
    params = tree.leaves(stage_params) + tree.leaves(extras)
    prev = [t for c in caches for kv in c.chunks for t in kv]
    rec = [t for s in state for t in _recurrent(s)]
    cross = [t for s in state for t in _cross(s)]
    y, *outs = _StageSeam.apply(run, x, *params, *prev, *rec, *cross)
    # an MoE stack's aux is the seam's last output
    aux = outs.pop() if cfg.family == "moe" else 0.0
    # the chunk's own K/V and the state it leaves, as the seam's outputs:
    # later chunks send their gradients back through them
    kvs, rec_out = outs[:2 * len(caches)], outs[2 * len(caches):]
    for c, k, v in zip(caches, kvs[0::2], kvs[1::2]):
        c.chunks[-1] = (k, v)
    _set_recurrent(state, rec_out)
    return y, state, aux


def stage_apply_capture(cfg, stage_params, state, x, meta: ChunkMeta,
                        alpha: float, send, extras=None):
    """The sppo seam's forward (no graph): the stack with the capture tag.
    After each slot, its off rows go to ``send`` (a D2H each) and its keep
    rows are kept, copied down to their own elements.  Returns (x, keep
    rows in traversal order, aux)."""
    keep, aux, slot = [], 0.0, SLOT_FNS[cfg.family]
    for i, (p, s) in enumerate(zip(stage_params, state)):
        collector = []
        meta_c = meta._replace(tag=ofl.CaptureTag(alpha, collector))
        x, state[i], a = slot(cfg, p, s, x, meta_c, extras)
        aux = aux + a
        for kind, t in collector:
            if kind == "off":
                send(t)
            else:
                keep.append(ofl.compact(t))
    return x, keep, aux


def stage_apply_inject(cfg, stage_params, state, x, meta: ChunkMeta,
                       alpha: float, off_acts, keep_acts, extras=None):
    """The sppo seam's backward replay: the stack with the inject tag, which
    hands out the reloaded off rows and the kept rows in traversal order in
    place of the tagged tensors.  Returns (x, aux)."""
    meta_i = meta._replace(tag=ofl.InjectTag(alpha, off_acts, keep_acts))
    return _slots(cfg, stage_params, state, x, meta_i, extras)


class _SeamRun(NamedTuple):
    """What a chunk's seam needs besides its tensors."""

    cfg: Any
    structure: Any        # the stage parameter tree (its shape; leaves unused)
    state: list
    meta: ChunkMeta
    remat: str
    offload: ofl.ChunkOffload
    sink: Optional[GradSink] = None   # where the parameters' gradients go (None: returned)
    extras: Any = None    # the shared block's tree (its shape; leaves unused), or {}


class _StageSeam(torch.autograd.Function):
    """One chunk's pass through the stack, checkpointed at the chunk.

    ``apply(run, x, *params, *prev, *rec, *cross)``: ``params`` are the
    stage's parameter leaves and the shared block's (``run.extras``),
    ``prev`` the K/V of every earlier chunk, layer by layer (the seam
    outputs of those chunks), ``rec`` the slots' recurrent state as the
    chunk finds it (the previous seam's outputs; zeros at the first chunk),
    ``cross`` the slots' context K/V (the same for every chunk; its
    gradients are returned, never kept as rows).  Returns (y, k_0,
    v_0, ..., k_L, v_L, *rec'), and for an MoE stack its summed aux last:
    the chunk's output, its own K/V of every layer that attends, and the
    recurrent state it leaves.

    Forward: the stack without a graph, writing the chunk's K/V into the
    caches.  Under "sppo" the capture tag keeps each tagged tensor's keep
    rows and sends its off rows to host through the offload's link
    (``ChunkOffload.send``: quantized under a codec, the scales kept on the
    device); under "full" nothing is kept.  Backward: ``Link.begin``, the
    previous seam's reload issued ahead (the link decides; the link is keyed
    by ``ChunkOffload.key``, the chunk at pp = 1 and the rank's event at pp
    > 1, whose seams run in event order), this seam's rows taken (``ChunkOffload.restore``: dequantized under a codec), then
    the stack replayed with gradients on the staged rows (under "sppo" the
    replay writes the chunk's cache slots again with the staged K/V,
    bitwise the same, and no slot past ``kv_view``), and differentiated with respect to x, the
    parameters, the earlier chunks' K/V and the incoming recurrent state:
    the replay starts from the saved incoming state, not from the state the
    forward left.  The replay re-runs the attention forward, whose (m, l)
    are not saved, as the reference's does.
    """

    @staticmethod
    def forward(ctx, run: _SeamRun, x, *inputs):
        ctx.set_materialize_grads(False)
        n_rec = sum(len(_recurrent(s)) for s in run.state)
        n_cross = sum(len(_cross(s)) for s in run.state)
        n_prev = sum(2 * len(c.chunks) for s in run.state for c in _caches(s))
        n_params = len(inputs) - n_prev - n_rec - n_cross
        stage_p, extras = _rebuild_params(run, inputs[:n_params])
        off = run.offload
        if run.remat == "sppo":
            if off.link is None and ofl.split_rows(x.shape[1], off.alpha) > 0:
                raise ValueError("a chunk that offloads rows needs a link to send them")
            y, keep, aux = stage_apply_capture(
                run.cfg, stage_p, run.state, x, run.meta, off.alpha, off.send, extras)
        else:
            keep = []
            y, aux = _slots(run.cfg, stage_p, run.state, x, run.meta, extras)
        ctx.save_for_backward(x, *inputs)
        ctx.run, ctx.keep, ctx.n_params, ctx.n_rec = run, keep, n_params, n_rec
        ctx.n_cross = n_cross
        kvs = [t.clone() for s in run.state for c in _caches(s) for t in c.chunks[-1]]
        ins = {id(t) for t in inputs}
        rec = [t.clone() if id(t) in ins else t for s in run.state for t in _recurrent(s)]
        outs = (y, *kvs, *rec)
        return (*outs, aux) if run.cfg.family == "moe" else outs

    @staticmethod
    def backward(ctx, dy, *dkvs):
        run, keep = ctx.run, ctx.keep
        ctx.keep = None
        off = run.offload
        staged = []
        if off.link is not None:
            off.link.begin(off.key)
            if off.link.ahead and off.key > 0:
                off.link.prefetch(off.key - 1)
            staged = off.restore(off.link.take(off.key))
        x, *inputs = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(t.requires_grad) for t in (x, *inputs)]
            xl, ins = leaves[0], leaves[1:]
            stage_p, extras = _rebuild_params(run, ins[:ctx.n_params])
            # each attending layer's chunk list: the earlier chunks' K/V as
            # leaves (the replay appends this chunk's); the recurrent state
            # as the chunk found it; the cross-attention K/V as leaves
            n_rec, n_cross = ctx.n_rec, ctx.n_cross
            end = len(ins) - n_cross
            prev = iter(ins[ctx.n_params:end - n_rec])
            caches = [c for s in run.state for c in _caches(s)]
            n_prev = (end - ctx.n_params - n_rec) // max(1, 2 * len(caches))
            for c in caches:
                c.chunks[:] = [(next(prev), next(prev)) for _ in range(n_prev)]
            _set_recurrent(run.state, ins[end - n_rec:end])
            _set_cross(run.state, ins[end:])
            if run.remat == "sppo":
                y, aux = stage_apply_inject(run.cfg, stage_p, run.state, xl, run.meta,
                                            off.alpha, staged, keep, extras)
            else:
                y, aux = _slots(run.cfg, stage_p, run.state, xl, run.meta, extras)
            del staged, keep
            kvs = [t for c in caches for t in c.chunks[-1]]
            kvs += [t for s in run.state for t in _recurrent(s)]
            if run.cfg.family == "moe":
                kvs.append(aux)
            outs = [(o, g) for o, g in zip((y, *kvs), (dy, *dkvs))
                    if g is not None and o.requires_grad]
            wrt = [t for t in leaves if t.requires_grad]
            if run.sink is None:
                grads = iter(torch.autograd.grad([o for o, _ in outs], wrt,
                                                 [g for _, g in outs], allow_unused=True))
                return (None, *(next(grads) if t.requires_grad else None for t in leaves))
        # into the sink: each parameter leaf starts from its sum so far, and
        # autograd (outside grad mode) adds each op's gradient to it in place
        n = ctx.n_params
        params = tree.leaves(run.structure) + tree.leaves(run.extras)
        p_leaves = leaves[1:1 + n]
        for p, leaf in zip(params, p_leaves):
            if leaf.requires_grad:
                leaf.grad = run.sink.take(p)
        torch.autograd.backward([o for o, _ in outs], [g for _, g in outs], inputs=wrt)
        for p, leaf in zip(params, p_leaves):
            if leaf.grad is not None:
                run.sink.grads[id(p)] = leaf.grad
        return (None, *(t.grad if t.requires_grad and not 1 <= i <= n else None
                        for i, t in enumerate(leaves)))


def _rebuild(structure, leaves):
    it = iter(leaves)
    return tree.map_(lambda _: next(it), structure)


def _rebuild_params(run: _SeamRun, leaves):
    """(stage parameters, extras) from the seam's parameter inputs."""
    n = len(tree.leaves(run.structure))
    return _rebuild(run.structure, leaves[:n]), _rebuild(run.extras, leaves[n:])
