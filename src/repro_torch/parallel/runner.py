"""The execution engine (port of ``repro/parallel/runner.py``).

Builds the step functions of a cell:

  train_step(params, opt_state, tokens, labels) -> (params, opt_state, metrics)
  prefill_step(params, tokens)                  -> (state, last_hidden)
  serve_step(params, state, tokens, pos)        -> (state, next_tokens)
  pool_step(params, pool, tokens, q_pos, btab, admit, admit_tok)
                                                -> (pool, next_tokens)

At pp = 1 training and prefill run the reference's pp == 1 pipeline branch:
the sequence is split into FLOPs-balanced chunks (core/partition.py); each
chunk is embedded, runs the layer stack (appending its K/V to the
position-tagged cache and attending a prefix view of it), and hands its
hidden state on; training adds each chunk's head loss, and autograd runs the
backward through the chunks in reverse.  Decode feeds one token per step and
attends the whole cache buffer.

Each rank is a process (``parallel/ctx.py``: ``pods`` times ``dp x pp``
data ranks, stage-major, times ``sp`` model ranks, model-minor).  At pp > 1 (DESIGN.md
§2, §4) a rank runs one pipeline stage of one dp group and the sequence is
cut into equal chunks fed as events (``pipeline_feed_events``: one per
chunk, or the MSP ramp's sub-events).  At
tick t, stage s runs event t - s: stage 0 embeds the fed chunk, the others
take the previous stage's hand-off, and the last stage adds the event's head
loss under its sub-chunk mask.  Each rank differentiates its own ticks; the
hand-offs carry the gradients back (``Ctx.handoff``).  The loss is the sum
of every rank's loss over the sum of their token counts, the stage
gradients are summed over the dp group, each global one (embedding, head)
is summed where it is used and sent to the other stages (``Ctx.psum_globals``),
and every rank then runs AdamW on what it holds.

At sp > 1 (the model axis, DESIGN.md §4) every chunk is sequence-sharded:
model rank r embeds the chunk's tokens into its rows ``[off + r * T / sp,
off + (r + 1) * T / sp)`` (a reduce-scatter, ``layers.embed_tokens``),
runs the stack on them with the slots' weights gathered at use and the
attention schedule of ``plan.attn_mode`` over its cache shard (slots ``[off
/ sp, (off + T) / sp)``), and takes the vocab-parallel loss of the whole
chunk.  Every model rank holds the same replicated loss and
differentiates it (``parallel/ctx.py``'s convention), so the gathers'
backward leaves each rank the gradient of its shard of every "ag" and
"keepN" leaf; the "rep" leaves' gradients are summed over the model group
(``Ctx.psum_model_grads``), then the data axis's reductions run at each
model index.  This is the gradient of the global loss: the reference's
``shard_map`` (``check_vma=False``) transposes its psums to psums, giving
sp x the gradient of every all-gathered leaf, and sums no replicated
leaf's over the model axis (PERF.md §6).

Serving (DESIGN.md §16) runs the same chunk loop without a loss to prefill
a cache (at sp > 1 each rank's chunk-contiguous shard), then decodes one
token a row a step: at sp > 1 the token is embedded and sampled whole on
every model rank (a masked lookup and a sum; the vocab shards' logits
gathered) and its K/V goes to one rank's striped slot; at pp > 1 the batch
runs as microbatches through the stages (``_decode_ticks``).  The paged
pool (``make_pool_state``, ``make_pool_ingest``, ``make_pool_serve_step``,
``runtime/kvpool.py``) serves requests of different lengths side by side
at pp = 1 (``launch/serve.py::ServeEngine``).

Training runs the plan's remat policy and SPPO's executed activation
offload (DESIGN.md §5, §10, §12): ``resolve_cell`` sizes each chunk's
offload ratio α (``core/offload.py::sequence_aware_alphas``), each chunk's
stack runs through the chunk seam of ``models/transformer.py``, its off rows
go to pinned host memory on a copy stream, and each seam's rows come back
one seam ahead of its backward (``prefetch="ahead"``, through a
``core/offload.py::Link`` and ``link_drain``) or at it (``"sync"``); under
``offload_dtype`` "fp8" / "int8" the rows cross quantized, their scales
kept on the device (DESIGN.md §14).  The update keeps AdamW's moments on
the device or, under ``offload_moments``, in pinned host memory, raw or
under ``moments_dtype`` (``optim/adamw.py``, DESIGN.md §11).

The recurrent families (rwkv6-3b, zamba2-7b; ``models/ssm.py``) keep each
slot's fp32 state in the same per-slot state list as the caches: the
chunk loop hands it from chunk to chunk (through the chunk seams, whose
replays start from the state each chunk found), prefill returns it and
each decode step advances it; they run at sp = pp = 1.

The cross-attention families (llama-3.2-vision-11b, whisper-tiny) take a
context of stub patch or frame embeddings beside the tokens: the chunk
loop encodes it (whisper) and projects each slot's K/V from it once,
before the chunks, differentiably where a gradient is wanted; prefill
leaves that K/V in the state and decode reads it.  They run at sp = pp =
1, and the paged engine refuses them, as the reference does.

The pod axis is pure data parallelism around the rest: the batch splits
over pods x dp groups (``data/pipeline.py::shard_batch``), the gradients
and the loss are also summed over the pods, and under ZeRO-1 (the plan's
``zero1``, set where pods > 1) each rank keeps its pod's slice of the
widened leaves' moments (``parallel/specs.py``), updates that slice, and
the pods gather the updated slices (``Ctx.all_gather_pod``): the
parameters are the same bits as with ``zero1=False``.  The ring attention
schedule (``attn_mode="ring"``, ``parallel/ring.py``) runs at sp > 1 under
every pipeline layout.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelPlan, ShapeConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import offload as ofl
from repro_torch.core import partition as part
from repro_torch.core import schedule as sched_mod
from repro_torch.core import simulate as sim_mod
from repro_torch.core import tree
from repro_torch.data.pipeline import shard_batch
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import ModelDef, build_model, marker_dim, param_markers
from repro_torch.models.transformer import ChunkMeta
from repro_torch.parallel.ctx import SINGLE, Ctx, make_ctx
from repro_torch.parallel.plans import resolve_plan
from repro_torch.parallel.specs import zero1_dims

DECODE_BUDGET = 128  # extra decode slots beyond the shape's cache length


@dataclass(frozen=True)
class Cell:
    """One resolved (arch x shape x data axis) configuration."""

    mdef: ModelDef
    plan: ParallelPlan
    shape: ShapeConfig
    sched: part.ChunkSchedule
    alphas: tuple = ()   # per-chunk offload ratio (zeros with offload off)
    dtype: torch.dtype = torch.bfloat16
    # document lengths of a packed variable-length batch (empty: the uniform
    # layout).  When set, the batch carries a ``doc_start`` array and
    # attention masks cross-document visibility (DESIGN.md §13)
    doc_lens: tuple = ()
    data_size: int = 1   # ranks of the data axis: dp x pp (the model axis: plan.sp)
    pods: int = 1        # the pod axis, outermost: pure data parallelism

    @property
    def cfg(self) -> ModelConfig:
        return self.mdef.cfg

    @property
    def b_loc(self) -> int:
        """Rows of the batch a dp group of a pod takes."""
        return max(1, self.shape.global_batch // (self.pods * self.plan.dp))

    def ctx(self, *, device="cuda") -> Ctx:
        """This process's rank for the cell (``parallel/ctx.py``): one
        device at pods x dp x pp x sp = 1, else this rank of the process
        group."""
        return make_ctx(self.plan, pods=self.pods, device=device)

    def rows(self, ctx: Ctx, *arrays):
        """This rank's rows of each [B, S] numpy array (its dp group's in
        its pod), by the reference's ``shard_batch`` layout."""
        lay = shard_batch(*arrays[:2], pods=self.pods, data_size=self.data_size,
                          pp=self.plan.pp, doc_start=arrays[2] if len(arrays) > 2 else None)
        at = (ctx.pod_index(), ctx.data_index())
        return tuple(lay[k][at] for k in ("tokens", "labels", "doc_start")[:len(arrays)])

    @property
    def varlen(self) -> bool:
        return bool(self.doc_lens)

    @property
    def cache_loc(self) -> int:
        s = self.shape.seq_len
        # prefill leaves room for the decode appends (same geometry, so a
        # prefill cache feeds serve_step directly); training never decodes
        extra = (DECODE_BUDGET * self.plan.sp
                 if self.shape.kind in ("decode", "prefill") else 0)
        return (s + extra) // self.plan.sp


def resolve_cell(arch, shape_cfg: ShapeConfig, *, overrides=None,
                 dtype=torch.bfloat16, doc_lens=None, data_size: int = 1,
                 model_size: int = 1, pods: int = 1) -> Cell:
    """Resolve a train, prefill or decode cell over ``pods`` pods of
    ``data_size`` data ranks (dp x pp) times ``model_size`` model ranks
    (sp); the plan's ``zero1`` follows pods > 1, as in the reference.

    The chunk plan and the offload ratios are the reference's
    (``repro/parallel/runner.py::resolve_cell``): each chunk's forward time
    is its share of 6 N B S FLOPs at the H100's bf16 peak over (1 +
    ``BWD_RATIO``) (N the stage-aware active count of
    ``costmodel.count_active_params(mdef, pp)``, the time split
    over the pp stages), and α_i offloads what its host link (``d2h_bw``)
    moves in the next chunk's forward, at the effective rate ``d2h_bw /
    offload_wire_ratio`` under an activation codec; zeros with offload off.
    A training plan that offloads must run remat "sppo" (the policy whose
    saved rows the offload moves) in the explicit form; the moments move in
    the explicit form too, a moment codec needs the moment offload, and a
    decode plan takes no codec.

    At pp > 1 the chunks are equal (partition "length", ``S % (N sp) ==
    0``); under MSP the chunk length must divide by ``msp_split``, and a
    family with recurrent state is refused (a ramp sub-event re-runs its
    whole chunk, which only a position-tagged cache absorbs, DESIGN.md §2).
    At pp = 1 the boundaries fall on multiples of max(sp, 128), and α sees
    each model rank's share of a chunk's rows (``chunk_act_bytes(sp=)``).
    An MLA model (deepseek-v3), the recurrent families (rwkv6, zamba2) and
    the cross-attention families (llama-3.2-vision, whisper) run at sp = pp
    = 1 only: more raises NotImplementedError naming the ROADMAP item that
    brings it (MSP, which a recurrent state cannot take, a ValueError).

    ``doc_lens`` makes a packed variable-length cell (DESIGN.md §13), as in
    the reference: the documents are packed into rows of S tokens
    (``pack_lengths``; they must fit ``global_batch`` rows, the filler rows
    costing the dense work alone), the chunks balance the summed per-row
    causal sawtooth (``partition_profile``, snapping to document boundaries
    common to every row) under policy "flops" at pp = 1 and are equal at pp
    > 1, and α sees each chunk's share of that profile.  A decode cell takes
    no ``doc_lens``."""
    mdef = arch if isinstance(arch, ModelDef) else build_model(arch)
    cfg = mdef.cfg
    plan = resolve_plan(cfg, shape_cfg, data_size=data_size, model_size=model_size,
                        pods=pods, overrides=overrides)
    sp = plan.sp
    if cfg.mla is not None and (sp > 1 or plan.pp > 1):
        raise NotImplementedError(
            f"{cfg.name} at sp = {sp}, pp = {plan.pp}: MLA runs at sp = pp = 1 in the port; "
            "its model-axis shards and pipeline stages come with a later slice (ROADMAP "
            "Queue 1, item 7)")
    if cfg.cross_attn is not None and (sp > 1 or plan.pp > 1):
        raise NotImplementedError(
            f"{cfg.name} at sp = {sp}, pp = {plan.pp}: the {cfg.family} family runs at "
            "sp = pp = 1 in the port; the context sharded over the model axis and the "
            "pipeline stages come with a later slice (ROADMAP Queue 1, item 7)")
    if cfg.sub_quadratic and (sp > 1 or plan.pp > 1):
        if plan.msp and plan.pp > 1:
            raise ValueError(f"msp unsupported for family {cfg.family!r}: recurrent "
                             "state updates are not idempotent under full-chunk "
                             "recompute (DESIGN.md §2)")
        raise NotImplementedError(
            f"{cfg.name} at sp = {sp}, pp = {plan.pp}: the {cfg.family} family runs at "
            "sp = pp = 1 in the port; head-parallel Mamba2, the sequence-sharded RWKV6 "
            "and their pipeline stages come with a later slice (ROADMAP Queue 1, item 7)")
    doc_lens = tuple(int(x) for x in (doc_lens if doc_lens is not None else ()))
    for codec in (plan.offload_dtype, plan.moments_dtype):
        cm.codec_itemsize(codec)            # raises on an unknown codec
    if plan.moments_mode != "explicit":
        raise ValueError(f"moments_mode {plan.moments_mode!r}: the port places the moments "
                         "itself ('explicit'); 'xla' is the reference's placement through "
                         "XLA shardings")
    if plan.moments_dtype != "none" and not plan.offload_moments:
        raise ValueError(f"moments_dtype {plan.moments_dtype!r} requires offload_moments: "
                         "moments on the device have no host channel to compress")
    if shape_cfg.kind == "decode":
        if doc_lens:
            raise ValueError("packed variable-length layouts are train/prefill only")
        # a decode step has no backward: an offloaded row would never come back
        if plan.offload:
            raise ValueError("decode plans must not offload (DESIGN.md §4)")
        # and with offload off a codec would compress a channel that is
        # never used (the reference refuses it too, DESIGN.md §14)
        if plan.offload_dtype != "none" or plan.moments_dtype != "none":
            raise ValueError("decode plans must not request compressed residency "
                             f"(offload_dtype={plan.offload_dtype!r}, "
                             f"moments_dtype={plan.moments_dtype!r})")
        return Cell(mdef=mdef, plan=plan, shape=shape_cfg,
                    sched=part.ChunkSchedule((1,), (0,), 1, "decode"),
                    alphas=(0.0,), dtype=dtype, data_size=data_size, pods=pods)
    if shape_cfg.kind not in ("prefill", "train"):
        raise ValueError(f"unknown shape kind {shape_cfg.kind!r}")
    if shape_cfg.kind == "train" and plan.offload:
        if plan.remat != "sppo":
            raise ValueError(f"offload with remat {plan.remat!r}: the offload moves the "
                             "tagged rows that remat 'sppo' saves (pass offload=False)")
        if plan.offload_mode != "explicit":
            raise ValueError(f"offload_mode {plan.offload_mode!r}: the port places the "
                             "rows itself ('explicit'); 'xla' is the reference's remat hint")
    # chunk boundaries on multiples of max(sp, 128), as the reference's pp
    # == 1 plan
    S, B = shape_cfg.seq_len, shape_cfg.global_batch
    r = part.flops_per_token_ratio(cfg)
    n = plan.n_chunks
    mult = max(sp, 128)
    if plan.pp > 1:
        if S % (n * sp):
            raise ValueError(f"seq_len {S} does not split into {n} equal chunks of "
                             f"{sp} model shards (pp > 1)")
        if plan.msp:
            if (S // n) % plan.msp_split:
                raise ValueError(f"chunk len {S // n} not divisible by msp_split "
                                 f"{plan.msp_split}")
            if cfg.sub_quadratic:
                raise ValueError(f"msp unsupported for family {cfg.family!r}: recurrent "
                                 "state updates are not idempotent under full-chunk "
                                 "recompute (DESIGN.md §2)")
    profile = None
    if doc_lens:
        # the packed layout's cost profile: the causal sawtooth of each row
        # (cost restarts at every document), summed over the batch
        rows = part.pack_lengths(list(doc_lens), S)
        if len(rows) > B:
            raise ValueError(f"packing needs {len(rows)} rows > global_batch {B}")
        # filler rows are all padding but still ride the dense matmuls
        row_lens = ([[doc_lens[i] for i in row] for row in rows]
                    + [[] for _ in range(B - len(rows))])
        profile = part.packed_cost_profile(row_lens, S, r)
    if plan.pp > 1:
        sched = part.partition_length(S, n)
    elif profile is not None and plan.partition == "flops":
        sched = part.partition_profile(profile, n, multiple=mult,
                                       doc_bounds=part.aligned_doc_bounds(row_lens, S))
    else:
        sched = part.partition(S, n, cfg, plan.partition, multiple=mult)
    if profile is not None:
        # the profile sums over the rows; α wants one row's share
        costs = [c / max(1, B) for c in part.profile_chunk_costs(profile, sched)]
    else:
        costs = part.chunk_costs(sched, r)
    # sequence-aware offload ratios from the cost model (§5.2)
    n_params = cm.count_active_params(mdef, plan.pp)
    scale = (6 * n_params * B * S
             / sum(costs) / (plan.sp * plan.pp * cm.H100.peak_flops_bf16))
    times = [c * scale / (1.0 + cm.BWD_RATIO) for c in costs]
    acts = cm.chunk_act_bytes(cfg, sched.lengths, batch=max(1, B // (pods * plan.dp)),
                              pp=plan.pp, sp=plan.sp, grad_accum=plan.grad_accum)
    # compressed rows cross the link at wire_ratio of their bytes: α is
    # planned at the effective rate of raw bytes (DESIGN.md §14)
    bw_eff = cm.H100.d2h_bw / cm.offload_wire_ratio(plan.offload_dtype)
    alphas = ofl.sequence_aware_alphas(acts, times, bw_eff).alphas
    if not plan.offload:
        alphas = tuple(0.0 for _ in alphas)
    return Cell(mdef=mdef, plan=plan, shape=shape_cfg, sched=sched,
                alphas=alphas, dtype=dtype, doc_lens=doc_lens, data_size=data_size, pods=pods)


def _rope(cfg, q_pos):
    """The chunk's RoPE tables: of the head dim, or MLA's rope head dim (the
    reference's ``apply_rope`` of q_rope and k_rope); None for a model
    without RoPE (rwkv6)."""
    if not cfg.rope or cfg.pos_emb != "rope":
        return None
    if cfg.mla is not None:
        return L.rope_tables(q_pos, cfg.mla.rope_head_dim, cfg.rope_theta)
    return L.rope_tables(q_pos, cfg.hd, cfg.rope_theta, cfg.rope_fraction)


def use_ahead_prefetch(plan: ParallelPlan, *, train: bool) -> bool:
    """Whether the chunks' reloads are issued one chunk ahead (DESIGN.md
    §12): only a differentiated run that offloads under remat "sppo" has a
    backward reload to place."""
    return (train and plan.offload and plan.offload_mode == "explicit"
            and plan.remat == "sppo" and plan.prefetch == "ahead")


def chunk_tag(cell: Cell, chunk: int, link, *, alpha=None, event=None):
    """What a training seam's tag sites do with their rows (the reference's
    per-chunk tag): split at α and send the off rows through ``link`` where
    the plan offloads, else None (every tagged row stays on the device).
    α is the chunk's, or ``alpha`` where given (at pp > 1 every stage tags
    with the fed event's α); ``event`` keys the link at pp > 1."""
    if not cell.plan.offload:
        return None
    return ofl.ChunkOffload(chunk=chunk,
                            alpha=cell.alphas[chunk] if alpha is None else alpha,
                            link=link, codec=cell.plan.offload_dtype, event=event)


class _LinkDrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loss, link, key):
        ctx.link, ctx.key = link, key
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, grad):
        ctx.link.prefetch(ctx.key)
        return grad, None, None


def link_drain(loss, link, last: int):
    """Identity on the loss whose backward issues the reload of the last
    seam's rows, as soon as the backward pass starts: the last seam has no
    later backward to hide it under (why ``reserve_last`` pins its α to 0)."""
    return _LinkDrain.apply(loss, link, last)


class _AttachToken(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loss, token):
        return loss.detach().clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, torch.zeros((), dtype=torch.float32, device=grad.device)


def attach_token(loss, token):
    """Identity on a rank's loss that joins the last hand-off token to it,
    so its backward reaches every hand-off of the rank in tick order
    (``parallel/ctx.py::_HandOff``), as ``link_drain`` reaches the last
    seam's reload."""
    return _AttachToken.apply(loss, token)


def pipeline_feed_events(plan: ParallelPlan, n_chunks: int):
    """The (chunk, sub, n_sub) feed sequence the pp > 1 tick loop executes:
    the MSP ramp (``core/schedule.py::msp_ramp_schedule``) under
    ``plan.msp``, else one whole event per chunk.  The simulator
    (``core/simulate.py``) plays out exactly this sequence (DESIGN.md §2,
    §3)."""
    if plan.msp and plan.pp > 1:
        return sched_mod.msp_ramp_schedule(n_chunks, plan.pp, plan.msp_split)
    return sim_mod.plain_events(n_chunks)


def pipeline_tick_trace(cell: Cell):
    """Static per-tick trace of the pp > 1 loop: one dict per tick with the
    feed event entering stage 0 and the drain event leaving stage pp - 1."""
    plan = cell.plan
    events = pipeline_feed_events(plan, cell.sched.n)
    n_ticks = len(events) + plan.pp - 1
    trace = []
    for t in range(n_ticks):
        feed = events[t] if t < len(events) else None
        e_last = t - (plan.pp - 1)
        drain = events[e_last] if 0 <= e_last < len(events) else None
        trace.append(dict(tick=t, feed=feed, drain=drain))
    return trace


def _chunk_meta(cell: Cell, ctx: Ctx, off: int, ln: int, doc_start, dev, *,
                cache_off: int, kv_view: int):
    """The ChunkMeta of this model rank's rows of the chunk [off, off + ln):
    positions ``off + rank * lloc + arange(lloc)`` (lloc = ln / sp, the
    reference's ``chunk_positions``), their RoPE tables and document
    windows, and the cache slots given."""
    lloc = ln // cell.plan.sp
    lo = off + ctx.model_index() * lloc
    q_pos = lo + torch.arange(lloc, dtype=torch.int32, device=dev)
    return ChunkMeta(q_pos=q_pos, cache_off=cache_off, kv_view=kv_view,
                     rope=_rope(cell.cfg, q_pos),
                     q_start=None if doc_start is None else doc_start[:, lo:lo + lloc],
                     ctx=ctx if cell.plan.sp > 1 else None)


def _cross_state(cell: Cell, stage_p, g, context, B: int, dev, *, train: bool):
    """The stage's per-slot state: for a cross-attention model the context
    ([B, N_ctx, d]) is encoded first where the model has an encoder (the
    reference's ``runner.py:428-433``) and each slot's "xkv" made from it;
    differentiable where a gradient is wanted, the encoder, the ``xattn``
    K/V projections and the context's rows then getting the sum of every
    chunk's gradient through it."""
    mdef = cell.mdef
    if mdef.cfg.cross_attn is None:
        return mdef.init_state(B, cell.cache_loc, cell.dtype, dev, train=train,
                               n_slots=len(stage_p))
    n = mdef.n_context()
    if context is None or tuple(context.shape) != (B, n, mdef.cfg.d_model):
        raise ValueError(f"{mdef.cfg.name} reads a context of [{B}, {n}, "
                         f"{mdef.cfg.d_model}], got "
                         f"{None if context is None else tuple(context.shape)}")
    return mdef.init_state(B, cell.cache_loc, cell.dtype, dev, train=train,
                           stage_params=stage_p, context=mdef.encode(g, context.to(cell.dtype)))


def run_pipeline(cell: Cell, stage_p, g, tokens, labels=None, *,
                 with_loss: bool = False, doc_start=None, ctx: Ctx = SINGLE, context=None):
    """The chunk loop of this rank.  tokens, labels: [B, S] int (a dp
    group's rows, every model rank's alike).  ``doc_start``: optional [B, S]
    int32 start of each token's document in a packed batch (``PAD_START``
    on padding), sliced chunk by chunk, at this model rank's rows, into the
    attention's window (``ChunkMeta.q_start``), so documents never attend
    across their boundaries.  With ``with_loss`` the
    head loss is added over the tokens whose label is >= 0 (the label
    sentinel: a negative label carries zero weight), and the caches keep
    every chunk's K/V for the backward; where a gradient is wanted, each
    chunk's stack runs through its seam under the plan's remat policy and
    offload.  ``context`` ([B, N_ctx, d]): a cross-attention model's stub
    patch or frame embeddings, encoded (whisper) and projected to each
    slot's K/V once, before the chunks (``_cross_state``); the chunks of a
    model with learned positions embed theirs.  Returns dict(loss, denom,
    aux, state, last_x, link, seed); aux is the chunks' summed MoE balance
    loss (0.0 for a dense model);
    loss and denom are None without ``with_loss``, link (the step's host
    rows, ``core/offload.py::Link``) None where nothing offloads; ``seed``
    (the first hand-off token) None at pp = 1 (``_run_ticks``)."""
    if cell.plan.pp > 1:
        return _run_ticks(cell, ctx, stage_p, g, tokens, labels, with_loss=with_loss,
                          doc_start=doc_start)
    mdef, plan = cell.mdef, cell.plan
    dev = tokens.device
    state = _cross_state(cell, stage_p, g, context, tokens.shape[0], dev, train=with_loss)
    train = with_loss and torch.is_grad_enabled()
    ahead = use_ahead_prefetch(plan, train=train)
    link = ofl.Link(ahead=ahead) if train and plan.offload else None
    loss = denom = x = None
    aux = 0.0
    for c, (off, ln) in enumerate(zip(cell.sched.offsets, cell.sched.lengths)):
        meta = _chunk_meta(cell, ctx, off, ln, doc_start, dev, cache_off=off // plan.sp,
                           kv_view=(off + ln) // plan.sp)
        x = mdef.embed(g, tokens[:, off:off + ln], ctx, q_pos=meta.q_pos)
        if train:
            # the chunk's seam (the reference's prefetch_chunk): its backward
            # takes the chunk's reloaded rows from the link and, under
            # "ahead", first issues the reload of the chunk before it
            x, state, a = mdef.stage_apply(stage_p, state, x, meta, remat=plan.remat,
                                           offload=chunk_tag(cell, c, link), g=g)
        else:
            x, state, a = mdef.stage_apply(stage_p, state, x, meta, g=g)
        aux = aux + a
        if with_loss:
            lab = labels[:, off:off + ln]
            ls, cnt = mdef.head_loss(g, x, lab, (lab >= 0).float(), ctx)
            loss = ls if loss is None else loss + ls
            denom = cnt if denom is None else denom + cnt
    if ahead:
        loss = link_drain(loss, link, cell.sched.n - 1)
    return dict(loss=loss, denom=denom, aux=aux, state=state, last_x=x, link=link, seed=None)


def _run_ticks(cell: Cell, ctx: Ctx, stage_p, g, tokens, labels, *, with_loss: bool,
               doc_start=None):
    """The pp > 1 tick loop of this rank's stage (reference
    ``runner.py:499-601``, DESIGN.md §2, §4).

    At tick t, stage s runs event e = t - s of the feed events: stage 0
    embeds the event's chunk (once for the sub-events of a ramp chunk:
    the same tokens give the same rows, and their gradients then meet in
    one embedding backward), the others take the carry stage s - 1 handed
    on at the tick before; an MSP ramp sub-event runs its whole chunk (its
    K/V rewrite replaces the chunk's cache entry, bitwise the same values:
    ``attention.truncate_chunks``); the last stage adds the event's head
    loss under its sub-chunk mask times the label sentinel, so each token
    counts once.  Every stage tags its rows with the fed event's α, the
    uniform SPMD program's constraint (``runner.py:553``), and its seams
    are keyed by event in the offload link.  After its compute, each tick's
    hand-off sends event e's output to stage s + 1 and receives event e +
    1's input from stage s - 1 (``Ctx.handoff``), at this model index.  A
    packed batch's document windows are the stage's chunk's, at this model
    rank's rows (the reference's ``ds_loc``); at sp > 1 the chunk's rows
    and cache slots are the model rank's (``cache_off = c * lloc``).

    Where the port departs from the reference's one SPMD program: a stage
    runs no compute at its warmup and drain ticks (e outside [0, E)), which
    is the reference's valid-tick mask (``runner.py:548-574``, its
    drain-tick fix) done by not running, and posts no transfer there either,
    since its peer's matching tick is idle too; the reference's ``kv_view``
    is the fed chunk's end on every stage (PAD slots hide the rest), the
    port's the stage's own chunk end.  An MoE stack's aux is scaled by
    1 / n_sub on each sub-event, so that each chunk counts once
    (reference ``runner.py:578-580``).  Each rank runs its own backward:
    every hand-off takes the previous one's token, and the loss takes the
    last (``attach_token``), so each rank's backward meets every hand-off
    its peers post, in tick order.  ``seed``, the first token, is a leaf
    the caller differentiates too, so that no hand-off is pruned from the
    backward."""
    mdef, plan, cfg = cell.mdef, cell.plan, cell.cfg
    pp, stage = plan.pp, ctx.stage_index()
    if ctx.pp != pp or not ctx.distributed:
        raise ValueError(f"pp = {pp} needs the context of a {pp}-stage process group "
                         f"(got pp = {ctx.pp}, backend {ctx.backend!r})")
    N, S = cell.sched.n, cell.shape.seq_len
    clen = S // N
    lloc = clen // plan.sp
    B, dev = tokens.shape[0], tokens.device
    events = pipeline_feed_events(plan, N)
    E = len(events)
    state = mdef.init_state(B, cell.cache_loc, cell.dtype, dev, train=with_loss,
                            n_slots=len(stage_p))
    train = with_loss and torch.is_grad_enabled()
    ahead = use_ahead_prefetch(plan, train=train)
    link = ofl.Link(ahead=ahead) if train and plan.offload else None
    seed = torch.zeros((), device=dev, requires_grad=train)
    token, carry, x_last = seed, None, None
    emb = emb_chunk = None
    loss = denom = None
    aux = 0.0
    carry_like = ((B, lloc, cfg.d_model), cell.dtype)
    pos_in = torch.arange(clen, device=dev)
    for t in range(E + pp - 1):
        e = t - stage
        x = None
        if 0 <= e < E:
            c, sub, n_sub = events[e]
            off = c * clen
            if stage == 0 and emb_chunk != c:
                emb, emb_chunk = mdef.embed(g, tokens[:, off:off + clen], ctx), c
            h = emb if stage == 0 else carry
            meta = _chunk_meta(cell, ctx, off, clen, doc_start, dev, cache_off=c * lloc,
                               kv_view=(c + 1) * lloc)
            if train:
                fed = events[min(t, E - 1)][0]
                x, state, a = mdef.stage_apply(
                    stage_p, state, h, meta, remat=plan.remat,
                    offload=chunk_tag(cell, c, link, alpha=cell.alphas[fed], event=e))
            else:
                x, state, a = mdef.stage_apply(stage_p, state, h, meta)
            aux = aux + a * (1.0 / n_sub)
            x_last = x
            if with_loss and stage == pp - 1:
                lab = labels[:, off:off + clen]
                sublen = clen // n_sub
                mask = ((pos_in >= sub * sublen) & (pos_in < (sub + 1) * sublen)).float()
                ls, cnt = mdef.head_loss(g, x, lab, mask[None, :] * (lab >= 0).float(), ctx)
                loss = ls if loss is None else loss + ls
                denom = cnt if denom is None else denom + cnt
        send = x if stage < pp - 1 else None
        recv = carry_like if stage > 0 and 0 <= e + 1 < E else None
        carry = None
        if send is not None or recv is not None:
            carry, token = ctx.handoff(send, recv, token, t)
    if with_loss:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        loss = zero if loss is None else loss
        denom = zero if denom is None else denom
        if train:
            loss = attach_token(loss, token)
            if ahead:
                loss = link_drain(loss, link, E - 1)
    return dict(loss=loss, denom=denom, aux=aux, state=state, last_x=x_last, link=link,
                seed=seed if train else None)


def make_prefill_step(cell: Cell, ctx: Ctx = SINGLE):
    """The chunk loop without a loss (reference ``make_prefill_step``): the
    cache its decode cell reads.  At sp > 1 each rank's cache is its shard
    of every chunk (slots ``[off / sp, (off + T) / sp)``, the
    chunk-contiguous layout ``kvpool.pos_map`` mirrors), attended under the
    plan's schedule, the ring's included."""
    def prefill_step(params, tokens, context=None):
        """tokens: [B, S] int (this rank's dp group's rows, every model
        rank's alike); ``context``: a cross-attention model's [B, N_ctx, d]
        stub embeddings of those rows.  Returns (per-slot caches, the
        cross-attention K/V beside them, and the last chunk's hidden) of
        this rank's stage and model shard."""
        _check_ctx(cell, ctx)
        out = run_pipeline(cell, params["stages"], params["globals"], tokens, ctx=ctx,
                           context=context)
        return out["state"], out["last_x"]

    return prefill_step


def trainable(path: str) -> bool:
    """Every parameter is trained except the gates (a slot's, a hybrid
    mixer's and its shared block's, a VLM self layer's), structural
    constants (the reference stops their gradients); a VLM's learned cross
    gates (``xgate_attn``, ``xgate_mlp``) are trained."""
    return not path.endswith(("gate", "gate_shared"))


def unread(cfg, path: str) -> bool:
    """Leaves the model never reads, whose gradient is zero: the ``xattn``
    biases of a model with qkv biases (whisper), since the reference's
    cross-attention projects q, k and v without them."""
    return cfg.qkv_bias and "xattn/b" in path


def _check_ctx(cell: Cell, ctx: Ctx) -> None:
    plan = cell.plan
    if (ctx.pods, ctx.dp, ctx.pp, ctx.sp) != (cell.pods, plan.dp, plan.pp, plan.sp):
        raise ValueError(f"the cell is pods x dp x pp x sp = {cell.pods} x {plan.dp} x "
                         f"{plan.pp} x {plan.sp}, its context {ctx.pods} x {ctx.dp} x "
                         f"{ctx.pp} x {ctx.sp}")
    if plan.sp > 1 and (ctx.attn_mode, ctx.merge_bf16, ctx.grad_compress) != (
            plan.attn_mode, plan.merge_bf16, plan.grad_compress):
        raise ValueError("the context's attn_mode / merge_bf16 / grad_compress differ "
                         "from the plan's (make it with cell.ctx())")


def loss_and_grads(cell: Cell, params, tokens, labels, doc_start=None, *,
                   ctx: Ctx = SINGLE, context=None):
    """The loss ``sum / max(count, 1)`` of the chunked pipeline and its
    gradients, a tree like ``params`` (zeros for the gate).

    Over several ranks (``ctx``) ``params`` are this rank's stage and the
    globals (at sp > 1 its model shard of each), ``tokens`` its dp group's
    rows: the loss is the sum of every data rank's loss over the sum of
    their counts (``psum_loss_all``), each rank differentiates its share
    of it, the replicated leaves' gradients are summed over the model group
    (``psum_model_grads``), and the stage gradients are summed over the dp
    group (``psum_grads``), the globals' over the data axis
    (``psum_globals``: each summed where it is used, then sent to the
    stages that do not use it): every rank returns the loss and the
    gradient of its parameters (of its shards), the gradient of the global
    loss (the module docstring says where this departs from the
    reference).

    An MoE model adds ``0.01 · aux / (data_size · pods · sp · n_chunks ·
    n_slots)`` (reference ``runner.py:676-681``), aux each rank's chunks'
    balance loss over its own rows, summed over every rank
    (``Ctx.psum_all``) for the value; each rank differentiates its own.

    With ``plan.grad_accum = A > 1`` the batch is cut into A microbatches of
    B / A rows, each run forward and backward on its own; the loss and the
    gradients are the means over them, the gradients summed in fp32, as in
    the reference's accumulation scan.  With A = 1 the gradients come in
    the parameters' dtypes.  ``doc_start`` (a packed batch's [B, S] document
    starts) is split as the tokens are and reaches the attention only in a
    varlen cell (``cell.varlen``), as in the reference; so is a
    cross-attention model's ``context`` ([B, N_ctx, d])."""
    _check_ctx(cell, ctx)
    if not cell.varlen:
        doc_start = None

    def one(tok, lab, ds, cx):
        # detached aliases: the caller's tensors are not touched
        alias = tree.map_(lambda t: t.detach(), params)
        leaves = [t.requires_grad_() for p, t in tree.items(alias) if trainable(p)]
        # the chunk seams sum the stage parameters' gradients in place
        # (``transformer.GradSink``); autograd returns the rest
        sink = T.GradSink()
        with torch.enable_grad(), T.collect_param_grads(sink):
            out = run_pipeline(cell, alias["stages"], alias["globals"], tok, lab,
                               with_loss=True, doc_start=ds, ctx=ctx, context=cx)
            if ctx.distributed:
                den = ctx.psum_loss_all(out["denom"]).clamp_min(1.0)
                value = ctx.psum_loss_all(out["loss"]) / den
                loss = out["loss"] / den
            else:
                loss = value = out["loss"] / out["denom"].clamp_min(1.0)
            if cell.cfg.moe is not None:
                scale = 0.01 / (cell.data_size * cell.pods * cell.plan.sp * cell.sched.n
                                * max(1, cell.mdef.n_slots))
                aux = torch.as_tensor(out["aux"], dtype=torch.float32, device=tok.device)
                loss = loss + scale * aux
                value = value + scale * ctx.psum_all(aux)
            # the first hand-off token is differentiated too: no hand-off is
            # pruned from this rank's backward (``_run_ticks``)
            extra = [] if out["seed"] is None else [out["seed"]]
            # a rank's stage uses only some of the globals (the embedding
            # on stage 0, the head on the last): the others get zeros
            got = torch.autograd.grad(loss, leaves + extra, allow_unused=True)[:len(leaves)]
        got = [_with_sink(g, sink.take(t)) for g, t in zip(got, leaves)]
        paths = [p for p, _ in tree.items(alias) if trainable(p)]
        if not ctx.distributed and any(g is None and not unread(cell.cfg, p)
                                       for g, p in zip(got, paths)):
            raise RuntimeError("a trainable parameter got no gradient on one device")
        grads = iter(got)
        flat = [next(grads) if trainable(p) else None for p, t in tree.items(params)]
        used = [g is not None for g in flat]
        flat = [torch.zeros_like(t) if g is None else g
                for g, t in zip(flat, tree.leaves(params))]
        return value.detach(), flat, used

    A = cell.plan.grad_accum
    if A > 1:
        B = tokens.shape[0]
        if B % A:
            raise ValueError(f"batch {B} does not split into {A} microbatches")
        bm = B // A
        loss, gsum = None, None
        for a in range(A):
            rows = slice(a * bm, (a + 1) * bm)
            l, flat, used = one(tokens[rows], labels[rows],
                                None if doc_start is None else doc_start[rows],
                                None if context is None else context[rows])
            if gsum is None:
                loss, gsum = l, [g.float() for g in flat]
            else:
                loss = loss + l
                for acc, g in zip(gsum, flat):
                    acc.add_(g.float())
        loss, flat = loss / A, [g / A for g in gsum]
    else:
        loss, flat, used = one(tokens, labels, doc_start, context)
    it, it_used = iter(flat), iter(used)
    grads = tree.map_(lambda _: next(it), params)
    used = tree.map_(lambda _: next(it_used), params)
    if ctx.sp > 1:
        # each model rank differentiated its sequence shard through the
        # replicated leaves: their gradients are summed over the model group
        marks = tree.leaves(param_markers(cell.mdef, params))
        ctx.psum_model_grads([t for t, m, u in zip(tree.leaves(grads), marks, tree.leaves(used))
                              if marker_dim(m) is None and u])
    # stage gradients over the dp replicas of the stage, the globals' over
    # the data axis (their contributions live on different stages; the ones
    # this rank's graph never reached are zeros here)
    ctx.psum_grads(tree.leaves(grads["stages"]))
    ctx.psum_globals(tree.leaves(grads["globals"]), tree.leaves(used["globals"]))
    return loss, grads


def _with_sink(g, s):
    """A parameter's gradient from autograd (``g``) and from the seams'
    sink (``s``), either possibly None."""
    if s is None:
        return g
    return s if g is None else g + s


def global_grad_norm(grads, ctx: Ctx = SINGLE, mdef: ModelDef = None) -> torch.Tensor:
    """The global norm of the model's gradients from this rank's share
    (its stage's and the globals', already reduced): at sp > 1 the squares
    of the sharded leaves (``mdef``'s markers) summed over the model group
    and the replicated ones counted once; the stages' squares summed over
    the stages of the dp group (``psum_stages``), each stage and the
    globals counted once, the same on every rank, so every rank clips
    alike and the replicated leaves stay identical."""
    from repro_torch.optim import adamw

    if not ctx.distributed:
        return adamw.global_norm(grads)
    if ctx.sp > 1:
        marks = param_markers(mdef, grads)
        sq = torch.zeros(2, 2, dtype=torch.float32, device=ctx.device)
        for row, part in enumerate(("stages", "globals")):
            for g, m in zip(tree.leaves(grads[part]), tree.leaves(marks[part])):
                sq[row, int(marker_dim(m) is not None)] += g.float().square().sum()
        sharded = sq[:, 1].clone()
        ctx.psum_model_grads([sharded])
        sq = sq[:, 0] + sharded
    else:
        sq = torch.stack([adamw.global_norm(grads[part]).square()
                          for part in ("stages", "globals")])
    stages = sq[:1].clone()
    ctx.psum_stages([stages])
    return torch.sqrt(stages[0] + sq[1])


def pod_slices(cell: Cell, params, ctx: Ctx):
    """ZeRO-1's slices of this rank's parameter leaves
    (``adamw.PodSlices``, the widening rule of ``parallel/specs.py``), or
    None where the plan runs no ZeRO-1 or there is one pod."""
    from repro_torch.optim import adamw

    if not (cell.plan.zero1 and cell.pods > 1):
        return None
    return adamw.PodSlices(tuple(zero1_dims(cell.mdef, params, cell.plan.sp, cell.pods)),
                           cell.pods, ctx.pod_index())


def init_opt_state(cell: Cell, params, ctx: Ctx = SINGLE):
    """AdamW's state for this rank's ``params`` where the plan keeps it
    (``offload_moments``, ``moments_dtype``), in the plan's ``opt_dtype``
    (bf16 for deepseek), of the pod slices under ZeRO-1."""
    from repro_torch.optim import adamw

    plan = cell.plan
    return adamw.init_state(params, opt_dtype=plan.opt_dtype,
                            offload_moments=plan.offload_moments,
                            moments_dtype=plan.moments_dtype, moments_mode=plan.moments_mode,
                            pod_slices=pod_slices(cell, params, ctx))


def make_train_step(cell: Cell, *, lr_kwargs=None, ctx: Ctx = SINGLE):
    """Build the training step: loss and gradients of the chunked pipeline,
    then one AdamW update (global-norm clip, cosine schedule) in place, its
    moments where the plan keeps them (``offload_moments``,
    ``moments_dtype``: ``opt_state`` from ``init_opt_state``).  Over
    several ranks each rank updates what it holds, clipped by the model's
    global norm (``global_grad_norm``); at sp > 1 the moments are those of
    the rank's shards, under ZeRO-1 of their pod slices, whose update the
    pods then gather."""
    from repro_torch.optim import adamw

    lr_kwargs = lr_kwargs or {}

    def train_step(params, opt_state, tokens, labels, doc_start=None, context=None):
        """tokens, labels (and a packed batch's doc_start): [B, S] int on the
        parameters' device (a dp group's rows over several ranks);
        ``context``: a cross-attention model's [B, N_ctx, d] stub
        embeddings of those rows.  Returns (params, opt_state, metrics);
        metrics hold tensors (loss, grad_norm, lr) that stay on the device
        until read."""
        loss, grads = loss_and_grads(cell, params, tokens, labels, doc_start, ctx=ctx,
                                     context=context)
        lr = adamw.cosine_lr(opt_state.step, **lr_kwargs)
        plan = cell.plan
        params, opt_state, met = adamw.apply_update(
            params, grads, opt_state, lr=lr, offload_moments=plan.offload_moments,
            moments_mode=plan.moments_mode, moments_dtype=plan.moments_dtype,
            grad_norm=global_grad_norm(grads, ctx, cell.mdef) if ctx.distributed else None,
            pod_slices=pod_slices(cell, params, ctx), gather=ctx.all_gather_pod)
        met["loss"] = loss
        return params, opt_state, met

    return train_step


def max_decode_steps(cell: Cell) -> int:
    """Longest decode run the striped cache can absorb: token S + i lands at
    local slot S / sp + i // sp, and the buffer holds DECODE_BUDGET slots
    past S / sp, so step DECODE_BUDGET x sp is the first to fall off the
    end."""
    return DECODE_BUDGET * cell.plan.sp


def make_serve_step(cell: Cell, *, decode_steps=None, ctx: Ctx = SINGLE):
    """Build the static lock-step decode step (reference
    ``make_serve_step``).  ``decode_steps``, when given, is checked against
    the cache's decode budget up front.

    Each step embeds the row's token on every model rank (``embed(decode=
    True)``), writes its K/V at the striped slot of the one model rank that
    owns position ``pos`` (``gqa_decode_attention``; ``pos`` and the rank
    are host ints, so the others write nothing), attends every rank's cache
    shard and merges, and samples greedily from the gathered logits.  At pp
    > 1 the batch runs as microbatches through the stages
    (``_decode_ticks``) and every stage returns the last stage's tokens.  A
    cross-attention model's decode reads the "xkv" its prefill left in the
    state (reference ``_serve_state``); whisper's token adds its learned
    position's row."""
    if decode_steps is not None and decode_steps > max_decode_steps(cell):
        raise ValueError(
            f"decode_steps={decode_steps} exceeds the cache's decode budget "
            f"of {max_decode_steps(cell)} steps (DECODE_BUDGET={DECODE_BUDGET}"
            f" slots x sp={cell.plan.sp})")
    S, plan, mdef = cell.shape.seq_len, cell.plan, cell.mdef
    sp = plan.sp

    def serve_step(params, state, tokens, pos: int):
        """tokens: [B, 1] int at global position ``pos`` (this rank's dp
        group's rows); returns (state, next tokens [B, 1] int32, greedy)."""
        _check_ctx(cell, ctx)
        i = pos - S
        if not 0 <= i < max_decode_steps(cell):
            raise ValueError(f"decode position {pos} outside the cache's decode "
                             f"positions [{S}, {S + max_decode_steps(cell)})")
        g = params["globals"]
        q_pos = torch.full((1,), pos, dtype=torch.int32, device=tokens.device)
        mine = i % sp == ctx.model_index()
        meta = ChunkMeta(q_pos=q_pos, cache_off=S // sp + i // sp if mine else None,
                         kv_view=None, rope=_rope(cell.cfg, q_pos), decode=True,
                         ctx=ctx if sp > 1 else None)
        if plan.pp > 1:
            return state, _decode_ticks(cell, ctx, params["stages"], g, state, tokens, meta)
        x = mdef.embed(g, tokens, ctx, decode=True, q_pos=q_pos)
        x, state, _ = mdef.stage_apply(params["stages"], state, x, meta, g=g)
        return state, mdef.head_logits(g, x, ctx).argmax(dim=-1).to(torch.int32)

    return serve_step


def _decode_ticks(cell: Cell, ctx: Ctx, stage_p, g, state, tokens, meta):
    """The microbatched decode pipeline of this rank's stage (reference
    ``runner.py:836-893``).  The B rows split into M =
    ``plan.decode_microbatch`` microbatches of B / M; over M + pp - 1 ticks,
    stage s runs microbatch t - s on its slice of the cache's rows (views:
    the writes land in the stage's cache): stage 0 embeds the microbatch's
    tokens, the others take the carry stage s - 1 sent at the tick before
    (``Ctx.exchange``, forward only), and the last stage samples.  Its tokens
    are then summed over the stages (``Ctx.psum_stages``, the others
    contributing zeros), so every stage returns them and they thread straight
    back in as the next step's input.

    Where the port departs from the reference's SPMD scan: a stage computes
    nothing at its warmup and drain ticks (t - s outside [0, M)) and posts
    no transfer there, its peer's matching tick being idle too.  The
    reference's warmup ticks write garbage that the stage's valid tick
    overwrites, and its drain ticks recompute microbatch M - 1 from the same
    input, so its caches end as the port's."""
    mdef, plan = cell.mdef, cell.plan
    pp, stage, M = plan.pp, ctx.stage_index(), plan.decode_microbatch
    B = tokens.shape[0]
    if B % M:
        raise ValueError(f"{B} rows do not split into {M} decode microbatches")
    Bm = B // M
    nxt = torch.zeros((B, 1), dtype=torch.int32, device=tokens.device)
    carry = None
    like = ((Bm, 1, cell.cfg.d_model), cell.dtype)
    for t in range(M + pp - 1):
        m = t - stage
        x = None
        if 0 <= m < M:
            rows = slice(m * Bm, (m + 1) * Bm)
            h = mdef.embed(g, tokens[rows], ctx, decode=True) if stage == 0 else carry
            state_m = [{"kv": s["kv"]._replace(k=s["kv"].k[rows], v=s["kv"].v[rows])}
                       for s in state]
            x, _, _ = mdef.stage_apply(stage_p, state_m, h, meta)
            if stage == pp - 1:
                nxt[rows] = mdef.head_logits(g, x, ctx).argmax(dim=-1).to(torch.int32)
        send = x if stage < pp - 1 else None
        recv = like if stage > 0 and 0 <= m + 1 < M else None
        carry = ctx.exchange(send, ctx.rank + ctx.sp if send is not None else None,
                             recv, ctx.rank - ctx.sp if recv is not None else None, tag=t)
    ctx.psum_stages([nxt])
    return nxt


# ---------------------------------------------------------------------------
# Paged-pool continuous-batching decode (DESIGN.md §16)
# ---------------------------------------------------------------------------


def check_pool_cell(cell: Cell, geo) -> None:
    """The reference's limits of the paged pool (its ``_assert_pool_cell``),
    raised as ValueError: pp = 1, one pod, dense GQA, the cell's sp and
    rows the geometry's."""
    cfg = cell.cfg
    if cell.plan.pp != 1:
        raise ValueError(f"the paged decode pool needs pp = 1, got pp = {cell.plan.pp}")
    if cell.pods != 1:
        raise ValueError(f"the paged decode pool is single-pod, got pods = {cell.pods}")
    if cfg.family != "dense" or cfg.cross_attn is not None or cfg.mla is not None:
        raise ValueError(f"the paged decode pool supports dense GQA families only, got "
                         f"family={cfg.family!r}")
    if cell.plan.sp != geo.sp:
        raise ValueError(f"the cell's sp {cell.plan.sp} is not the pool's {geo.sp}")
    if cell.b_loc != geo.n_slots:
        raise ValueError(f"cell batch/shard {cell.b_loc} != pool slots {geo.n_slots}")


def make_pool_state(cell: Cell, geo, device="cuda"):
    """This rank's zero paged KV pool for ``cell`` (reference
    ``make_pool_state``): a ``[P_loc + SINK_SLOTS, Hkv, hd]`` k and v buffer
    a layer (``ModelDef.init_pool``), each model rank's its own sequence
    shard."""
    check_pool_cell(cell, geo)
    return cell.mdef.init_pool(geo, cell.dtype, device,
                               n_slots=cell.mdef.slots_per_stage(cell.plan.pp))


def make_pool_ingest(pre_cell: Cell, geo):
    """Copy an admission wave's prefilled caches into the pool (reference
    ``make_pool_ingest``).

    Identity slot mapping: the engine prefills each admitted request in the
    batch row of its target pool slot, so prefill cache row b feeds pool
    slot b, and the first ``base`` slots of this rank's prefill cache are
    exactly its share of the right-aligned prompt bucket.  Rows outside
    ``admit`` (and unallocated blocks) write to the sink, where the
    reference's scatter drops them."""
    check_pool_cell(pre_cell, geo)
    if pre_cell.shape.seq_len != geo.s_bucket:
        raise ValueError(f"prefill length {pre_cell.shape.seq_len} is not the pool's "
                         f"bucket {geo.s_bucket}")
    if pre_cell.cache_loc < geo.base:
        raise ValueError(f"the prefill cache's {pre_cell.cache_loc} slots hold less than the "
                         f"bucket's {geo.base}")
    bt, base = geo.block_tokens, geo.base

    def ingest(state_pre, pool, btab, admit):
        """state_pre: ``prefill_step``'s caches; pool: this rank's pool;
        btab: [K, max_blocks] int, admit: [K] bool, on the pool's device.
        Writes the pool in place and returns it."""
        jlog = torch.arange(base, device=btab.device)
        blk = btab[:, jlog // bt].long()
        phys = torch.where(admit[:, None] & (blk >= 0), blk * bt + jlog % bt, geo.p_loc)
        for s_pre, s_pool in zip(state_pre, pool):
            kv, pkv = s_pre["kv"], s_pool["kv"]
            pkv.k[phys] = kv.k[:, :base].to(pkv.k.dtype)
            pkv.v[phys] = kv.v[:, :base].to(pkv.v.dtype)
        return pool

    return ingest


def make_pool_serve_step(cell: Cell, geo, pos_map, *, ctx: Ctx = SINGLE, device="cuda"):
    """One continuous-batching decode step against the paged pool
    (reference ``make_pool_serve_step``).

    Unlike ``make_serve_step`` there is no global position: every request
    slot carries its own feed position (``q_pos``; 0 = an inactive slot), its
    own block-table row and its own sampled-token carry, so requests at
    different decode depths step together, and nothing in the step reads a
    device value on the host.  Admission folds in on the device: rows under
    ``admit`` take ``admit_tok`` (the request's last prompt token) in place
    of the carried sample.  ``pos_map`` ([sp, L_loc], ``kvpool.pos_map``)
    goes to ``device`` once, here.

    pool_step(params, pool, tokens [K, 1], q_pos [K], btab [K, max_blocks],
    admit [K] bool, admit_tok [K, 1]) -> (pool, next tokens [K, 1] int32),
    the inputs on the pool's device."""
    check_pool_cell(cell, geo)
    _check_ctx(cell, ctx)
    pos_map = np.asarray(pos_map)
    if pos_map.shape != (geo.sp, geo.l_loc):
        raise ValueError(f"pos_map {pos_map.shape} is not [{geo.sp}, {geo.l_loc}]")
    mdef, cfg = cell.mdef, cell.cfg
    rank_pos = torch.from_numpy(pos_map[ctx.model_index()].astype(np.int32)).to(device)

    def pool_step(params, pool, tokens, q_pos, btab, admit, admit_tok):
        g = params["globals"]
        tokens = torch.where(admit[:, None], admit_tok, tokens)
        paged = A.paged_meta(q_pos, btab, rank_pos, base=geo.base, s_bucket=geo.s_bucket,
                             block_tokens=geo.block_tokens, sp=geo.sp,
                             rank=ctx.model_index(), p_loc=geo.p_loc)
        rows = paged.q_pos[:, None]
        meta = ChunkMeta(q_pos=rows, cache_off=None, kv_view=None, rope=_rope(cfg, rows),
                         decode=True, paged=paged, ctx=ctx if geo.sp > 1 else None)
        x = mdef.embed(g, tokens, ctx, decode=True)
        x, pool, _ = mdef.stage_apply(params["stages"], pool, x, meta)
        return pool, mdef.head_logits(g, x, ctx).argmax(dim=-1).to(torch.int32)

    return pool_step
