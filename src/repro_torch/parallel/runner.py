"""The execution engine at pp = sp = dp = 1 (port of ``repro/parallel/runner.py``).

Builds the step functions of a cell:

  train_step(params, opt_state, tokens, labels) -> (params, opt_state, metrics)
  prefill_step(params, tokens)                  -> (state, last_hidden)
  serve_step(params, state, tokens, pos)        -> (state, next_tokens)

Training and prefill run the reference's pp == 1 pipeline branch: the
sequence is split into FLOPs-balanced chunks (core/partition.py); each chunk
is embedded, runs the layer stack (appending its K/V to the position-tagged
cache and attending a prefix view of it), and hands its hidden state on;
training adds each chunk's head loss, and autograd runs the backward through
the chunks in reverse.  Decode feeds one token per step and attends the
whole cache buffer.

Training runs the plan's remat policy and SPPO's executed activation
offload (DESIGN.md §5, §10, §12): ``resolve_cell`` sizes each chunk's
offload ratio α (``core/offload.py::sequence_aware_alphas``), each chunk's
stack runs through the chunk seam of ``models/transformer.py``, its off rows
go to pinned host memory on a copy stream, and each chunk's rows come back
one chunk ahead of its backward (``prefetch="ahead"``, through a
``core/offload.py::Link`` and ``link_drain``) or at it (``"sync"``); under
``offload_dtype`` "fp8" / "int8" the rows cross quantized, their scales
kept on the device (DESIGN.md §14).  The update keeps AdamW's moments on
the device or, under ``offload_moments``, in pinned host memory, raw or
under ``moments_dtype`` (``optim/adamw.py``, DESIGN.md §11).  The
reference's shard_map and pipeline ticks come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ParallelPlan, ShapeConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import offload as ofl
from repro_torch.core import partition as part
from repro_torch.core import tree
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import ModelDef, build_model
from repro_torch.models.transformer import ChunkMeta
from repro_torch.parallel.plans import resolve_plan

DECODE_BUDGET = 128  # extra decode slots beyond the shape's cache length


@dataclass(frozen=True)
class Cell:
    """One resolved (arch x shape) configuration on one device."""

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

    @property
    def cfg(self) -> ModelConfig:
        return self.mdef.cfg

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


def _later(what: str, item: int):
    return NotImplementedError(f"{what} comes with a later slice of the port "
                               f"(ROADMAP Queue 1, item {item})")


def resolve_cell(arch, shape_cfg: ShapeConfig, *, overrides=None,
                 dtype=torch.bfloat16, doc_lens=None) -> Cell:
    """Resolve a train, prefill or decode cell at data = model = 1, pp = 1.

    The chunk plan and the offload ratios are the reference's
    (``repro/parallel/runner.py::resolve_cell``): each chunk's forward time
    is its share of 6 N B S FLOPs at the H100's bf16 peak over (1 +
    ``BWD_RATIO``), and α_i offloads what its host link (``d2h_bw``) moves
    in the next chunk's forward, at the effective rate ``d2h_bw /
    offload_wire_ratio`` under an activation codec; zeros with offload off.
    A training plan that offloads must run remat "sppo" (the policy whose
    saved rows the offload moves) in the explicit form; the moments move in
    the explicit form too, a moment codec needs the moment offload, and a
    decode plan takes no codec.  pp > 1 is refused, naming the ROADMAP item
    that brings it.

    ``doc_lens`` makes a packed variable-length cell (DESIGN.md §13), as in
    the reference: the documents are packed into rows of S tokens
    (``pack_lengths``; they must fit ``global_batch`` rows, the filler rows
    costing the dense work alone), the chunks balance the summed per-row
    causal sawtooth (``partition_profile``, snapping to document boundaries
    common to every row) under policy "flops", and α sees each chunk's
    share of that profile.  A decode cell takes no ``doc_lens``."""
    mdef = arch if isinstance(arch, ModelDef) else build_model(arch)
    cfg = mdef.cfg
    plan = resolve_plan(cfg, shape_cfg, data_size=1, model_size=1,
                        overrides=overrides)
    doc_lens = tuple(int(x) for x in (doc_lens if doc_lens is not None else ()))
    if plan.pp != 1:
        raise _later(f"pp = {plan.pp} (pipeline stages)", 3)
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
                    alphas=(0.0,), dtype=dtype)
    if shape_cfg.kind not in ("prefill", "train"):
        raise ValueError(f"unknown shape kind {shape_cfg.kind!r}")
    if shape_cfg.kind == "train" and plan.offload:
        if plan.remat != "sppo":
            raise ValueError(f"offload with remat {plan.remat!r}: the offload moves the "
                             "tagged rows that remat 'sppo' saves (pass offload=False)")
        if plan.offload_mode != "explicit":
            raise ValueError(f"offload_mode {plan.offload_mode!r}: the port places the "
                             "rows itself ('explicit'); 'xla' is the reference's remat hint")
    # chunk boundaries on multiples of max(model_size, 128), as the
    # reference's pp == 1 plan
    S, B = shape_cfg.seq_len, shape_cfg.global_batch
    r = part.flops_per_token_ratio(cfg)
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
        if plan.partition == "flops":
            sched = part.partition_profile(
                profile, plan.n_chunks, multiple=128,
                doc_bounds=part.aligned_doc_bounds(row_lens, S))
        else:
            sched = part.partition(S, plan.n_chunks, cfg, plan.partition, multiple=128)
        # the profile sums over the rows; α wants one row's share
        costs = [c / max(1, B) for c in part.profile_chunk_costs(profile, sched)]
    else:
        sched = part.partition(S, plan.n_chunks, cfg, plan.partition, multiple=128)
        costs = part.chunk_costs(sched, r)
    # sequence-aware offload ratios from the cost model (§5.2)
    scale = (6 * cm.count_active_params(mdef) * B * S
             / sum(costs) / (plan.sp * plan.pp * cm.H100.peak_flops_bf16))
    times = [c * scale / (1.0 + cm.BWD_RATIO) for c in costs]
    acts = cm.chunk_act_bytes(cfg, sched.lengths, batch=max(1, B // plan.dp),
                              pp=plan.pp, sp=plan.sp, grad_accum=plan.grad_accum)
    # compressed rows cross the link at wire_ratio of their bytes: α is
    # planned at the effective rate of raw bytes (DESIGN.md §14)
    bw_eff = cm.H100.d2h_bw / cm.offload_wire_ratio(plan.offload_dtype)
    alphas = ofl.sequence_aware_alphas(acts, times, bw_eff).alphas
    if not plan.offload:
        alphas = tuple(0.0 for _ in alphas)
    return Cell(mdef=mdef, plan=plan, shape=shape_cfg, sched=sched,
                alphas=alphas, dtype=dtype, doc_lens=doc_lens)


def _rope(cfg, q_pos):
    return L.rope_tables(q_pos, cfg.hd, cfg.rope_theta, cfg.rope_fraction)


def use_ahead_prefetch(plan: ParallelPlan, *, train: bool) -> bool:
    """Whether the chunks' reloads are issued one chunk ahead (DESIGN.md
    §12): only a differentiated run that offloads under remat "sppo" has a
    backward reload to place."""
    return (train and plan.offload and plan.offload_mode == "explicit"
            and plan.remat == "sppo" and plan.prefetch == "ahead")


def chunk_tag(cell: Cell, chunk: int, link):
    """What a training chunk's tag sites do with their rows (the
    reference's per-chunk tag): split at the chunk's α and send the off rows
    through ``link`` where the plan offloads, else None (every tagged row
    stays on the device)."""
    if not cell.plan.offload:
        return None
    return ofl.ChunkOffload(chunk=chunk, alpha=cell.alphas[chunk], link=link,
                            codec=cell.plan.offload_dtype)


class _LinkDrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, loss, link, chunk):
        ctx.link, ctx.chunk = link, chunk
        return loss.view_as(loss)

    @staticmethod
    def backward(ctx, grad):
        ctx.link.prefetch(ctx.chunk)
        return grad, None, None


def link_drain(loss, link, last: int):
    """Identity on the loss whose backward issues the reload of the last
    chunk's rows, as soon as the backward pass starts: the last chunk has no
    later backward to hide it under (why ``reserve_last`` pins its α to 0)."""
    return _LinkDrain.apply(loss, link, last)


def run_pipeline(cell: Cell, stage_p, g, tokens, labels=None, *,
                 with_loss: bool = False, doc_start=None):
    """The pp == 1 chunk loop.  tokens, labels: [B, S] int.  ``doc_start``:
    optional [B, S] int32 start of each token's document in a packed batch
    (``PAD_START`` on padding), sliced chunk by chunk into the attention's
    window (``ChunkMeta.q_start``), so documents never attend across their
    boundaries.  With
    ``with_loss`` each chunk adds its head loss over the tokens whose label
    is >= 0 (the label sentinel: a negative label carries zero weight), and
    the caches keep every chunk's K/V for the backward; where a gradient is
    wanted, each chunk's stack runs through its seam under the plan's remat
    policy and offload.  Returns dict(loss, denom, state, last_x, link);
    loss and denom are None without ``with_loss``, link (the step's host
    rows, ``core/offload.py::Link``) None where nothing offloads."""
    mdef, plan = cell.mdef, cell.plan
    dev = tokens.device
    state = mdef.init_state(tokens.shape[0], cell.cache_loc, cell.dtype, dev,
                            train=with_loss)
    train = with_loss and torch.is_grad_enabled()
    ahead = use_ahead_prefetch(plan, train=train)
    link = ofl.Link(ahead=ahead) if train and plan.offload else None
    loss = denom = x = None
    for c, (off, ln) in enumerate(zip(cell.sched.offsets, cell.sched.lengths)):
        q_pos = off + torch.arange(ln, dtype=torch.int32, device=dev)
        x = mdef.embed(g, tokens[:, off:off + ln])
        q_start = None if doc_start is None else doc_start[:, off:off + ln]
        meta = ChunkMeta(q_pos=q_pos, cache_off=off, kv_view=off + ln,
                         rope=_rope(cell.cfg, q_pos), q_start=q_start)
        if train:
            # the chunk's seam (the reference's prefetch_chunk): its backward
            # takes the chunk's reloaded rows from the link and, under
            # "ahead", first issues the reload of the chunk before it
            x, state = mdef.stage_apply(stage_p, state, x, meta, remat=plan.remat,
                                        offload=chunk_tag(cell, c, link))
        else:
            x, state = mdef.stage_apply(stage_p, state, x, meta)
        if with_loss:
            lab = labels[:, off:off + ln]
            ls, cnt = mdef.head_loss(g, x, lab, (lab >= 0).float())
            loss = ls if loss is None else loss + ls
            denom = cnt if denom is None else denom + cnt
    if ahead:
        loss = link_drain(loss, link, cell.sched.n - 1)
    return dict(loss=loss, denom=denom, state=state, last_x=x, link=link)


def make_prefill_step(cell: Cell):
    def prefill_step(params, tokens):
        """tokens: [B, S] int; returns (per-slot caches, last chunk's hidden)."""
        out = run_pipeline(cell, params["stages"], params["globals"], tokens)
        return out["state"], out["last_x"]

    return prefill_step


def trainable(path: str) -> bool:
    """Every parameter is trained except the slot gate, a structural
    constant (the reference stops its gradient)."""
    return not path.endswith("gate")


def loss_and_grads(cell: Cell, params, tokens, labels, doc_start=None):
    """The loss ``sum / max(count, 1)`` of the chunked pipeline and its
    gradients, a tree like ``params`` (zeros for the gate).

    With ``plan.grad_accum = A > 1`` the batch is cut into A microbatches of
    B / A rows, each run forward and backward on its own; the loss and the
    gradients are the means over them, the gradients summed in fp32, as in
    the reference's accumulation scan.  With A = 1 the gradients come in
    the parameters' dtypes.  ``doc_start`` (a packed batch's [B, S] document
    starts) is split as the tokens are and reaches the attention only in a
    varlen cell (``cell.varlen``), as in the reference."""
    if not cell.varlen:
        doc_start = None

    def one(tok, lab, ds):
        # detached aliases: the caller's tensors are not touched
        alias = tree.map_(lambda t: t.detach(), params)
        leaves = [t.requires_grad_() for p, t in tree.items(alias) if trainable(p)]
        with torch.enable_grad():
            out = run_pipeline(cell, alias["stages"], alias["globals"], tok, lab,
                               with_loss=True, doc_start=ds)
            loss = out["loss"] / out["denom"].clamp_min(1.0)
            grads = iter(torch.autograd.grad(loss, leaves))
        flat = [next(grads) if trainable(p) else torch.zeros_like(t)
                for p, t in tree.items(params)]
        return loss.detach(), flat

    A = cell.plan.grad_accum
    if A > 1:
        B = tokens.shape[0]
        if B % A:
            raise ValueError(f"batch {B} does not split into {A} microbatches")
        bm = B // A
        loss, gsum = None, None
        for a in range(A):
            rows = slice(a * bm, (a + 1) * bm)
            l, flat = one(tokens[rows], labels[rows],
                          None if doc_start is None else doc_start[rows])
            if gsum is None:
                loss, gsum = l, [g.float() for g in flat]
            else:
                loss = loss + l
                for acc, g in zip(gsum, flat):
                    acc.add_(g.float())
        loss, flat = loss / A, [g / A for g in gsum]
    else:
        loss, flat = one(tokens, labels, doc_start)
    it = iter(flat)
    return loss, tree.map_(lambda _: next(it), params)


def make_train_step(cell: Cell, *, lr_kwargs=None):
    """Build the training step: loss and gradients of the chunked pipeline,
    then one AdamW update (global-norm clip, cosine schedule) in place, its
    moments where the plan keeps them (``offload_moments``,
    ``moments_dtype``: ``opt_state`` from ``adamw.init_state`` with the
    same settings)."""
    from repro_torch.optim import adamw

    lr_kwargs = lr_kwargs or {}

    def train_step(params, opt_state, tokens, labels, doc_start=None):
        """tokens, labels (and a packed batch's doc_start): [B, S] int on the
        parameters' device.  Returns (params, opt_state, metrics); metrics
        hold tensors (loss, grad_norm, lr) that stay on the device until
        read."""
        loss, grads = loss_and_grads(cell, params, tokens, labels, doc_start)
        lr = adamw.cosine_lr(opt_state.step, **lr_kwargs)
        plan = cell.plan
        params, opt_state, met = adamw.apply_update(
            params, grads, opt_state, lr=lr, offload_moments=plan.offload_moments,
            moments_mode=plan.moments_mode, moments_dtype=plan.moments_dtype)
        met["loss"] = loss
        return params, opt_state, met

    return train_step


def max_decode_steps(cell: Cell) -> int:
    """Longest decode run the cache can absorb: token S + i lands at slot
    S + i, and the buffer holds DECODE_BUDGET slots past S."""
    return DECODE_BUDGET * cell.plan.sp


def make_serve_step(cell: Cell, *, decode_steps=None):
    """Build the static lock-step decode step.  ``decode_steps``, when
    given, is checked against the cache's decode budget up front."""
    if decode_steps is not None and decode_steps > max_decode_steps(cell):
        raise ValueError(
            f"decode_steps={decode_steps} exceeds the cache's decode budget "
            f"of {max_decode_steps(cell)} steps (DECODE_BUDGET={DECODE_BUDGET}"
            f" slots x sp={cell.plan.sp})")
    S = cell.shape.seq_len
    mdef = cell.mdef

    def serve_step(params, state, tokens, pos: int):
        """tokens: [B, 1] int at global position ``pos``; returns
        (state, next tokens [B, 1] int32, greedy)."""
        if not S <= pos < cell.cache_loc:
            raise ValueError(f"decode position {pos} outside the cache's "
                             f"decode slots [{S}, {cell.cache_loc})")
        g = params["globals"]
        q_pos = torch.full((1,), pos, dtype=torch.int32, device=tokens.device)
        # at sp = 1 token S + i is written at slot S + i: the slot is the position
        meta = ChunkMeta(q_pos=q_pos, cache_off=pos, kv_view=None,
                         rope=_rope(cell.cfg, q_pos))
        x = mdef.embed(g, tokens)
        x, state = mdef.stage_apply(params["stages"], state, x, meta)
        logits = mdef.head_logits(g, x)
        return state, logits.argmax(dim=-1).to(torch.int32)

    return serve_step
