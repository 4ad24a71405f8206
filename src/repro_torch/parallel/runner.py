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
whole cache buffer.  The reference's shard_map, pipeline ticks and executed
offload come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ParallelPlan, ShapeConfig
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
    dtype: torch.dtype = torch.bfloat16

    @property
    def cfg(self) -> ModelConfig:
        return self.mdef.cfg

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
                 dtype=torch.bfloat16) -> Cell:
    """Resolve a train, prefill or decode cell at data = model = 1, pp = 1,
    offload off.  A plan's remat policy other than "none" is refused where
    it would run (``transformer.stage_apply``)."""
    mdef = arch if isinstance(arch, ModelDef) else build_model(arch)
    cfg = mdef.cfg
    plan = resolve_plan(cfg, shape_cfg, data_size=1, model_size=1,
                        overrides=overrides)
    if plan.pp != 1:
        raise _later(f"pp = {plan.pp} (pipeline stages)", 8)
    if plan.offload:
        raise _later("executed activation offload (pass overrides="
                     "dict(offload=False))", 5)
    if plan.offload_moments or plan.offload_dtype != "none" or plan.moments_dtype != "none":
        raise _later("optimizer-moment offload and the offload codecs", 6)
    if shape_cfg.kind == "decode":
        sched = part.ChunkSchedule((1,), (0,), 1, "decode")
    elif shape_cfg.kind in ("prefill", "train"):
        # chunk boundaries on multiples of max(model_size, 128), as the
        # reference's pp == 1 plan
        sched = part.partition(shape_cfg.seq_len, plan.n_chunks, cfg,
                               plan.partition, multiple=128)
    else:
        raise ValueError(f"unknown shape kind {shape_cfg.kind!r}")
    return Cell(mdef=mdef, plan=plan, shape=shape_cfg, sched=sched,
                dtype=dtype)


def _rope(cfg, q_pos):
    return L.rope_tables(q_pos, cfg.hd, cfg.rope_theta, cfg.rope_fraction)


def run_pipeline(cell: Cell, stage_p, g, tokens, labels=None, *,
                 with_loss: bool = False):
    """The pp == 1 chunk loop.  tokens, labels: [B, S] int.  With
    ``with_loss`` each chunk adds its head loss over the tokens whose label
    is >= 0 (the label sentinel: a negative label carries zero weight), and
    the caches keep every chunk's K/V for the backward.  Returns dict(loss,
    denom, state, last_x); loss and denom are None without ``with_loss``."""
    mdef = cell.mdef
    dev = tokens.device
    state = mdef.init_state(tokens.shape[0], cell.cache_loc, cell.dtype, dev,
                            train=with_loss)
    loss = denom = x = None
    for off, ln in zip(cell.sched.offsets, cell.sched.lengths):
        q_pos = off + torch.arange(ln, dtype=torch.int32, device=dev)
        x = mdef.embed(g, tokens[:, off:off + ln])
        meta = ChunkMeta(q_pos=q_pos, cache_off=off, kv_view=off + ln,
                         rope=_rope(cell.cfg, q_pos))
        x, state = mdef.stage_apply(stage_p, state, x, meta,
                                    remat=cell.plan.remat)
        if with_loss:
            lab = labels[:, off:off + ln]
            ls, cnt = mdef.head_loss(g, x, lab, (lab >= 0).float())
            loss = ls if loss is None else loss + ls
            denom = cnt if denom is None else denom + cnt
    return dict(loss=loss, denom=denom, state=state, last_x=x)


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


def loss_and_grads(cell: Cell, params, tokens, labels):
    """The loss ``sum / max(count, 1)`` of the chunked pipeline and its
    gradients, a tree like ``params`` (zeros for the gate).

    With ``plan.grad_accum = A > 1`` the batch is cut into A microbatches of
    B / A rows, each run forward and backward on its own; the loss and the
    gradients are the means over them, the gradients summed in fp32, as in
    the reference's accumulation scan.  With A = 1 the gradients come in
    the parameters' dtypes."""
    def one(tok, lab):
        # detached aliases: the caller's tensors are not touched
        alias = tree.map_(lambda t: t.detach(), params)
        leaves = [t.requires_grad_() for p, t in tree.items(alias) if trainable(p)]
        with torch.enable_grad():
            out = run_pipeline(cell, alias["stages"], alias["globals"], tok, lab,
                               with_loss=True)
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
            l, flat = one(tokens[a * bm:(a + 1) * bm], labels[a * bm:(a + 1) * bm])
            if gsum is None:
                loss, gsum = l, [g.float() for g in flat]
            else:
                loss = loss + l
                for acc, g in zip(gsum, flat):
                    acc.add_(g.float())
        loss, flat = loss / A, [g / A for g in gsum]
    else:
        loss, flat = one(tokens, labels)
    it = iter(flat)
    return loss, tree.map_(lambda _: next(it), params)


def make_train_step(cell: Cell, *, lr_kwargs=None):
    """Build the training step: loss and gradients of the chunked pipeline,
    then one AdamW update (global-norm clip, cosine schedule) in place."""
    from repro_torch.optim import adamw

    lr_kwargs = lr_kwargs or {}

    def train_step(params, opt_state, tokens, labels):
        """tokens, labels: [B, S] int on the parameters' device.  Returns
        (params, opt_state, metrics); metrics hold tensors (loss, grad_norm,
        lr) that stay on the device until read."""
        loss, grads = loss_and_grads(cell, params, tokens, labels)
        lr = adamw.cosine_lr(opt_state.step, **lr_kwargs)
        params, opt_state, met = adamw.apply_update(params, grads, opt_state,
                                                    lr=lr)
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
