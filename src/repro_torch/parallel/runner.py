"""The serving engine at pp = sp = dp = 1 (port of ``repro/parallel/runner.py``).

Builds the two serving step functions of a cell:

  prefill_step(params, tokens)             -> (state, last_hidden)
  serve_step(params, state, tokens, pos)   -> (state, next_tokens)

Prefill runs the reference's pp == 1 pipeline branch: the prompt is split
into FLOPs-balanced chunks (core/partition.py); each chunk is embedded, runs
the layer stack (appending its K/V to the position-tagged cache and attending
a prefix view of it), and hands its hidden state on.  Decode feeds one token
per step and attends the whole cache buffer.  The reference's shard_map,
pipeline ticks and offload are the multi-rank and training slices' work.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ParallelPlan, ShapeConfig
from repro_torch.core import partition as part
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
        # prefill leaves room for the decode appends (same geometry, so a
        # prefill cache feeds serve_step directly)
        return (self.shape.seq_len + DECODE_BUDGET * self.plan.sp) // self.plan.sp


def resolve_cell(arch, shape_cfg: ShapeConfig, *, overrides=None,
                 dtype=torch.bfloat16) -> Cell:
    """Resolve a prefill or decode cell at data = model = 1."""
    mdef = arch if isinstance(arch, ModelDef) else build_model(arch)
    cfg = mdef.cfg
    plan = resolve_plan(cfg, shape_cfg, data_size=1, model_size=1,
                        overrides=overrides)
    if plan.pp != 1 or plan.offload:
        raise NotImplementedError(
            f"the port serves at pp = 1 without offload (pp={plan.pp}, "
            f"offload={plan.offload}); pass overrides=dict(offload=False)")
    if shape_cfg.kind == "decode":
        sched = part.ChunkSchedule((1,), (0,), 1, "decode")
    elif shape_cfg.kind == "prefill":
        # chunk boundaries on multiples of max(model_size, 128), as the
        # reference's pp == 1 plan
        sched = part.partition(shape_cfg.seq_len, plan.n_chunks, cfg,
                               plan.partition, multiple=128)
    else:
        raise NotImplementedError("train cells come with the training slice")
    return Cell(mdef=mdef, plan=plan, shape=shape_cfg, sched=sched,
                dtype=dtype)


def _rope(cfg, q_pos):
    return L.rope_tables(q_pos, cfg.hd, cfg.rope_theta, cfg.rope_fraction)


def run_pipeline(cell: Cell, stage_p, g, tokens):
    """The pp == 1 chunk loop without loss: returns (state, last hidden)."""
    mdef = cell.mdef
    dev = tokens.device
    state = mdef.init_state(tokens.shape[0], cell.cache_loc, cell.dtype, dev)
    x = None
    for off, ln in zip(cell.sched.offsets, cell.sched.lengths):
        q_pos = off + torch.arange(ln, dtype=torch.int32, device=dev)
        x = mdef.embed(g, tokens[:, off:off + ln])
        meta = ChunkMeta(q_pos=q_pos, cache_off=off, kv_view=off + ln,
                         rope=_rope(cell.cfg, q_pos))
        x, state = mdef.stage_apply(stage_p, state, x, meta)
    return state, x


def make_prefill_step(cell: Cell):
    def prefill_step(params, tokens):
        """tokens: [B, S] int; returns (per-slot caches, last chunk's hidden)."""
        return run_pipeline(cell, params["stages"], params["globals"], tokens)

    return prefill_step


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
