"""Serving (port of ``repro/launch/serve.py``): static lock-step decode and
the continuous-batching engine, on one device or a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --prompt-len 2048 --batch 4 --decode-steps 32

  PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu \
      --prompt-len 128 --batch 4 --decode-steps 8 --continuous

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v3-671b \
      --layers 2 --prompt-len 2048 --batch 4 --decode-steps 32

  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
      --prompt-len 2048 --batch 4 --decode-steps 32 --sync-debug error

  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --reduced --device cpu --prompt-len 128 --batch 2 --decode-steps 4

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --reduced --device cpu --mesh 1x2 --prompt-len 128 --batch 2 --decode-steps 4

Two entry points over the same step functions (``parallel/runner.py``), as in
the reference:

- the **static** path (``main``): one chunked prefill of a fixed batch of
  random prompts, then lock-step greedy ``serve_step`` decode, every request
  the same length with a private cache row of maximum length.  ``--repeats
  N`` serves the same batch N times over and times each run: the first run
  in a process pays one-time costs (library heuristics, allocator growth)
  that the later ones do not;
- ``ServeEngine`` (``--continuous``): a request-level scheduler over the
  paged KV pool (``runtime/kvpool.py``, DESIGN.md §16): prompts
  right-aligned into a fixed bucket, a block table a request, admission
  into freed slots mid-flight, and a decode loop that never reads a device
  value on the host (sampled tokens feed back device to device; each
  step's host state goes down in one pinned buffer of its own; the tokens
  are demuxed once at the end).  ``mode="static"`` runs the same engine
  with admission barriered on an empty pool, the lock-step baseline; the
  token streams are bitwise the same, since no row's compute depends on
  the other rows.

A cross-attention model (llama-3.2-vision-11b, whisper-tiny) prefills
with a stub context, the reference's: standard normal x 0.02 patch or frame
embeddings from the prompts' generator, in the model's dtype; its prefill
encodes it (whisper) and projects each slot's K/V once, and decode reads
them from the state.  The paged engine refuses both families.
Weights are random, drawn on the device from a seed.  It runs on the CUDA
card; ``--device cpu`` runs the plain path on the CPU instead.  Under
``torchrun --nproc-per-node D*M``, ``--mesh DxM`` serves on D data ranks
(``--pp P`` pipeline stages of D / P dp groups, static path only) times M
model ranks (the sequence-sharded cache), as ``launch/train.py`` trains;
the process group runs NCCL on the card (a card per rank) and gloo with
``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.model_zoo import build_model, shard_params
from repro_torch.parallel.ctx import make_ctx
from repro_torch.parallel.runner import (make_pool_ingest, make_pool_serve_step,
                                         make_pool_state, make_prefill_step,
                                         make_serve_step, resolve_cell)
from repro_torch.runtime import kvpool

log = logging.getLogger("repro_torch.serve")


def shard_rows(arr: np.ndarray, dp: int, pp: int) -> np.ndarray:
    """[batch, ...] -> [1, dp*pp, b_loc, ...]: the decode batch layout.

    Data row i belongs to dp group i // pp; every stage row of a group
    carries the group's batch shard.  Exact: batch must divide by dp.
    """
    batch = arr.shape[0]
    if batch % dp != 0:
        raise ValueError(
            f"batch {batch} does not divide by dp {dp}: the per-shard rows "
            "would truncate or duplicate requests")
    b_loc = batch // dp
    rows = np.stack([arr[(i // pp) * b_loc:(i // pp + 1) * b_loc]
                     for i in range(dp * pp)])
    return rows[None]


def gather_decode_tokens(nxt: np.ndarray, dp: int, pp: int,
                         batch: int) -> np.ndarray:
    """[dp*pp, b_loc, 1] serve_step output -> [batch] tokens, shape-exact.

    Inverse of ``shard_rows``: each dp group's stage rows once, in group
    order.  Raises when the shapes disagree.
    """
    n_rows, b_loc = nxt.shape[0], nxt.shape[1]
    if n_rows != dp * pp:
        raise ValueError(f"expected {dp * pp} data rows, got {n_rows}")
    if b_loc * dp != batch:
        raise ValueError(
            f"{dp} groups x {b_loc} rows/group = {dp * b_loc} requests, "
            f"caller expects {batch}")
    return np.concatenate([nxt[g * pp + (pp - 1), :, 0] for g in range(dp)])


def resolve_device(name: str) -> torch.device:
    """The run's device.  A CUDA request with no card fails: the port never
    carries on quietly on the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; the port runs on the "
                           "card (pass --device cpu for the plain CPU path)")
    return dev


def build_params(cell, device="cuda", seed: int = 0, stage: int = 0, model_rank: int = 0):
    """Initialize the cell's parameters on ``device`` from ``seed``: pipeline
    stage ``stage`` of the plan's pp (the same tensors for its layers as pp =
    1 draws) and the globals; at sp > 1 model rank ``model_rank``'s shard
    of them (``model_zoo.shard_params``: drawn whole, then sliced)."""
    device = resolve_device(str(device))
    gen = torch.Generator(device=device).manual_seed(seed)
    mdef = cell.mdef
    params = {"stages": mdef.init_stage_params(gen, cell.dtype, device, stage=stage,
                                               pp=cell.plan.pp),
              "globals": mdef.init_globals(gen, cell.dtype, device)}
    return shard_params(params, mdef, cell.plan.sp, model_rank)


def _push(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array onto ``dev`` without a host sync: on the card through a
    pinned buffer of its own, copied with ``non_blocking``.  PyTorch's
    caching host allocator hands the buffer out again only once the copy
    that read it has run, so a buffer is never rewritten in flight."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


# ---------------------------------------------------------------------------
# Continuous-batching engine
# ---------------------------------------------------------------------------


@dataclass
class Request:
    """One decode request: token prompt and a fixed decode length.

    ``arrival`` is the earliest engine step the request may be admitted at
    (0 = present from the start).  Completion is by fixed length, as in the
    reference (an EOS exit would need a host read of the sampled token)."""

    rid: int
    prompt: np.ndarray
    max_new: int
    arrival: int = 0


@dataclass
class RunStats:
    """Host-side accounting of one ``ServeEngine.run``."""

    steps: int = 0              # decode steps launched
    waves: int = 0              # admission waves (each one prefill)
    wall_s: float = 0.0         # the loop's wall time, the final demux included
    pool_bytes: int = 0         # measured pool bytes on this rank (the sink included)
    spans: Dict[int, Tuple[int, int]] = field(default_factory=dict)
    peak_blocks: List[int] = field(default_factory=list)   # per data shard
    total_blocks: List[int] = field(default_factory=list)  # per data shard


class ServeEngine:
    """Request-level continuous-batching scheduler over the paged KV pool
    (reference ``ServeEngine``).

    Fixed geometry per engine: ``slots`` request slots per data shard, a
    ``s_bucket``-token right-aligned prompt bucket and a ``max_new`` decode
    budget.  Admission allocates a request's blocks wholesale and prefills
    the wave's prompts in the batch rows of their target slots (identity
    ingest); completion returns the blocks.  ``mesh`` = (data, model) ranks
    (pp = 1): each rank holds its data shard's slots and its model shard of
    the pool, and runs the same host scheduler over every shard (SPMD: each
    host decision comes from the requests, which every rank holds), pushing
    its own shard's rows.  Over several ranks the process group must be
    initialised (``launch.mesh``).  ``params``: this rank's (its model shard
    at sp > 1), else drawn from seed 0 (``build_params``)."""

    def __init__(self, cfg, mesh=(1, 1), *, s_bucket: int, slots: int, max_new: int,
                 block_tokens: int = 8, n_blocks: Optional[int] = None,
                 admit_min_free: int = 2, params=None, device="cuda",
                 dtype=torch.bfloat16):
        self.mdef = build_model(cfg)
        self.cfg = self.mdef.cfg
        self.device = resolve_device(str(device))
        self.data_size, self.model_size = mesh
        self.slots = slots
        self.admit_min_free = admit_min_free
        kg = slots * self.data_size
        ovr = dict(pp=1, dp=self.data_size)
        sizes = dict(data_size=self.data_size, model_size=self.model_size, dtype=dtype)
        self.pre_cell = resolve_cell(
            self.mdef, ShapeConfig("engine_prefill", s_bucket, kg, "prefill"),
            overrides=dict(n_chunks=max(1, s_bucket // 64), offload=False, remat="none",
                           **ovr), **sizes)
        self.dec_cell = resolve_cell(
            self.mdef, ShapeConfig("engine_decode", s_bucket, kg, "decode"),
            overrides=ovr, **sizes)
        dec_loc = -(-max_new // self.model_size)
        l_loc = s_bucket // self.model_size + dec_loc
        max_blocks = -(-l_loc // block_tokens)
        self.geo = kvpool.PoolGeometry(
            s_bucket=s_bucket, sp=self.model_size, max_new=max_new,
            block_tokens=block_tokens,
            n_blocks=slots * max_blocks if n_blocks is None else n_blocks,
            n_slots=slots)
        self.pos_map = kvpool.pos_map(self.geo, self.pre_cell.sched)
        self.ctx = make_ctx(self.dec_cell.plan, device=self.device)
        if params is None:
            params = build_params(self.pre_cell, self.device,
                                  model_rank=self.ctx.model_index())
        self.params = params
        self._prefill = make_prefill_step(self.pre_cell, self.ctx)
        self._ingest = make_pool_ingest(self.pre_cell, self.geo)
        self._step = make_pool_serve_step(self.dec_cell, self.geo, self.pos_map,
                                          ctx=self.ctx, device=self.device)

    def predicted_pool_bytes(self) -> int:
        """The closed form of one rank's pool bytes: the cost model's
        ``kv_pool_bytes`` plus the sink (``kvpool.device_pool_bytes``)."""
        itemsize = torch.empty((), dtype=self.dec_cell.dtype).element_size()
        return kvpool.device_pool_bytes(self.geo, self.cfg, self.mdef.slots_per_stage(1),
                                        itemsize)

    def run(self, requests: Sequence[Request], mode: str = "continuous", *,
            sync_debug=None) -> Tuple[Dict[int, np.ndarray], RunStats]:
        """Decode every request; returns ({rid: tokens}, stats), the same on
        every rank.

        ``mode="continuous"``: admit into freed slots mid-flight whenever at
        least ``admit_min_free`` slots are free (or the engine is idle).
        ``mode="static"``: admit only when *all* slots are free, the
        lock-step baseline.  Token streams are identical across modes.
        ``sync_debug`` ("warn" or "error", on the card): the decode loop
        runs under ``torch.cuda.set_sync_debug_mode(sync_debug)``, which
        reports every call that would make the host wait for the card; the
        mode is restored before the demux."""
        if mode not in ("continuous", "static"):
            raise ValueError(f"mode {mode!r}: expected 'continuous' or 'static'")
        geo, d_size, k_slots, dev = self.geo, self.data_size, self.slots, self.device
        for r in requests:
            if not 1 <= len(r.prompt) <= geo.s_bucket:
                raise ValueError(f"request {r.rid}: prompt length {len(r.prompt)} not in "
                                 f"[1, {geo.s_bucket}]")
            if not 1 <= r.max_new <= geo.max_new:
                raise ValueError(f"request {r.rid}: max_new {r.max_new} not in "
                                 f"[1, {geo.max_new}]")
        me = self.ctx.dp_index()
        queue = sorted(requests, key=lambda r: (r.arrival, r.rid))
        pools = [kvpool.BlockPool(geo.n_blocks) for _ in range(d_size)]
        active: Dict[Tuple[int, int], dict] = {}
        qp = np.zeros((d_size, k_slots), np.int32)
        btab = np.full((d_size, k_slots, geo.max_blocks), -1, np.int32)
        mb = geo.max_blocks
        pool = make_pool_state(self.dec_cell, geo, dev)
        tokens = torch.zeros((k_slots, 1), dtype=torch.int32, device=dev)
        handles, traces = [], []
        stats = RunStats(pool_bytes=sum(t.numel() * t.element_size()
                                        for s in pool for t in s["kv"]))
        t0 = time.time()
        if sync_debug is not None:
            torch.cuda.set_sync_debug_mode(sync_debug)
        try:
            t = qi = 0
            while qi < len(queue) or active:
                if qi < len(queue) and not active and queue[qi].arrival > t:
                    t = queue[qi].arrival  # idle gap: jump to the next arrival
                free = [(d, k) for d in range(d_size) for k in range(k_slots)
                        if (d, k) not in active]
                n_avail = 0
                while qi + n_avail < len(queue) and queue[qi + n_avail].arrival <= t:
                    n_avail += 1
                gate = (not active) if mode == "static" else (
                    not active or len(free) >= self.admit_min_free)
                admit = np.zeros((d_size, k_slots), bool)
                atok = np.zeros((d_size, k_slots), np.int32)
                prompt_rows = None
                if n_avail and free and gate:
                    prompt_rows = np.zeros((d_size, k_slots, geo.s_bucket), np.int32)
                    for (d, k) in free[:n_avail]:
                        r = queue[qi]
                        qi += 1
                        blocks = pools[d].alloc(geo.blocks_for(r.max_new))
                        btab[d, k] = kvpool.block_table_row(geo, blocks)
                        p = np.asarray(r.prompt, np.int32)
                        prompt_rows[d, k, geo.s_bucket - len(p):] = p
                        admit[d, k] = True
                        atok[d, k] = p[-1]
                        qp[d, k] = geo.s_bucket
                        active[(d, k)] = dict(rid=r.rid, left=r.max_new, emitted=0,
                                              blocks=blocks)
                        stats.spans[r.rid] = (t, -1)
                # this rank's rows of the step's host state, one buffer:
                # [btab | q_pos | admit | admit_tok]
                host = _push(np.concatenate([btab[me], qp[me][:, None],
                                             admit[me][:, None].astype(np.int32),
                                             atok[me][:, None]], axis=1), dev)
                step_btab, step_qp = host[:, :mb], host[:, mb]
                step_admit, step_atok = host[:, mb + 1].bool(), host[:, mb + 2:]
                if prompt_rows is not None:
                    state_pre, _ = self._prefill(self.params, _push(prompt_rows[me], dev))
                    pool = self._ingest(state_pre, pool, step_btab, step_admit)
                    del state_pre
                    stats.waves += 1
                pool, tokens = self._step(self.params, pool, tokens, step_qp, step_btab,
                                          step_admit, step_atok)
                handles.append(tokens)
                traces.append([(d, k, st["rid"], st["emitted"])
                               for (d, k), st in active.items()])
                stats.steps += 1
                for (d, k) in list(active):
                    st = active[(d, k)]
                    st["emitted"] += 1
                    st["left"] -= 1
                    qp[d, k] += 1
                    if st["left"] == 0:
                        pools[d].free(st["blocks"])
                        btab[d, k] = -1
                        qp[d, k] = 0
                        stats.spans[st["rid"]] = (stats.spans[st["rid"]][0], t + 1)
                        del active[(d, k)]
                t += 1
        finally:
            if sync_debug is not None:
                torch.cuda.set_sync_debug_mode(0)
        out = {r.rid: np.zeros(r.max_new, np.int32) for r in requests}
        if handles:
            # the single demux: every data shard's tokens, [D, steps, K, 1]
            arr = self.ctx.all_gather_data(torch.stack(handles)).cpu().numpy()
            for step, emits in enumerate(traces):
                for d, k, rid, i in emits:
                    out[rid][i] = arr[d, step, k, 0]
        stats.wall_s = time.time() - t0
        stats.peak_blocks = [p.peak_used for p in pools]
        stats.total_blocks = [p.total_allocated for p in pools]
        return out, stats


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve the model's first N layers: a full-width model cut in depth "
                         "to fit the card (deepseek-v3-671b: 2 of its 61)")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL ranks, the torchrun world DATA x MODEL, e.g. 1x2")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline stages of the data axis (dp = DATA / pp; static path)")
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--continuous", action="store_true",
                    help="decode through the paged-pool ServeEngine instead of the static "
                         "lock-step path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=1,
                    help="serve the batch this many times, timing each run")
    ap.add_argument("--sync-debug", default=None, choices=["warn", "error"],
                    help="on the card, run the static decode loop under "
                         "torch.cuda.set_sync_debug_mode: report (or refuse) every call "
                         "that makes the host wait for the card")
    return ap


def _start_ranks(ap, args, data: int, model: int) -> torch.device:
    """The process group of a multi-rank launch (NCCL on the card, gloo on
    the CPU, as ``launch/train.py`` starts it); returns this rank's device."""
    import torch.distributed as dist

    device = resolve_device(args.device)
    if data * model == 1:
        return device
    if not dist.is_initialized():
        if "RANK" not in os.environ:
            ap.error("--mesh over several ranks: run under torchrun --nproc-per-node "
                     "DATA*MODEL")
        backend = "nccl" if device.type == "cuda" else "gloo"
        _, _, device = mesh_mod.init_from_env(backend, device)
    if dist.get_world_size() != data * model:
        ap.error(f"--mesh {args.mesh}: {data} x {model} ranks, but the process group has "
                 f"{dist.get_world_size()}")
    return device


def main(argv=None):
    """Serve ``--repeats`` times.  Returns a dict with the last run's
    decoded tokens ``[batch, decode_steps]`` (every request's, on every
    rank) and this rank's prefill last hidden state (static path), the
    prefill and decode wall times of every run (seconds, the device
    synchronized; ``prefill_s`` / ``decode_s`` are the last run's) and the
    CUDA peak of allocated bytes (None on the CPU); with ``--continuous``
    the engine's ``RunStats`` of each run in ``stats``."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.repeats < 1:
        raise ValueError(f"--repeats must be >= 1, got {args.repeats}")
    try:
        data, model = mesh_mod.parse_mesh(args.mesh)
    except ValueError as err:
        ap.error(str(err))
    pp = args.pp
    if pp < 1 or data % pp:
        raise ValueError(f"--pp {pp} does not divide the {data} data ranks")
    if args.continuous and pp > 1:
        raise ValueError("--continuous serves at pp = 1 (the paged pool's limit)")
    dp = data // pp
    B, S = args.batch, args.prompt_len
    if B % dp:
        raise ValueError(f"batch {B} does not divide by dp {dp}: the per-shard rows would "
                         "truncate or duplicate requests")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    dev = _start_ranks(ap, args, data, model)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.n_layers:
            ap.error(f"--layers {args.layers}: {cfg.name} has {cfg.n_layers} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mdef = build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    if args.continuous:
        eng = ServeEngine(cfg, (data, model), s_bucket=S, slots=B // data,
                          max_new=args.decode_steps, device=dev)
        reqs = [Request(rid=i, prompt=prompts[i], max_new=args.decode_steps)
                for i in range(B)]
        runs = []
        for run in range(args.repeats):
            toks, stats = eng.run(reqs, mode="continuous")
            runs.append(stats)
            log.info("run %d: continuous, %d steps, %d waves in %.4fs", run, stats.steps,
                     stats.waves, stats.wall_s)
        out = np.stack([toks[i] for i in range(B)])
        log.info("decoded %s tokens/seq; sample row: %s", out.shape[1], out[0][:16])
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        return {"tokens": out, "stats": runs, "decode_s": runs[-1].wall_s,
                "decode_s_runs": [r.wall_s for r in runs], "peak_bytes": peak}

    sizes = dict(data_size=data, model_size=model)
    pre_cell = resolve_cell(mdef, ShapeConfig("cli_prefill", S, B, "prefill"),
                            overrides=dict(pp=pp, dp=dp, n_chunks=max(1, S // 64),
                                           offload=False, remat="none"), **sizes)
    dec_cell = resolve_cell(mdef, ShapeConfig("cli_decode", S, B, "decode"),
                            overrides=dict(pp=pp, dp=dp), **sizes)
    # prefill builds the cache decode reads: the geometries must agree
    if pre_cell.cache_loc != dec_cell.cache_loc:
        raise ValueError(f"prefill cache_loc {pre_cell.cache_loc} != decode "
                         f"cache_loc {dec_cell.cache_loc}")
    ctx = make_ctx(dec_cell.plan, device=dev)
    params = build_params(pre_cell, dev, stage=ctx.stage_index(), model_rank=ctx.model_index())
    prefill = make_prefill_step(pre_cell, ctx)
    serve = make_serve_step(dec_cell, decode_steps=args.decode_steps, ctx=ctx)
    row = ctx.data_index()
    tokens = torch.from_numpy(shard_rows(prompts, dp, pp)[0, row]).to(dev)
    context = None
    if cfg.cross_attn is not None:
        # the reference's stub frontend (serve.py:389-395), after the prompts
        stub = rng.standard_normal((1, data, pre_cell.b_loc, mdef.n_context(), cfg.d_model))
        context = torch.from_numpy(stub[0, row] * 0.02).to(dev, pre_cell.dtype)
    # step 0 re-feeds the last prompt token at position S
    last = torch.from_numpy(shard_rows(prompts[:, -1:], dp, pp)[0, row]).to(dev)
    prefill_s, decode_s = [], []
    for run in range(args.repeats):
        state = None  # the previous run's cache is freed before the next prefill
        sync()
        t0 = time.perf_counter()
        state, last_hidden = prefill(params, tokens, context)
        sync()
        prefill_s.append(time.perf_counter() - t0)
        log.info("run %d: prefill %d tokens x %d seqs in %d chunks: %.4fs "
                 "(%.1f tok/s)", run, S, B, pre_cell.sched.n, prefill_s[-1],
                 S * B / prefill_s[-1])

        # the sampled tokens feed back device to device, with no host sync
        # in the loop (at pp > 1 every stage holds the last stage's tokens)
        cur, handles = last, []
        t0 = time.perf_counter()
        if args.sync_debug and dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(args.sync_debug)
        try:
            for step in range(args.decode_steps):
                state, cur = serve(params, state, cur, S + step)
                handles.append(cur)
        finally:
            if args.sync_debug and dev.type == "cuda":
                torch.cuda.set_sync_debug_mode(0)
        sync()
        decode_s.append(time.perf_counter() - t0)
        if args.decode_steps:
            log.info("run %d: decode %d steps x %d seqs: %.4fs (%.3f ms/step, "
                     "%.1f tok/s)", run, args.decode_steps, B, decode_s[-1],
                     1e3 * decode_s[-1] / args.decode_steps,
                     B * args.decode_steps / decode_s[-1])
    # the one demux: every data rank's tokens [dp x pp, steps, b_loc, 1]
    out = np.zeros((B, 0), np.int32)
    if handles:
        rows = ctx.all_gather_data(torch.stack(handles)).cpu().numpy()
        out = np.stack([gather_decode_tokens(rows[:, i], dp, pp, B)
                        for i in range(args.decode_steps)], axis=1)
    log.info("decoded %s tokens/seq; sample row: %s", out.shape[1], out[0][:16])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return {"tokens": out, "last_hidden": last_hidden,
            "prefill_s": prefill_s[-1], "decode_s": decode_s[-1],
            "prefill_s_runs": prefill_s, "decode_s_runs": decode_s,
            "n_chunks": pre_cell.sched.n, "peak_bytes": peak}


if __name__ == "__main__":
    main()
