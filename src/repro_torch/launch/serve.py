"""Static serving CLI on one device (port of ``repro/launch/serve.py``'s static path).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
      --prompt-len 2048 --batch 4 --decode-steps 32

One chunked prefill of a fixed batch of random prompts, then lock-step
greedy decode.  Weights are random, drawn on the device from a seed.  It runs
on the CUDA card; ``--device cpu`` runs the plain path on the CPU instead.
``--repeats N`` serves the same batch N times over and times each run: the
first run in a process pays one-time costs (library heuristics, allocator
growth) that the later ones do not.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.models.model_zoo import build_model, shard_params
from repro_torch.parallel.runner import (make_prefill_step, make_serve_step,
                                         resolve_cell)

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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--repeats", type=int, default=1,
                    help="serve the batch this many times, timing each run")
    return ap


def main(argv=None):
    """Run the static serve path ``--repeats`` times.  Returns a dict with
    the last run's decoded tokens ``[batch, decode_steps]`` and prefill last
    hidden state, the prefill and decode wall times of every run (seconds,
    the device synchronized; ``prefill_s`` / ``decode_s`` are the last
    run's) and the CUDA peak of allocated bytes (None on the CPU)."""
    args = build_parser().parse_args(argv)
    if args.repeats < 1:
        raise ValueError(f"--repeats must be >= 1, got {args.repeats}")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mdef = build_model(cfg)
    S, B = args.prompt_len, args.batch

    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)

    pre_cell = resolve_cell(mdef, ShapeConfig("cli_prefill", S, B, "prefill"),
                            overrides=dict(pp=1, dp=1,
                                           n_chunks=max(1, S // 64),
                                           offload=False, remat="none"))
    dec_cell = resolve_cell(mdef, ShapeConfig("cli_decode", S, B, "decode"),
                            overrides=dict(pp=1, dp=1))
    # prefill builds the cache decode reads: the geometries must agree
    if pre_cell.cache_loc != dec_cell.cache_loc:
        raise ValueError(f"prefill cache_loc {pre_cell.cache_loc} != decode "
                         f"cache_loc {dec_cell.cache_loc}")
    dp, pp = dec_cell.plan.dp, dec_cell.plan.pp

    params = build_params(pre_cell, dev)
    prefill = make_prefill_step(pre_cell)
    serve = make_serve_step(dec_cell, decode_steps=args.decode_steps)
    tokens = torch.from_numpy(shard_rows(prompts, dp, pp)[0, 0]).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # step 0 re-feeds the last prompt token at position S
    last = torch.from_numpy(shard_rows(prompts[:, -1:], dp, pp)[0, 0]).to(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prefill_s, decode_s = [], []
    for run in range(args.repeats):
        state = None  # the previous run's cache is freed before the next prefill
        sync()
        t0 = time.perf_counter()
        state, last_hidden = prefill(params, tokens)
        sync()
        prefill_s.append(time.perf_counter() - t0)
        log.info("run %d: prefill %d tokens x %d seqs in %d chunks: %.4fs "
                 "(%.1f tok/s)", run, S, B, pre_cell.sched.n, prefill_s[-1],
                 S * B / prefill_s[-1])

        # the sampled tokens feed back device to device, with no host sync
        # in the loop
        cur, handles = last, []
        t0 = time.perf_counter()
        for step in range(args.decode_steps):
            state, cur = serve(params, state, cur, S + step)
            handles.append(cur)
        sync()
        decode_s.append(time.perf_counter() - t0)
        if args.decode_steps:
            log.info("run %d: decode %d steps x %d seqs: %.4fs (%.3f ms/step, "
                     "%.1f tok/s)", run, args.decode_steps, B, decode_s[-1],
                     1e3 * decode_s[-1] / args.decode_steps,
                     B * args.decode_steps / decode_s[-1])
    out = np.stack([gather_decode_tokens(h.cpu().numpy()[None], dp, pp, B)
                    for h in handles], axis=1)
    log.info("decoded %s tokens/seq; sample row: %s", out.shape[1], out[0][:16])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return {"tokens": out, "last_hidden": last_hidden,
            "prefill_s": prefill_s[-1], "decode_s": decode_s[-1],
            "prefill_s_runs": prefill_s, "decode_s_runs": decode_s,
            "n_chunks": pre_cell.sched.n, "peak_bytes": peak}


if __name__ == "__main__":
    main()
