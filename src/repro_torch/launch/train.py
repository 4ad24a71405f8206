"""Training CLI on one device (port of ``repro/launch/train.py`` at pp = 1).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
      --reduced --steps 12 --seq 256 --batch 8 --device cpu

SPPO's chunked pipeline at pp = sp = dp = 1 under the reference's default
training plan: remat "sppo", sequence-aware activation offload to pinned
host memory, each chunk's rows reloaded one chunk ahead of its backward
(DESIGN.md §5, §10, §12).  ``--no-offload`` keeps every tagged row on the
device (remat "sppo" still); ``--prefetch sync`` reloads each chunk's rows at
its own backward; ``--offload-dtype fp8|int8`` sends them compressed
(DESIGN.md §14).  AdamW with fp32 moments on the device, or with
``--offload-moments`` in pinned host memory (DESIGN.md §11; qwen2-7b's 28
layers need 61.1 GB of it, 15.3 GB under ``--moments-dtype fp8|int8``);
``--moments-mode`` takes "explicit" alone.  The reference's synthetic token
stream, and TGS / MFU metering on the H100's peak.  Weights are random,
drawn on the device from a seed.  It runs on the CUDA card; ``--device
cpu`` runs the plain path on the CPU instead (the "host" copies are then
CPU clones).

The reference CLI's other flags belong to later slices of the port and are
refused with the ROADMAP item that brings them.  ``train(cfg, ...)`` is the
body, for callers that pass a config of their own (a depth-cut model), plan
overrides (chip_smoke.py's ablations) or a packed variable-length batch
(``packed=``, DESIGN.md §13; the reference's CLI has no flag for one
either).
"""
from __future__ import annotations

import argparse
import contextlib
import logging

import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import tree
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.serve import build_params, resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.parallel.runner import make_train_step, resolve_cell
from repro_torch.runtime.metrics import Meter

log = logging.getLogger("repro_torch.train")

# flag -> (what it asks for, ROADMAP Queue 1 item that ports it)
LATER = {
    "mesh": ("a device mesh beyond 1x1", 3),
    "pp": ("pipeline stages (pp > 1)", 3),
    "attn_mode": ("sequence-parallel attention schedules", 3),
    "msp": ("multiplexed sequence partitioning (pp > 1)", 3),
    "msp_split": ("multiplexed sequence partitioning (pp > 1)", 3),
    "audit": ("the trace-time contract auditor", 7),
    "ckpt_dir": ("checkpointing", 7),
    "ckpt_every": ("checkpointing", 7),
    "resume": ("checkpointing", 7),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--n-chunks", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-offload", action="store_true",
                    help="keep every tagged activation row on the device")
    ap.add_argument("--prefetch", default=None, choices=["ahead", "sync"],
                    help="backward reload placement (DESIGN.md §12): ahead = "
                         "each chunk's rows reloaded during the next chunk's "
                         "backward (default); sync = at its own backward")
    ap.add_argument("--offload-dtype", default=None, choices=["none", "fp8", "int8"],
                    help="codec of the offloaded activation rows (DESIGN.md §14)")
    ap.add_argument("--offload-moments", action="store_true",
                    help="AdamW's moments in pinned host memory (DESIGN.md §11)")
    ap.add_argument("--moments-mode", default=None, choices=["explicit", "xla"],
                    help="explicit: one H2D and one D2H a moment leaf (the port's "
                         "only form; 'xla' is refused)")
    ap.add_argument("--moments-dtype", default=None, choices=["none", "fp8", "int8"],
                    help="codec of the host moments (needs --offload-moments)")
    # the reference CLI's flags of later slices: refused when given
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--pp", type=int, default=None)
    ap.add_argument("--attn-mode", default=None)
    ap.add_argument("--msp", action="store_true", default=None)
    ap.add_argument("--msp-split", type=int, default=None)
    ap.add_argument("--audit", action="store_true", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--resume", default=None)
    return ap


def _refuse_later_flags(ap, args):
    for dest, (what, item) in LATER.items():
        val = getattr(args, dest)
        # the single-device values of the reference's flags are what runs here
        if val is None or (dest == "mesh" and val == "1x1") or (dest == "pp" and val == 1):
            continue
        ap.error(f"--{dest.replace('_', '-')}: {what} comes with a later slice "
                 f"of the port (ROADMAP Queue 1, item {item})")


def train(cfg, *, steps: int, seq: int, batch: int, n_chunks=None,
          lr: float = 3e-4, log_every: int = 10, metrics_out=None,
          device="cuda", overrides=None, on_step=None, step_context=None,
          packed=None):
    """Train ``cfg`` for ``steps`` steps on ``device``.

    ``packed``, where given, is a ``data.pipeline.PackedBatch`` of ``batch``
    rows of ``seq`` tokens (``pack_documents``, or ``pad_to_max``'s one
    document a row), trained on at every step in place of the synthetic
    stream: the cell is resolved with its documents' lengths
    (``resolve_cell(doc_lens=)``) and its ``doc_start`` windows the
    attention.

    ``overrides`` replace fields of the resolved plan (the reference's
    defaults: offload on, remat "sppo", prefetch "ahead"), e.g.
    ``dict(offload=False, remat="none")``.  ``on_step(step, record)``, when
    given, is called after each step, the device synchronized;
    ``step_context(step)``, when given, returns a context manager wrapped
    around that step (a profiler, say).  Returns dict(history: the meter's
    per-step records (loss, dt seconds, tgs tokens/s per chip, mfu), cell
    (its ``alphas`` the deployed offload ratios), n_active_params,
    peak_bytes: the CUDA peak of allocated bytes over the steps, base_bytes:
    the allocated bytes before the first step (weights, and the moments
    where they stay on the device); both None on the CPU; host_moment_bytes:
    the moments' bytes in host memory, 0 on the device)."""
    dev = resolve_device(str(device))
    mdef = build_model(cfg)
    overrides = {**dict(pp=1, dp=1), **(overrides or {})}
    if n_chunks:
        overrides["n_chunks"] = n_chunks
    doc_lens = None
    if packed is not None:
        if packed.tokens.shape != (batch, seq):
            raise ValueError(f"packed batch {packed.tokens.shape} is not [{batch}, {seq}]")
        doc_lens = [end - start for _, start, end, _ in sorted(packed.spans, key=lambda s: s[3])]
    cell = resolve_cell(mdef, ShapeConfig("cli_train", seq, batch, "train"),
                        overrides=overrides, doc_lens=doc_lens)
    log.info("plan: %s  chunks=%s alphas=%s", cell.plan, cell.sched.lengths,
             [round(a, 3) for a in cell.alphas])

    params = build_params(cell, dev, seed=0)
    plan = cell.plan
    opt_state = adamw.init_state(params, offload_moments=plan.offload_moments,
                                 moments_dtype=plan.moments_dtype,
                                 moments_mode=plan.moments_mode)
    step_fn = make_train_step(cell, lr_kwargs=dict(peak=lr, warmup=20,
                                                   total=max(steps, 100)))
    data = SyntheticLM(cfg.vocab_size, seq, batch)
    n_active = cm.count_active_params(params)
    meter = Meter(tokens_per_step=batch * seq, n_active_params=n_active)
    moment_bytes = sum(t.numel() * t.element_size()
                       for t in tree.leaves([opt_state.m, opt_state.v]))
    log.info("%s: %d parameters (%d without the embedding), %d layers; moments "
             "%.2f GB on the device, %.2f GB in host memory", cfg.name,
             sum(t.numel() for t in tree.leaves(params)), n_active, cfg.n_layers,
             0.0 if plan.offload_moments else moment_bytes / 1e9,
             moment_bytes / 1e9 if plan.offload_moments else 0.0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    base = None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    for step in range(steps):
        doc_start = None
        if packed is None:
            tokens, labels = (torch.from_numpy(a).to(dev) for a in data.sample_step(step))
        else:
            tokens, labels, doc_start = (torch.from_numpy(a).to(dev) for a in
                                         (packed.tokens, packed.labels, packed.doc_start))
        ctx = step_context(step) if step_context else contextlib.nullcontext()
        with ctx:
            sync()
            meter.start()
            params, opt_state, metrics = step_fn(params, opt_state, tokens, labels, doc_start)
            sync()
            rec = meter.stop(step, float(metrics["loss"]))
        if on_step is not None:
            on_step(step, rec)
        if step % log_every == 0 or step == steps - 1:
            log.info("step %4d  loss %.4f  %.3fs  tgs %.1f  mfu %.3e  gnorm %.3f",
                     step, rec["loss"], rec["dt"], rec["tgs"], rec["mfu"],
                     float(metrics["grad_norm"]))
    if metrics_out:
        meter.dump(metrics_out)
    log.info("done: final loss %.4f (first %.4f)", meter.history[-1]["loss"],
             meter.history[0]["loss"])
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    return dict(history=meter.history, cell=cell, n_active_params=n_active,
                peak_bytes=peak, base_bytes=base,
                host_moment_bytes=moment_bytes if plan.offload_moments else 0)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    _refuse_later_flags(ap, args)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {}
    if args.no_offload:
        overrides["offload"] = False
    if args.prefetch:
        overrides["prefetch"] = args.prefetch
    if args.offload_moments:
        overrides["offload_moments"] = True
    for dest in ("offload_dtype", "moments_mode", "moments_dtype"):
        if getattr(args, dest) is not None:
            overrides[dest] = getattr(args, dest)
    return train(cfg, steps=args.steps, seq=args.seq, batch=args.batch,
                 n_chunks=args.n_chunks, lr=args.lr, log_every=args.log_every,
                 metrics_out=args.metrics_out, device=args.device,
                 overrides=overrides)["history"]


if __name__ == "__main__":
    main()
