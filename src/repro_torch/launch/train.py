"""Training CLI (port of ``repro/launch/train.py``), one device or a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
      --reduced --steps 12 --seq 256 --batch 8 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-3b \
      --reduced --steps 4 --seq 512 --n-chunks 4 --batch 2 --device cpu

  PYTHONPATH=src python -m repro_torch.launch.train --arch whisper-tiny \
      --reduced --steps 4 --seq 512 --n-chunks 4 --batch 2 --device cpu

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --reduced --device cpu --mesh 2x1 --pp 2 --msp --seq 512 --n-chunks 4

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --reduced --device cpu --mesh 1x2 --seq 512 --n-chunks 2

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --reduced --device cpu --mesh 1x2 --attn-mode ring --seq 512 --n-chunks 2

SPPO's chunked pipeline under the reference's default training plan: remat
"sppo", sequence-aware activation offload to pinned host memory, each
chunk's rows reloaded one chunk ahead of its backward (DESIGN.md §5, §10,
§12).  ``--no-offload`` keeps every tagged row on the device (remat "sppo"
still); ``--prefetch sync`` reloads each chunk's rows at its own backward;
``--offload-dtype fp8|int8`` sends them compressed (DESIGN.md §14).  AdamW
with fp32 moments on the device, or with ``--offload-moments`` in pinned
host memory (DESIGN.md §11; qwen2-7b's 28 layers need 61.1 GB of it, 15.3
GB under ``--moments-dtype fp8|int8``); ``--moments-mode`` takes "explicit"
alone.  The reference's synthetic token stream, and TGS (tokens/s per GPU:
the step's tokens over the ranks) / MFU metering on the H100's peak.
A cross-attention model (llama-3.2-vision-11b, whisper-tiny) reads a stub
context at every step, the reference's: standard normal x 0.02 patch or
frame embeddings from the step's seed (``data.pipeline.make_context_stub``)
in the model's dtype.  Weights are random, drawn on the device from a seed.  It runs on the CUDA
card; ``--device cpu`` runs the plain path on the CPU instead (the "host"
copies are then CPU clones).

Under ``torchrun --nproc-per-node D*M``, ``--mesh DxM`` runs D ranks of
the data axis times M of the model axis: ``--pp P`` pipeline stages (dp =
D / P groups), ``--msp [--msp-split K]`` the MSP ramp (DESIGN.md §2, §4;
``parallel/runner.py``), and at M > 1 each chunk sequence-sharded over the
M model ranks, the weights gathered at use, the vocab-parallel loss and
``--attn-mode gather_q|gather_kv|auto|ring`` the attention schedule
(default gather_q; ``ring`` rotates the KV shards around the model ranks,
and at M = 1 is the reference's degenerate ring, one partial and a
normalize; ``local`` is sp = 1's).  ``merge_bf16`` and ``grad_compress`` are
plan overrides of ``train()``, as in the reference, whose CLI has no flag
for them.  The process group runs NCCL on the card, which needs a card per
rank and raises otherwise, and gloo with ``--device cpu``.  A caller that
holds a process group of its own (``launch.mesh.spawn``, say gloo for ranks
that share one card, their transfers staged through host memory) calls
``train()``.

The reference CLI's other flags belong to later slices of the port and are
refused with the ROADMAP item that brings them.  ``train(cfg, ...)`` is the
body, for callers that pass a config of their own (a depth-cut model), plan
overrides (chip_smoke.py's ablations), a pod axis (``overrides=dict(pods=)``,
with ZeRO-1; the reference's CLI has no pod flag either), a packed
variable-length batch (``packed=``, DESIGN.md §13; nor a flag for one) or a
process group they already hold (``ctx=``, or an initialised
``torch.distributed``).
"""
from __future__ import annotations

import argparse
import contextlib
import logging
import os

import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import tree
from repro_torch.data.pipeline import SyntheticLM, make_context_stub
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.serve import build_params, resolve_device
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel.ctx import ATTN_MODES, Ctx, make_ctx
from repro_torch.parallel.runner import init_opt_state, make_train_step, resolve_cell
from repro_torch.runtime.metrics import Meter

log = logging.getLogger("repro_torch.train")

# flag -> (what it asks for, ROADMAP Queue 1 item that ports it)
LATER = {
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
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL ranks, the torchrun world DATA x MODEL, e.g. 2x1 or 1x2")
    ap.add_argument("--pp", type=int, default=None,
                    help="pipeline stages of the data axis (dp = DATA / pp)")
    ap.add_argument("--msp", action="store_true",
                    help="multiplexed sequence partitioning, the ramp schedule (pp > 1)")
    ap.add_argument("--msp-split", type=int, default=2,
                    help="sub-chunks per MSP ramp chunk")
    ap.add_argument("--attn-mode", default=None,
                    help="attention schedule over the model axis: gather_q (default), "
                         "gather_kv, auto, ring, local (sp = 1)")
    # the reference CLI's flags of later slices: refused when given
    ap.add_argument("--audit", action="store_true", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=None)
    ap.add_argument("--resume", default=None)
    return ap


def _refuse_later_flags(ap, args):
    if args.attn_mode is not None and args.attn_mode not in ATTN_MODES:
        ap.error(f"--attn-mode {args.attn_mode!r}: expected one of {ATTN_MODES}")
    for dest, (what, item) in LATER.items():
        val = getattr(args, dest)
        if val is None:
            continue
        ap.error(f"--{dest.replace('_', '-')}: {what} comes with a later slice "
                 f"of the port (ROADMAP Queue 1, item {item})")


def train(cfg, *, steps: int, seq: int, batch: int, n_chunks=None,
          lr: float = 3e-4, log_every: int = 10, metrics_out=None,
          device="cuda", overrides=None, on_step=None, step_context=None,
          packed=None, ctx: Ctx = None):
    """Train ``cfg`` for ``steps`` steps on ``device``.

    Over a mesh of ranks, each rank calls ``train`` with the same
    arguments: ``ctx`` (``parallel/ctx.py``), or else the initialised
    ``torch.distributed`` process group (``launch.mesh``), gives the ranks;
    ``overrides`` name ``pods`` (the pod axis, default 1; ZeRO-1 where
    > 1), ``sp`` (the model axis, default 1), ``pp`` (default 1: dp = the
    ranks / (pods pp sp)), ``msp``, ``msp_split``, and at sp > 1
    ``attn_mode``, ``merge_bf16``, ``grad_compress``.  Each rank builds its
    stage of the seed's weights (at sp > 1 its model shard of them), takes
    its dp group's rows of the batch in its pod (``Cell.rows``), and meters
    tokens/s per GPU (the step's tokens over the ranks).

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
    the moments' bytes in host memory, 0 on the device; ctx: the data axis)."""
    dev = resolve_device(str(device))
    mdef = build_model(cfg)
    if ctx is None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
    else:
        world = ctx.world
    overrides = dict(overrides or {})
    pods = overrides.pop("pods", 1)
    pp, sp = overrides.get("pp", 1), overrides.get("sp", 1)
    if world % (pods * pp * sp):
        raise ValueError(f"pods x pp x sp = {pods} x {pp} x {sp} does not divide the "
                         f"{world} ranks")
    overrides = {**dict(pp=1, dp=world // (pods * pp * sp)), **overrides}
    if n_chunks:
        overrides["n_chunks"] = n_chunks
    doc_lens = None
    if packed is not None:
        if packed.tokens.shape != (batch, seq):
            raise ValueError(f"packed batch {packed.tokens.shape} is not [{batch}, {seq}]")
        doc_lens = [end - start for _, start, end, _ in sorted(packed.spans, key=lambda s: s[3])]
    cell = resolve_cell(mdef, ShapeConfig("cli_train", seq, batch, "train"),
                        overrides=overrides, doc_lens=doc_lens,
                        data_size=world // (pods * sp), model_size=sp, pods=pods)
    if ctx is None:
        ctx = make_ctx(cell.plan, pods=pods, device=dev)
    log.info("plan: %s  chunks=%s alphas=%s", cell.plan, cell.sched.lengths,
             [round(a, 3) for a in cell.alphas])

    params = build_params(cell, dev, seed=0, stage=ctx.stage_index(),
                          model_rank=ctx.model_index())
    plan = cell.plan
    opt_state = init_opt_state(cell, params, ctx)
    step_fn = make_train_step(cell, lr_kwargs=dict(peak=lr, warmup=20,
                                                   total=max(steps, 100)), ctx=ctx)
    data = SyntheticLM(cfg.vocab_size, seq, batch)
    n_active = (cm.count_active_params(mdef) if world > 1
                else cm.count_active_params(params, cfg=cfg))
    meter = Meter(tokens_per_step=batch * seq // world, n_active_params=n_active)
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
        # this rank's dp group's rows of the global batch
        if packed is None:
            tokens, labels = (torch.from_numpy(a).to(dev)
                              for a in cell.rows(ctx, *data.sample_step(step)))
        else:
            tokens, labels, doc_start = (torch.from_numpy(a).to(dev) for a in cell.rows(
                ctx, packed.tokens, packed.labels, packed.doc_start))
        context = None
        if cfg.cross_attn is not None:
            # the reference's stub frontend at the step's seed (train.py:219-222)
            stub = make_context_stub(b_loc=cell.b_loc, pods=pods, data_size=cell.data_size,
                                     n_ctx_pad=mdef.n_context(), d_model=cfg.d_model, seed=step)
            context = torch.from_numpy(stub[ctx.pod_index(), ctx.data_index()]).to(
                dev, cell.dtype)
        with step_context(step) if step_context else contextlib.nullcontext():
            sync()
            meter.start()
            params, opt_state, metrics = step_fn(params, opt_state, tokens, labels, doc_start,
                                                 context)
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
                host_moment_bytes=moment_bytes if plan.offload_moments else 0, ctx=ctx)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    _refuse_later_flags(ap, args)
    try:
        data, model = mesh_mod.parse_mesh(args.mesh) if args.mesh else (None, 1)
    except ValueError as err:
        ap.error(f"--mesh: {err}")
    pp = args.pp or 1
    if args.msp and pp == 1:
        ap.error("--msp needs a pipeline: pass --pp > 1")
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    import torch.distributed as dist

    device = args.device
    if (data or 1) * model > 1 or pp > 1:
        if not dist.is_initialized():
            if "RANK" not in os.environ:
                ap.error("--mesh / --pp over several ranks: run under torchrun "
                         "--nproc-per-node DATA*MODEL (or hold a process group and call "
                         "train())")
            backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
            _, _, device = mesh_mod.init_from_env(backend, device)
        world = dist.get_world_size()
        if data is not None and data * model != world:
            ap.error(f"--mesh {args.mesh}: {data} x {model} ranks, but the process group "
                     f"has {world}")
        if (world // model) % pp:
            ap.error(f"--pp {pp} does not divide the {world // model} data ranks")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {}
    if pp > 1:
        overrides["pp"] = pp
    if model > 1:
        overrides["sp"] = model
    if args.attn_mode is not None:
        overrides["attn_mode"] = args.attn_mode
    if args.msp:
        overrides.update(msp=True, msp_split=args.msp_split)
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
                 metrics_out=args.metrics_out, device=device,
                 overrides=overrides)["history"]


if __name__ == "__main__":
    main()
