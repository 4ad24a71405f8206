"""Smoke test of the PyTorch/CUDA port on one CUDA card.

  python3 chip_smoke.py

Four phases, each of which exits non-zero on failure:

1. device and build: the card's name and power limit, then the Hopper
   attention kernels built for sm_90a from src/repro_torch/kernels/csrc (the
   tensor-core and the CUDA-core forward, the fp32 CUDA-core backward and
   the bf16 tensor-core backward sources, one nvcc each, started together)
   with nvcc's register and shared-memory report;
2. each kernel against its plain PyTorch version on the card.  The forward:
   on an edge grid in fp32 (the CUDA cores), in bf16 (the tensor cores, the
   dtype's default) and in bf16 on the CUDA cores (ragged sizes, hd_k !=
   hd_v, G in {1, 2, 3, 4, 7, 8, 64}, KV splits, more than 1024 KV tiles
   and more than 1024 query tiles, a q_start window and a split decode step
   with fully masked rows, which must be exact); then both forward kernels
   on the same bf16 inputs at the serving path's prefill-chunk and decode
   shapes and at the training cell's first and last chunk shapes (Tq 2560
   over 2560 slots, Tq 1664 over 8192, q a head slice of the fused q|k
   projection), timed in turns (CUDA cores, tensor cores, tensor cores, CUDA
   cores), each call whole (the decode step's split merged in the launch,
   or by the CUDA-core merge kernel).  Both sides compute in fp32 from the
   same inputs (the tensor cores with p split into three bf16 terms), so
   every case is held to 1e-5.  The backward (dq and dk/dv): on an edge
   grid in fp32 and bf16
   (Tq = 1, ragged sizes, G in {1, 4, 7, 8}, hd_k != hd_v, a q_start window,
   PAD slots, a strided cache view, fully masked rows given NaN cotangents,
   whose gradients must be exactly 0) and at the training cell's first and
   last chunk shapes; each gradient is held to 1e-5 x max |plain gradient|.
   bf16 inputs run the tensor-core kernels and fp32 inputs the CUDA-core
   ones (the wrappers' dispatch).  The 2-layer fp32 train check's two chunk
   shapes (phase 4) run in fp32 too, forward (with its split-KV merge) and
   backward (CUDA cores), each held to the same bounds; at the chunk shapes
   of the bf16 training cell the CUDA-core kernels
   also run on the same bf16 inputs, held to the same bound, and the two
   pairs are timed in turns (CUDA cores, tensor cores, tensor cores, CUDA
   cores).  Beside each kernel's bound: the device times of the kernel (CUDA
   events; each backward kernel and the CUDA-core forward's split-KV merge
   its own time under torch.profiler), the plain version and
   ``F.scaled_dot_product_attention`` (forward, or its backward with the same
   mask; a yardstick only: the port never calls it);
3. the static serve path of qwen2-7b through its CLI entry point at full
   width, all 28 layers, bf16, random weights from a seed: B = 4, a
   2048-token prompt (16 prefill chunks of 128) and 32 decode steps, served
   3 times over in one process (the first run pays one-time costs; each run
   is timed).  The tensor-core forward must be launched exactly 28 x (16 +
   32) times a run, each decode call merging its KV splits in its own
   launch, and no other kernel.  The same seed-built model
   cut to 2 layers then prefills one 256-token prompt on the card (bf16) and
   on the CPU (plain path, fp32): the last hidden states must agree within a
   relative L2 error of 2e-2, a bf16 tolerance.  Last, outside the counted
   run and after a warm-up, a prefill and 4 decode steps run under
   torch.profiler for the device's busy time by kernel group and its idle
   share against the wall time of the same profiled run and against that of
   the last unprofiled run (the profiler slows the host);
4. training through ``repro_torch.launch.train.train``.  First the host
   link: the pinned D2H and H2D rates of a 1 GiB copy (CUDA events) beside
   the cost model's ``H100.d2h_bw``; then the embedding's backward at the
   train cell's shape: two calls bitwise equal, its cost against the
   ``index_select`` gather it replaced.  Then qwen2-7b at full width cut to
   4 layers (bf16 parameters, fp32 AdamW moments), B = 1, S = 8192 in 4
   FLOPs-balanced chunks (2560, 2048, 1920, 1664), 4 steps, under five plans
   in turns: (d) the reference's default plan, offload on, remat "sppo",
   prefetch "ahead" (no override: the main path), first; (a) offload off,
   remat "none"; (b) offload off, remat "sppo"; (c) offload on, prefetch
   "sync"; (e) offload off, remat "full".  The steps run as the CLI runs
   them.  Each step must launch the tensor-core dq and dk/dv kernels 16
   times each (4 layers x 4 chunks) and the tensor-core forward 16 times
   under remat "none", 32 under "sppo" and "full" (the replay re-runs it),
   unsplit, the CUDA-core kernels never; its D2H bytes must equal the cost
   model's closed form (Σ split_rows(rows, α) x the tagged bytes of a token
   in every layer) exactly, its H2D bytes the D2H bytes, every host buffer
   pinned; losses finite, the plans' step-0 losses within 1e-3 relative,
   and the losses of (b), (c) and (d) bitwise equal at every step.  After
   each plan's run, one untimed loss-and-gradients call on fresh weights
   reads the peak above the weights, and its gradients must equal (d)'s
   bitwise for (b) and (c), every leaf, within GRAD_PLAN_TOL for (a) and
   (e).  Per plan: the deployed and quantized α, seconds, tokens/s, MFU (6
   N T over the bf16 peak, the reference's definition) of every step, the
   step's peak over all steps beside ``peak_memory`` of the tagged set, and
   for the last step, under torch.profiler, the device's busy time (union
   of kernel and copy intervals) and idle share, the kernel groups, and the
   pinned DtoH and HtoD copies' device ms, the share of it that overlaps a
   compute kernel and the exposed rest.  Then, on the same cell, the
   moments (``moment_phase``): fp32 moments in pinned host memory in
   lockstep with moments on the device, 3 steps, losses, parameters and
   both moments bitwise equal after every step, the moment copies'
   bytes by the closed form, the offloaded update's device peak within the
   on-device update's plus two leaves' moments; and the codecs, 3 steps
   each of ``offload_dtype`` fp8 and int8 and ``moments_dtype`` fp8 and
   int8: bytes by the closed forms at the codec's α, the step-0 loss within
   1e-5, the step-0 gradients within CODEC_GRAD_TOL of (d)'s, the
   parameters after two updates within CODEC_PARAM_TOL.  Then qwen2-7b at
   all 28 layers (``full_depth_phase``), S = 8192, the default plan with
   fp32 and with fp8 moments in pinned host memory (61.1 GB and 15.3 GB),
   3 steps each, held as the plans are (224 / 112 / 112 launches a step)
   with the moment copies by the closed form, the step's device peak under
   80 GB, and the update's moment copies and their exposed ms from the
   profiler.  Then the long cell, S = 32768 in 8 chunks: plans (d), (b) and
   (e) for LONG_STEPS steps each, held alike, plan (a) only if PERF.md's
   prediction of its peak is under 75 GiB.  Last, the same seed-built
   model cut to 2
   layers takes one step's loss and gradients at S = 256 (2 chunks, chunk 0
   offloading every tagged row) in fp32 under the default plan on the card
   (kernels, no TF32: 8 launches of the CUDA-core forward (4 and their
   replays) with the merge kernel wherever a chunk splits, 4 each of dq and
   dk/dv, none of the tensor-core ones; 10 pinned D2H copies and as many
   H2D) and on the CPU (plain path): the loss and the gradients of layer
   0's wq, wk, wv and the head must agree within a relative L2 error of
   1e-4.  Serving must copy nothing to or from host memory.  Then packed
   variable-length training (``packed_phase``): qwen2-7b at full width cut
   to 4 layers, S = 8192 in 4 chunks, 32 seeded Zipf documents (24574 real
   tokens) packed into 3 rows (``train(packed=)``, grad_accum 3: one row a
   microbatch) under plans (d) and (b), and the pad-to-max baseline (one
   document a row at its packed offsets, grad_accum 32) under (d),
   PACKED_STEPS steps each, held as the plans are; (d)'s losses bitwise
   (b)'s at every step, and packed real tokens/s at least VARLEN_FACTOR
   times pad-to-max's; beside them the solver's predicted step.  Then a
   2-layer fp32 packed step (``packed_cpu_check``, tests/test_varlen.py's
   corpus at S = 256, the CUDA-core kernels with the document windows)
   within 1e-4 of the CPU and its loss within 1e-5 of the pad-to-max
   oracle's on the card.  Last, glm4-9b, nemotron-4-15b and starcoder2-3b
   (G = 16, 6, 12) at full width cut to 2 layers, B = 1, S = 4096 in 4
   chunks, the default plan, 2 steps each (``config_phase``): finite
   losses, the launches by the closed form.  Phase 2 also holds the
   kernels at the packed cell's chunk shapes (3 rows, per-row windows),
   the packed fp32 check's (fp32, the CUDA cores) and one train chunk of
   each of the three configs.  Every path's launches and copies are
   counted from 0 just before it runs.

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel with its check and times: the tensor-core and the CUDA-core
forward, the latter's merge, and the tensor-core and CUDA-core backward
pairs, each kernel's ``launches`` counted on the main paths that run it
(bf16 serving, the default plan's training at 4 layers, at full depth
and on packed rows for the tensor cores, the fp32 training checks, uniform
and packed, for the CUDA cores) with its counts on every path beside.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

PAD = 2**30
L2_BYTES = 50 * 2**20
# the H100's HBM rate and dense bf16 peak, from repro_torch.core.costmodel
# (data-sheet values) once main() has put the port on the path
HBM_BYTES_PER_S = BF16_FLOPS = None
FP32_FLOPS = 67e12          # fp32 outside the tensor cores (data sheet), printed only
PREFILL_LEN, BATCH, DECODE_STEPS, REPEATS = 2048, 4, 32, 3
TRAIN_LAYERS, TRAIN_SEQ, TRAIN_CHUNKS, TRAIN_STEPS = 4, 8192, 4, 4
LONG_SEQ, LONG_CHUNKS, LONG_STEPS = 32768, 8, 2
# plan (a)'s peak at S = 32768 as predicted in PERF.md before the first run
# (the weights and moments plus four times the S = 8192 run's activations):
# plan (a) runs on the long cell only if this is under 75 GiB
LONG_PLAN_A_PREDICTED_GIB = 92
KERNEL_TOL = 1e-5  # kernel vs plain version: both fp32 inside, inputs alike
GRAD_REL_TOL = 1e-4  # 2-layer fp32 train step, card vs CPU: relative L2
# bf16 step-0 gradients of one training plan against the default plan's,
# where they are not held bitwise: relative L2 at the worst leaf
GRAD_PLAN_TOL = 1e-2
# the moment offload and the codecs on the 4-layer S = 8192 cell
MOMENT_STEPS = 3
CODEC_LOSS_TOL = 1e-5                       # step-0 loss, relative (the reference's)
CODEC_GRAD_TOL = {"fp8": 0.05, "int8": 0.03}   # step-0 gradients, relative L2
CODEC_PARAM_TOL = {"fp8": 1e-2, "int8": 3e-2}  # parameters after two updates
# full depth: all 28 layers of qwen2-7b at S = 8192 with the moments in
# pinned host memory.  The H100 machine has 101 GiB of host memory, 96 GiB
# free, and page-locked 60 GB in one cudaHostRegister call (`free -g`,
# PERF.md §4): the fp32 moments' 61.1 GB fit, so the phase runs fp32 and
# fp8 moments (int8 moments run on the 4-layer cell).  A pinned allocation
# that fails raises.
FULL_STEPS = 3
FULL_DEPTH_MOMENTS = ("none", "fp8")
CARD_BYTES = 80e9
# the share of an update's moment copies that the profiler may fail to
# deliver before copy_timeline refuses its reading (the copies themselves
# are counted exactly by runtime/hostmem.py)
MISSED_COPY_SHARE = 0.01
# packed variable-length training (DESIGN.md §13): qwen2-7b at full width, 4
# layers, S = 8192 in 4 chunks; 32 Zipf documents (24574 real tokens) packed
# into 3 rows, one row a microbatch, against the pad-to-max baseline (one
# document a row at its packed offsets, 32 microbatches)
PACKED_CORPUS = dict(n_docs=32, seed=0, dist="zipf", mean_len=768, max_len=8192)
PACKED_SEQ, PACKED_CHUNKS, PACKED_STEPS = 8192, 4, 3
# the reference's varlen gate: packed real tokens/s over pad-to-max's
# (benchmarks/bench_varlen.py, DEFAULT_FACTOR)
VARLEN_FACTOR = 1.5
# the 2-layer fp32 packed check: tests/test_varlen.py::_corpus at S = 256
FP32_PACKED_CORPUS = dict(n_docs=10, seed=3, dist="zipf", mean_len=48, max_len=200)
PACKED_LOSS_TOL = 1e-5    # packed vs the pad-to-max oracle (the reference's bar)
# three more dense configs at full width, cut to 2 layers: G = 16, 6, 12
CONFIG_ARCHS = ("glm4-9b", "nemotron-4-15b", "starcoder2-3b")
CONFIG_LAYERS, CONFIG_SEQ, CONFIG_CHUNKS, CONFIG_STEPS = 2, 4096, 4, 2


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def cold_copies(args, n_bytes: int):
    """Copies of the inputs ``args`` in distinct memory, enough of them to
    exceed twice the 50 MB L2, so a run that cycles through them finds each
    call's inputs cold, as the serving path finds K and V.  A view is copied
    with its whole base buffer, so it keeps its strides."""
    def copy(t):
        if t is None:
            return None
        if t._base is None:
            return t.clone()
        return t._base.clone().as_strided(t.shape, t.stride(), t.storage_offset())

    n = max(2, -(-2 * L2_BYTES // n_bytes))
    return [args] + [tuple(copy(t) for t in args) for _ in range(n - 1)]


def time_ms(fn, copies, reps: int = 24, label: str = "") -> float:
    """Device time of one call ``fn(*copies[i])``: the mean over ``reps``
    calls between two CUDA events, cycling through the copies.  A sleep
    kernel queued first holds the device until the host has queued every
    call (it is lengthened until it does), so host overhead is not timed.
    Calls that wait on the device inside (the host can never run ahead of
    the sleep) are timed instead as the device's busy time under
    torch.profiler, which also leaves the host's gaps out."""
    for args in copies:
        fn(*args)
    torch.cuda.synchronize()
    cycles = 2_000_000
    while cycles < 2_000_000_000:  # ~1 s of sleep at most
        woke = torch.cuda.Event()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        woke.record()
        start.record()
        for i in range(reps):
            fn(*copies[i % len(copies)])
        end.record()
        queued_in_time = not woke.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / reps
        cycles *= 4
    ms = profiled_ms(fn, copies, reps)[0]
    print(f"  note: {label or 'a timed call'} waits on the device inside; timed as "
          f"the profiler's device busy time, {ms:.4f} ms a call")
    return ms


def profiled_ms(fn, copies, reps: int, want=()):
    """Device busy time of one call ``fn(*copies[i])`` under torch.profiler,
    cycling through the copies: (ms in all, {kernel group of
    ``device_time``: ms}).  The host's gaps between kernels are left out.
    ``want``: the kernel groups the calls launch."""
    from torch.profiler import ProfilerActivity, profile

    # a session now and then delivers none of the calls' kernels (seen on
    # the H100 machine: one of four profiled turns of a backward pair read
    # 0 ms for both kernels); such a session is run again, at most twice
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fn(*copies[i % len(copies)])
            torch.cuda.synchronize()
        total, groups, _ = device_time(prof)
        missed = [g for g in want if groups[g] <= 0]
        if total > 0 and not missed:
            break
        print(f"  note: a profiler session delivered no event of {missed or 'any kernel'} "
              f"(attempt {attempt + 1}); profiling again")
    return total / reps, {k: v / reps for k, v in groups.items()}


def visible_mask(B, q_pos, kv_pos, q_start, causal=True):
    """[B, Tq, S] visibility, the kernel's rule ([Tq] positions are shared
    by the batch; q_start None is no window)."""
    def rows(x):
        return x.expand(B, -1) if x.dim() == 1 else x

    kp = kv_pos[None, None, :]
    vis = (kp != PAD).expand(B, q_pos.shape[-1], -1)
    if causal:
        vis = vis & (rows(q_pos)[:, :, None] >= kp)
    return vis if q_start is None else vis & (kp >= rows(q_start)[:, :, None])


# the forward kernels: each one's launch and split-merge keys in counts()
FWD_KERNELS = {"tensor_cores": ("fwd_tc", "merged_in_kernel"), "cuda_cores": ("fwd", "merge")}


def fwd_kind(kernels, dtype):
    """The forward a call runs: ``kernels``, or the wrapper's choice by dtype."""
    return kernels or ("tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")


def fwd_nsplit(fa, kind, q, k):
    """KV splits of a forward call (the kernel's own geometry)."""
    B, Tq, H, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    geometry = fa._tc_geometry if kind == "tensor_cores" else fa._geometry
    return geometry(B, Tq, S, H // Hkv, Hkv, torch.cuda.get_device_properties(0).multi_processor_count)[2]


def kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, causal=True, kernels=None):
    """Run a forward kernel (``kernels``: the wrapper's choice, None = by
    dtype) and the plain version on the same inputs and fail unless that
    kernel launched once (and merged its KV splits once, in the launch or by
    the merge kernel, where it split) and they agree; returns (max
    |normalized diff|, kernel outputs)."""
    kind = fwd_kind(kernels, q.dtype)
    before = fa.counts()
    o1, m1, l1 = fa.flash_attention_partial(q, k, v, q_pos, kv_pos, causal=causal,
                                            q_start=q_start, kernels=kernels)
    moved = {key: n - before[key] for key, n in fa.counts().items() if n != before[key]}
    launch, merge = FWD_KERNELS[kind]
    want = {launch: 1, **({merge: 1} if fwd_nsplit(fa, kind, q, k) > 1 else {})}
    check(moved == want, f"the forward launched {moved}, expected {want} ({q.dtype}, "
          f"kernels={kernels}) at q {tuple(q.shape)} k {tuple(k.shape)}")
    o2, m2, l2 = ref.attention_partial_ref(q, k, v, q_pos, kv_pos,
                                           causal=causal, q_start=q_start)
    torch.cuda.synchronize()
    err = (ref.normalize(o1, l1) - ref.normalize(o2, l2)).abs().max().item()
    live = m2 > -1e29
    m_err = (m1 - m2)[live].abs().max().item() if live.any() else 0.0
    tol = KERNEL_TOL
    check(err <= tol and m_err <= tol and bool((m1[~live] == m2[~live]).all()),
          f"{kind} forward disagrees with plain version: out err {err}, m err {m_err}"
          f" (tol {tol}) at q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    return err, (o1, m1, l1)


def check_dead_rows(o, m, l, dead, n_dead, what):
    check(int(dead.sum()) == n_dead, f"{what}: expected {n_dead} dead rows, got {int(dead.sum())}")
    check(bool((o[dead] == 0).all() and (l[dead] == 0).all() and (m[dead] == -1e30).all()),
          f"{what}: fully masked rows are not exactly o = l = 0, m = -1e30")


def edge_grid(fa, ref, gen):
    """The forward at 1e-5: fp32 (the CUDA cores), bf16 (the tensor cores,
    the dtype's default) and bf16 on the CUDA cores.  Ragged sizes, hd_k !=
    hd_v, small and non-power-of-two head dims, G in {1, 2, 3, 4, 7, 8, 64},
    non-causal, KV splits (a long decode), more than 1024 KV tiles and more
    than 1024 query tiles, a q_start window with fully masked rows and a
    split decode with a dead batch row (dead rows must be exact).  Returns
    ({kernels: worst error}, cases)."""
    dev = "cuda"
    cases = [  # B, Tq, S, H, Hkv, hdk, hdv, causal
        (2, 17, 33, 6, 2, 16, 16, True), (1, 8, 128, 8, 1, 64, 32, True),
        (1, 16, 48, 4, 4, 32, 32, False), (2, 9, 100, 14, 2, 128, 128, True),
        (1, 1, 64, 4, 2, 32, 32, True), (3, 70, 200, 28, 4, 128, 128, True),
        (2, 5, 77, 14, 2, 24, 8, True), (2, 3, 70, 14, 2, 40, 96, True),
        (1, 1, 2000, 14, 2, 128, 128, True), (2, 37, 150, 8, 2, 64, 32, True),
        (1, 1152, 66000, 8, 8, 16, 16, True),   # 1032 KV tiles, unsplit: two visibility windows
        (1, 2100, 2200, 64, 1, 16, 16, True)]   # 1050 query tiles of 2 tokens (tensor cores)
    worst, n = {}, 0
    for dtype, kernels in ((torch.float32, None), (torch.bfloat16, None),
                           (torch.bfloat16, "cuda_cores")):
        kind = fwd_kind(kernels, dtype)

        def run(*args, causal=True):
            err, out = kernel_vs_plain(fa, ref, *args, causal=causal, kernels=kernels)
            worst[kind] = max(worst.get(kind, 0.0), err)
            return out

        for B, Tq, S, H, Hkv, hdk, hdv, causal in cases:
            q = torch.randn(B, Tq, H, hdk, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, S, Hkv, hdk, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, S, Hkv, hdv, generator=gen, device=dev).to(dtype)
            q_pos = (torch.arange(Tq, dtype=torch.int32, device=dev) + S - Tq)[None].repeat(B, 1)
            kv_pos = torch.arange(S, dtype=torch.int32, device=dev)
            q_start = torch.zeros(B, Tq, dtype=torch.int32, device=dev)
            run(q, k, v, q_pos, kv_pos, q_start, causal=causal)
            n += 1
        # a q_start window with dead rows: PAD windows, a row that sees only
        # future slots, and empty (PAD) cache slots
        B, Tq, S, H, Hkv, hd = 2, 8, 200, 14, 2, 128   # 4 tiles: split and merged
        q = torch.randn(B, Tq, H, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype)
        q_pos = torch.tensor([[16 + i for i in range(Tq)], [1] + [9 + i for i in range(Tq - 1)]],
                             dtype=torch.int32, device=dev)
        q_start = torch.tensor([[0, 0, 4, 4, 4, 20, 20, PAD], [0, 3, 3, 3, 9, 9, PAD, PAD]],
                               dtype=torch.int32, device=dev)
        kv_pos = torch.arange(S, dtype=torch.int32, device=dev) + 2
        kv_pos[-3:] = PAD
        o, m, l = run(q, k, v, q_pos, kv_pos, q_start)
        dead = ~visible_mask(B, q_pos, kv_pos, q_start).any(dim=-1)
        check_dead_rows(o, m, l, dead, 4, f"window case ({kind}, {dtype})")
        # a decode step over the serve path's cache, split over the KV range,
        # with batch row 1 fully masked (q_start = PAD)
        B, S, H, Hkv = BATCH, PREFILL_LEN + 128, 28, 4
        q = torch.randn(B, 1, H, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, Hkv, hd, generator=gen, device=dev).to(dtype)
        pos = torch.arange(S, dtype=torch.int32, device=dev)
        kv_pos = torch.where(pos <= PREFILL_LEN, pos, PAD).to(torch.int32)
        q_pos = torch.full((B, 1), PREFILL_LEN, dtype=torch.int32, device=dev)
        q_start = torch.zeros(B, 1, dtype=torch.int32, device=dev)
        q_start[1] = PAD
        check(fwd_nsplit(fa, kind, q, k) > 1, f"the decode edge case does not split ({kind})")
        o, m, l = run(q, k, v, q_pos, kv_pos, q_start)
        dead = ~visible_mask(B, q_pos, kv_pos, q_start).any(dim=-1)
        check_dead_rows(o, m, l, dead[..., None].expand(B, 1, H), H,
                        f"split decode ({kind}, {dtype})")
        n += 2
    return worst, n


def measure_shape(name, fa, ref, q, k, v, q_pos, kv_pos, q_start):
    """Check both forward kernels at one main-path shape on the same bf16
    inputs (each held to 1e-5) and time them in turns (CUDA cores, tensor
    cores, tensor cores, CUDA cores), each call whole (a split's merge
    included), beside the plain version and SDPA.  The bound counts what
    this data needs: q.k and p.v for each visible (query, slot) pair and
    head; bytes of the query rows that see some slot, the K/V rows some
    query of their batch row sees, every position read and every output
    written.  Returns {kernels: row}."""
    errs = {kind: kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, kernels=kind)[0]
            for kind in FWD_KERNELS}
    B, Tq, H, hdk = q.shape
    S, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    vis = visible_mask(B, q_pos, kv_pos, q_start)
    n_vis = int(vis.sum())                     # (b, t, s) pairs this data needs
    ops = 2 * (hdk + hdv) * H * n_vis          # q.k and p.v per visible pair and head
    live_rows = int(vis.any(dim=2).sum())      # (b, t) rows that see some slot
    kv_rows = int(vis.any(dim=1).sum())        # (b, s) K/V rows some row of b sees
    n_bytes = (q.element_size() * (live_rows * H * hdk + kv_rows * Hkv * (hdk + hdv))
               + 4 * (q_pos.numel() + S + (0 if q_start is None else q_start.numel()))
               + 4 * B * Tq * H * (hdv + 2))
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
    footprint = sum(t.numel() * t.element_size() for t in (q, k, v))
    copies = cold_copies((q, k, v, q_pos, kv_pos, q_start), footprint)
    turns = {kind: [] for kind in FWD_KERNELS}
    for kind in ("cuda_cores", "tensor_cores", "tensor_cores", "cuda_cores"):
        turns[kind].append(time_ms(
            lambda *a, kind=kind: fa.flash_attention_partial(*a[:5], q_start=a[5], kernels=kind),
            copies, label=f"the {kind} forward [{name}]"))
    plain_ms = time_ms(lambda *a: ref.attention_partial_ref(*a[:5], q_start=a[5]), copies,
                       reps=len(copies), label=f"the plain forward [{name}]")
    mask = vis[:, None]                        # [B, 1, Tq, S]
    lib_ms = time_ms(lambda *a: F.scaled_dot_product_attention(
        a[0].transpose(1, 2), a[1].transpose(1, 2), a[2].transpose(1, 2), attn_mask=mask,
        enable_gqa=True), copies)
    bound_ms = 1e3 * max(t_bytes, t_ops)
    rows = {kind: {"shape": name, "q": list(q.shape), "kv": list(k.shape), "dtype": str(q.dtype),
                   "kernels": kind, "nsplit": fwd_nsplit(fa, kind, q, k),
                   "max_abs_err": errs[kind], "ms": sum(turns[kind]) / len(turns[kind]),
                   "ms_turns": turns[kind], "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                   "library_ms": lib_ms, "bytes": n_bytes, "ops": ops}
            for kind in FWD_KERNELS}
    tc, cc = rows["tensor_cores"], rows["cuda_cores"]
    print(f"fwd kernels [{name}] q {tuple(q.shape)} kv {tuple(k.shape)}: tensor cores "
          f"{tc['ms']:.4f} ms (turns {', '.join(f'{t:.4f}' for t in tc['ms_turns'])}; err "
          f"{tc['max_abs_err']:.3e}; {tc['nsplit']} KV splits), CUDA cores {cc['ms']:.4f} ms "
          f"(turns {', '.join(f'{t:.4f}' for t in cc['ms_turns'])}; err {cc['max_abs_err']:.3e}; "
          f"{cc['nsplit']} KV splits), tensor cores / CUDA cores {tc['ms'] / cc['ms']:.3f}; plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({tc['bound_by']}, "
          f"{ops:.3e} ops, {n_bytes:.3e} bytes); fp32 outside the tensor cores at the data "
          f"sheet's {FP32_FLOPS / 1e12:.0f} TFLOP/s would take {1e3 * ops / FP32_FLOPS:.4f} ms")
    if cc["nsplit"] > 1:
        cc["merge"] = measure_merge(name, fa, ref, copies, cc["nsplit"], (B, Tq, H, hdv))
    return rows


def measure_merge(name, fa, ref, copies, nsplit, shape):
    """The CUDA-core forward's split-KV merge kernel at one shape: its own
    device time under torch.profiler (the forward call launches it), the
    plain merge (``merge_partials`` over as many partials) and its bound,
    the bytes of the partials read and of (o, m, l) written."""
    _, by_group = profiled_ms(
        lambda *a: fa.flash_attention_partial(*a[:5], q_start=a[5], kernels="cuda_cores"),
        copies, reps=24, want=("attention merge kernel",))
    ms = by_group["attention merge kernel"]
    check(ms > 0, f"the profiler saw no merge kernel at [{name}]: {by_group}")
    B, Tq, H, hdv = shape
    parts = tuple(torch.randn(*dims, device="cuda")
                  for _ in range(nsplit) for dims in ((B, Tq, H, hdv), (B, Tq, H), (B, Tq, H)))
    plain_ms = time_ms(lambda *a: ref.merge_partials([a[3 * i:3 * i + 3] for i in range(nsplit)]),
                       cold_copies(parts, sum(t.numel() * 4 for t in parts)))
    n_bytes = 4 * (nsplit + 1) * B * Tq * H * (hdv + 2)
    row = {"shape": name, "nsplit": nsplit, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * n_bytes / HBM_BYTES_PER_S, "bound_by": "bytes", "bytes": n_bytes}
    print(f"merge [{name}] {nsplit} partials of {(B, Tq, H, hdv)}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {row['bound_ms']:.5f} ms (bytes)")
    return row


def serving_shapes(gen):
    """The kernel's inputs at the serve path's shapes, as the path passes
    them (a position row shared by the batch, no q_start window): the last
    prefill chunk (Tq = 128 over a 2048-slot prefix view of the 2176-slot
    cache buffer) and decode step 1 (Tq = 1 over the whole buffer, a PAD
    tail)."""
    dev, bf16 = "cuda", torch.bfloat16
    H, Hkv, hd = 28, 4, 128
    cache_loc = PREFILL_LEN + 128
    kbuf = torch.randn(BATCH, cache_loc, Hkv, hd, generator=gen, device=dev).to(bf16)
    vbuf = torch.randn(BATCH, cache_loc, Hkv, hd, generator=gen, device=dev).to(bf16)
    pos = torch.arange(cache_loc, dtype=torch.int32, device=dev)
    q = torch.randn(BATCH, 128, H, hd, generator=gen, device=dev).to(bf16)
    q_pos = PREFILL_LEN - 128 + torch.arange(128, dtype=torch.int32, device=dev)
    prefill = (q, kbuf[:, :PREFILL_LEN], vbuf[:, :PREFILL_LEN], q_pos, pos[:PREFILL_LEN], None)
    dec_pos = torch.where(pos <= PREFILL_LEN, pos, PAD).to(torch.int32)
    qd = torch.randn(BATCH, 1, H, hd, generator=gen, device=dev).to(bf16)
    qd_pos = torch.full((1,), PREFILL_LEN, dtype=torch.int32, device=dev)
    decode = (qd, kbuf, vbuf, qd_pos, dec_pos, None)
    return prefill, decode


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def cpu_check(serve, runner, cfg, card):
    """The seed-built model cut to 2 layers, on the card (bf16, kernel) and on
    the CPU (fp32, plain path): last hidden states within 2e-2 relative L2."""
    from repro_torch.configs.base import ShapeConfig

    cfg2 = dataclasses.replace(cfg, n_layers=2)
    S = 256
    cell = runner.resolve_cell(cfg2, ShapeConfig("cpu_check", S, 1, "prefill"),
                               overrides=dict(pp=1, dp=1, n_chunks=S // 64,
                                              offload=False, remat="none"))
    params = serve.build_params(cell, "cuda", seed=0)
    prompt = np.random.default_rng(1).integers(2, cfg.vocab_size, size=(1, S)).astype(np.int32)
    tok = torch.from_numpy(prompt)
    _, x_gpu = runner.make_prefill_step(cell)(params, tok.cuda())
    x_gpu = x_gpu.float().cpu()
    params_cpu = tree_map(lambda t: t.float().cpu(), params)
    del params
    cell_cpu = dataclasses.replace(cell, dtype=torch.float32)
    _, x_cpu = runner.make_prefill_step(cell_cpu)(params_cpu, tok)
    rel = ((x_gpu - x_cpu).norm() / x_cpu.norm()).item()
    print(f"2-layer check ({card}): prefill {S} tokens in {cell.sched.n} chunks, "
          f"last hidden {tuple(x_cpu.shape)}, card bf16 vs CPU fp32 relative L2 {rel:.3e}")
    check(bool(torch.isfinite(x_gpu).all()) and rel <= 2e-2,
          f"card and CPU disagree: relative L2 {rel} > 2e-2")
    return rel


def device_time(prof, top: int = 6):
    """(total device ms, {kernel group: ms}, [(kernel, ms)] of the ``top``
    kernels) from a torch.profiler run.  Groups: the tensor-core and the
    CUDA-core forward kernels, the latter's split-KV merge kernel, the
    tensor-core and the CUDA-core dq and dk/dv backward kernels, cuBLAS
    matrix products (nvjet / gemm kernels), copies between host and device
    (which may overlap kernels: the total then exceeds the busy time),
    everything else.  Only device events count, each its own interval (one
    pass over the events: ``key_averages`` takes seconds at full depth)."""
    groups = {"attention fwd tc kernel": 0.0, "attention kernel": 0.0,
              "attention merge kernel": 0.0,
              "attention dq tc kernel": 0.0, "attention dk/dv tc kernel": 0.0,
              "attention dq kernel": 0.0, "attention dk/dv kernel": 0.0,
              "matmul": 0.0, "host copies": 0.0, "other": 0.0}
    by_name = {}
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + (
                evt.time_range.end - evt.time_range.start) / 1e3
    kernels = []
    for key, ms in by_name.items():
        if ms <= 0:
            continue
        kernels.append((key[:60], ms))
        name = key.lower()
        # the kernels' own names first: their sources' names hold "flash_partial"
        if "flash_fwd_tc_kernel" in name:
            groups["attention fwd tc kernel"] += ms
        elif "flash_bwd_dq_tc_kernel" in name:
            groups["attention dq tc kernel"] += ms
        elif "flash_bwd_dkv_tc_kernel" in name:
            groups["attention dk/dv tc kernel"] += ms
        elif "flash_bwd_dq_kernel" in name:
            groups["attention dq kernel"] += ms
        elif "flash_bwd_dkv_kernel" in name:
            groups["attention dk/dv kernel"] += ms
        elif "merge_splits" in name:
            groups["attention merge kernel"] += ms
        elif "flash_partial" in name:
            groups["attention kernel"] += ms
        elif any(tag in name for tag in ("nvjet", "gemm", "xmma", "cutlass", "matmul")):
            groups["matmul"] += ms
        elif "memcpy" in name and ("dtoh" in name or "htod" in name):
            groups["host copies"] += ms
        else:
            groups["other"] += ms
    return sum(groups.values()), groups, sorted(kernels, key=lambda kv: -kv[1])[:top]


def profile_main_path(serve, runner, cfg, warm_prefill_ms, warm_decode_ms, card):
    """Where the time goes: the main path's prefill and 4 decode steps again,
    outside the counted run, after one unprofiled prefill and decode step
    that pay the one-time costs.  The profiler records device kernels only
    (no host ops).  Device busy time over the wall time of the same profiled
    run gives the idle share; the profiler slows the host it measures, so
    the busy time is also set against phase 3's last (warm, unprofiled)
    run's wall times ``warm_prefill_ms`` and ``warm_decode_ms`` per step."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeConfig

    S, B, steps = PREFILL_LEN, BATCH, 4
    pre = runner.resolve_cell(cfg, ShapeConfig("profile", S, B, "prefill"),
                              overrides=dict(pp=1, dp=1, n_chunks=S // 64,
                                             offload=False, remat="none"))
    dec = runner.resolve_cell(cfg, ShapeConfig("profile", S, B, "decode"),
                              overrides=dict(pp=1, dp=1))
    params = serve.build_params(pre, "cuda", seed=0)
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(B, S))
    tokens = torch.from_numpy(prompts.astype(np.int32)).cuda()
    prefill, serve_step = runner.make_prefill_step(pre), runner.make_serve_step(dec)
    cur = tokens[:, -1:]
    state, _ = prefill(params, tokens)           # warm-up, unprofiled
    serve_step(params, state, cur, S)
    del state
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof_pre:
        t0 = time.perf_counter()
        state, _ = prefill(params, tokens)
        torch.cuda.synchronize()
        pre_wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=acts) as prof_dec:
        t0 = time.perf_counter()
        for i in range(steps):
            state, cur = serve_step(params, state, cur, S + i)
        torch.cuda.synchronize()
        dec_wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    pre_ms, pre_groups, pre_top = device_time(prof_pre)
    dec_ms, dec_groups, dec_top = device_time(prof_dec)
    dec_ms, dec_groups = dec_ms / steps, {k: v / steps for k, v in dec_groups.items()}
    dec_top = [(name, ms / steps) for name, ms in dec_top]
    out = {"prefill_device_ms": pre_ms, "prefill_device_ms_by_group": pre_groups,
           "prefill_profiled_wall_ms": pre_wall_ms,
           "prefill_idle_share": 1 - pre_ms / pre_wall_ms,
           "decode_step_device_ms": dec_ms, "decode_step_device_ms_by_group": dec_groups,
           "decode_step_profiled_wall_ms": dec_wall_ms,
           "decode_idle_share": 1 - dec_ms / dec_wall_ms,
           "prefill_idle_share_vs_unprofiled_wall": 1 - pre_ms / warm_prefill_ms,
           "decode_idle_share_vs_unprofiled_wall": 1 - dec_ms / warm_decode_ms}
    print(f"profile ({card}): prefill device busy {pre_ms:.1f} ms of {pre_wall_ms:.1f} ms "
          f"wall, {json.dumps(pre_groups)}; decode step device busy {dec_ms:.3f} ms of "
          f"{dec_wall_ms:.3f} ms wall, {json.dumps(dec_groups)}; unprofiled warm wall "
          f"{warm_prefill_ms:.1f} ms prefill, {warm_decode_ms:.3f} ms a decode step")
    for phase, rows in (("prefill", pre_top), ("decode step", dec_top)):
        for name, ms in rows:
            print(f"  {phase} top kernel: {ms:9.3f} ms  {name}")
    check(pre_ms > 0 and dec_ms > 0, "profiler captured no device time")
    return out


# ---------------------------------------------------------------------------
# The backward kernels (phase 2) and the training path (phase 4)
# ---------------------------------------------------------------------------


def bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, do, dl, causal=True,
                 kernels=None):
    """A pair of backward kernels (``kernels``: the wrapper's choice, None =
    by dtype) and the plain backward on the same inputs (m from the plain
    forward); fails unless that pair launched once each and each gradient is
    within 1e-5 x max |plain gradient| and finite.  Returns ({name: max
    |diff|}, {name: max |diff| / max |plain|}, kernel gradients)."""
    _, m, _ = ref.attention_partial_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                        q_start=q_start)
    before = fa.counts()
    got = fa.flash_attention_partial_bwd(q, k, v, q_pos, kv_pos, do, m, dl,
                                         causal=causal, q_start=q_start, kernels=kernels)
    moved = {key: n - before[key] for key, n in fa.counts().items() if n != before[key]}
    tc = kernels == "tensor_cores" or (kernels is None and q.dtype == torch.bfloat16)
    want_moved = {"bwd_dq_tc": 1, "bwd_dkv_tc": 1} if tc else {"bwd_dq": 1, "bwd_dkv": 1}
    check(moved == want_moved, f"the backward launched {moved}, expected {want_moved} "
          f"({q.dtype}, kernels={kernels})")
    want = ref.attention_partial_bwd_ref(q, k, v, q_pos, kv_pos, q_start, do, m, dl,
                                         causal=causal)
    torch.cuda.synchronize()
    err, rel = {}, {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = b.abs().max().item()
        err[name] = (a - b).abs().max().item()
        rel[name] = err[name] / scale if scale > 0 else err[name]
        check(bool(torch.isfinite(a).all()) and err[name] <= KERNEL_TOL * scale,
              f"{name} kernel disagrees with plain version: max err {err[name]}, "
              f"max |plain| {scale} (tol {KERNEL_TOL} x max |plain|) at q "
              f"{tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    return err, rel, got


def bwd_edge_grid(fa, ref, gen):
    """fp32 (the CUDA-core kernels) and bf16 (the tensor-core kernels): Tq =
    1, ragged Tq / S, G in {1, 4, 7, 8}, hd_k != hd_v, head dims 8 to 128,
    non-causal, PAD slots, a q_start window with fully masked rows given NaN
    cotangents (their dq must be exactly 0), a strided cache view.  Returns
    ({dtype: worst relative error}, cases)."""
    dev = "cuda"
    cases = [  # B, Tq, S, H, Hkv, hdk, hdv, causal
        (2, 17, 33, 6, 2, 16, 16, True), (1, 8, 128, 8, 1, 64, 32, True),
        (1, 16, 48, 4, 4, 32, 32, False), (2, 9, 100, 28, 4, 128, 128, True),
        (1, 1, 64, 4, 1, 32, 32, True), (3, 70, 200, 28, 4, 128, 128, True),
        (2, 5, 77, 8, 2, 24, 8, True), (1, 1, 2000, 14, 2, 128, 128, True),
        (2, 37, 150, 16, 2, 64, 32, True), (2, 37, 150, 14, 2, 64, 32, True)]
    worst, n = {}, 0

    def rand(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        for B, Tq, S, H, Hkv, hdk, hdv, causal in cases:
            q, k, v = rand(B, Tq, H, hdk, dtype=dtype), rand(B, S, Hkv, hdk, dtype=dtype), \
                rand(B, S, Hkv, hdv, dtype=dtype)
            q_pos = (torch.arange(Tq, dtype=torch.int32, device=dev) + S - Tq)[None].repeat(B, 1)
            kv_pos = torch.arange(S, dtype=torch.int32, device=dev)
            kv_pos[S - S // 10:] = PAD
            _, rel, _ = bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, None,
                                     rand(B, Tq, H, hdv), rand(B, Tq, H), causal)
            worst[str(dtype)], n = max(worst.get(str(dtype), 0.0), *rel.values()), n + 1
        # a q_start window with dead rows (PAD windows, a row that sees only
        # future slots), PAD cache slots, NaN cotangents on the dead rows
        B, Tq, S, H, Hkv, hd = 2, 8, 200, 14, 2, 128
        q, k, v = rand(B, Tq, H, hd, dtype=dtype), rand(B, S, Hkv, hd, dtype=dtype), \
            rand(B, S, Hkv, hd, dtype=dtype)
        q_pos = torch.tensor([[16 + i for i in range(Tq)], [1] + [9 + i for i in range(Tq - 1)]],
                             dtype=torch.int32, device=dev)
        q_start = torch.tensor([[0, 0, 4, 4, 4, 20, 20, PAD], [0, 3, 3, 3, 9, 9, PAD, PAD]],
                               dtype=torch.int32, device=dev)
        kv_pos = torch.arange(S, dtype=torch.int32, device=dev) + 2
        kv_pos[-3:] = PAD
        dead = ~visible_mask(B, q_pos, kv_pos, q_start).any(dim=-1)
        check(int(dead.sum()) == 4, f"expected 4 dead rows, got {int(dead.sum())}")
        do, dl = rand(B, Tq, H, hd), rand(B, Tq, H)
        do[dead], dl[dead] = float("nan"), float("nan")
        _, rel, (dq, _, _) = bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, do, dl)
        check(bool((dq[dead] == 0).all()), "fully masked rows' dq is not exactly 0")
        worst[str(dtype)], n = max(worst[str(dtype)], *rel.values()), n + 1
        # a strided prefix view of a cache buffer, q a head slice of the
        # fused q|k projection, as the training path passes them
        B, Tq, S, buf, H, Hkv, hd = 2, 24, 70, 96, 14, 2, 128
        qk = rand(B, Tq, H + Hkv, hd, dtype=dtype)
        kbuf, vbuf = rand(B, buf, Hkv, hd, dtype=dtype), rand(B, buf, Hkv, hd, dtype=dtype)
        q_pos = torch.arange(Tq, dtype=torch.int32, device=dev) + S - Tq
        _, rel, _ = bwd_vs_plain(fa, ref, qk[:, :, :H], kbuf[:, :S], vbuf[:, :S], q_pos,
                                 torch.arange(S, dtype=torch.int32, device=dev), None,
                                 rand(B, Tq, H, hd), rand(B, Tq, H))
        worst[str(dtype)], n = max(worst[str(dtype)], *rel.values()), n + 1
    return worst, n


def sdpa_backend(q, k, v, mask) -> str:
    """The backend PyTorch's scaled_dot_product_attention picks for these
    inputs (its own dispatch query), for the record."""
    names = {0: "math", 1: "flash", 2: "efficient", 3: "cudnn", 4: "overrideable"}
    if not hasattr(torch, "_fused_sdp_choice"):
        return "not reported by this torch"
    return names.get(int(torch._fused_sdp_choice(q, k, v, mask, 0.0, False,
                                                  enable_gqa=True)), "unknown")


def train_chunk_shapes(gen, runner, cfg, n_layers=TRAIN_LAYERS, seq=TRAIN_SEQ,
                       n_chunks=TRAIN_CHUNKS, dtype=torch.bfloat16, packed=None):
    """The attention kernels' inputs at a training cell's first and last
    chunks, as the path passes them: q a head slice of the fused q|k
    projection output, K and V prefix views of the seq-slot cache buffer,
    one position row shared by the batch, fp32 do and dl, and the q_start
    window (None); the chunk plan is the cell's own.  The default is the
    bf16 training cell of phase 4.  ``packed`` (a ``PackedBatch``): its rows
    are the batch, the cell is resolved with its documents' lengths and
    each chunk's window is its slice of the packed ``doc_start``."""
    from repro_torch.configs.base import ShapeConfig

    B = 1 if packed is None else packed.tokens.shape[0]
    doc_lens = None if packed is None else doc_lengths(packed)
    cell = runner.resolve_cell(dataclasses.replace(cfg, n_layers=n_layers),
                               ShapeConfig("train", seq, B, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=n_chunks,
                                              offload=False, remat="none"), dtype=dtype,
                               doc_lens=doc_lens)
    dev = "cuda"
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    kbuf = torch.randn(B, seq, Hkv, hd, generator=gen, device=dev).to(dtype)
    vbuf = torch.randn(B, seq, Hkv, hd, generator=gen, device=dev).to(dtype)
    pos = torch.arange(seq, dtype=torch.int32, device=dev)
    doc_start = None if packed is None else torch.from_numpy(packed.doc_start).to(dev)
    shapes = {}
    for name, c in (("first chunk", 0), ("last chunk", cell.sched.n - 1)):
        off, ln = cell.sched.offsets[c], cell.sched.lengths[c]
        qk = torch.randn(B, ln, H + Hkv, hd, generator=gen, device=dev).to(dtype)
        do = torch.randn(B, ln, H, hd, generator=gen, device=dev)
        dl = torch.randn(B, ln, H, generator=gen, device=dev)
        shapes[name] = (qk[:, :, :H], kbuf[:, :off + ln], vbuf[:, :off + ln],
                        pos[off:off + ln], pos[:off + ln], do, dl,
                        None if doc_start is None else doc_start[:, off:off + ln])
    return cell, shapes


# the two backward pairs: the kernels' keys in counts() and in the kernels
# line, and their kernel groups in device_time
BWD_PAIRS = {"tensor_cores": ("dq_tc", "dkv_tc"), "cuda_cores": ("dq", "dkv")}
BWD_GROUPS = {"dq_tc": "attention dq tc kernel", "dkv_tc": "attention dk/dv tc kernel",
              "dq": "attention dq kernel", "dkv": "attention dk/dv kernel"}


def fp32_check_shapes(fa, ref, gen, runner, cfg, packed=None):
    """The kernels at the chunk shapes of phase 4's 2-layer fp32 train check
    (S = 256 in 2 chunks, B 1, H 28, Hkv 4, hd 128, fp32; ``packed``: the
    packed fp32 check's rows and document windows): the forward with its
    split-KV merge, then the CUDA-core backward pair (the fp32 dispatch),
    each held to the bounds of phase 2.  Returns (forward's worst error,
    backward's worst relative error, {shape: launches})."""
    cell, shapes = train_chunk_shapes(gen, runner, cfg, n_layers=2, seq=256, n_chunks=2,
                                      dtype=torch.float32, packed=packed)
    check(cell.sched.n == 2, f"fp32 check plan has {cell.sched.n} chunks, expected 2")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    fwd_err, bwd_rel, moved = 0.0, 0.0, {}
    for name, (q, k, v, q_pos, kv_pos, do, dl, q_start) in shapes.items():
        B, Tq, H, _ = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        nsplit = fa._geometry(B, Tq, S, H // Hkv, Hkv, n_sm)[2]
        before = fa.counts()
        err, _ = kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start)
        _, rel, _ = bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, do, dl)
        moved[name] = {key: n - before[key] for key, n in fa.counts().items() if n != before[key]}
        want = {"fwd": 1, "bwd_dq": 1, "bwd_dkv": 1, **({"merge": 1} if nsplit > 1 else {})}
        check(moved[name] == want, f"fp32 check shape [{name}] launched {moved[name]}, "
              f"expected {want}")
        fwd_err, bwd_rel = max(fwd_err, err), max(bwd_rel, *rel.values())
        print(f"fp32 check shape [{name}]{'' if packed is None else ' packed'} q "
              f"{tuple(q.shape)} kv {tuple(k.shape)}: forward err "
              f"{err:.3e} ({nsplit} KV splits), backward rel err "
              + ", ".join(f"{key} {val:.2e}" for key, val in rel.items()) + f"; launched {moved[name]}")
    return fwd_err, bwd_rel, moved


def tc_issued_ops(fa, vis, G, Hkv, hdk, hdv):
    """Operations the tensor-core kernels issue for this data, split terms
    included, as modelled from their tiling in csrc/flash_partial_bwd_tc.cu
    (a model, not a reading of the card: keep it in step with the source;
    printed only, beside the bound's operations), counted over the tiles
    they visit: the dq
    kernel's (G x bq-row query tile, 64-slot KV tile) pairs that some row
    sees, 448 m16n8k16 MMAs (at hd 128: s 64, dp 3 x 64, dq 3 x 64) per
    warp of 16 live rows; the dk/dv kernel's (32 fold-order rows, 64 slots)
    pairs, 208 MMAs (s^T 16, dp^T 48, dv 96, dk 48) per 16-slot warp and
    16-row step.  Each MMA is 2 x 16 x 8 x 16 operations."""
    B, Tq, S = vis.shape
    nk, nv = -(-hdk // 16), -(-hdv // 16)
    n_kv = -(-S // 64)
    pad = torch.zeros(B, Tq, n_kv * 64, dtype=torch.bool, device=vis.device)
    pad[:, :, :S] = vis
    seen = pad.view(B, Tq, n_kv, 64).any(-1)            # [B, Tq, KV tile]
    kv_warps = torch.tensor([-(-min(64, S - 64 * j) // 16) for j in range(n_kv)],
                            device=vis.device)
    bq = min(Tq, fa.TC_DQ_ROWS // G)
    dq_mma = 0
    for q0 in range(0, Tq, bq):
        warps = -(-G * min(bq, Tq - q0) // 16)
        dq_mma += int(seen[:, q0:q0 + bq].any(1).sum()) * warps * (8 * nk + 24 * nv + 24 * nk)
    rows, dkv_mma = Tq * G, 0
    for r0 in range(0, rows, 32):
        tiles = seen[:, r0 // G:(min(r0 + 32, rows) - 1) // G + 1].any(1)   # [B, KV tile]
        steps = -(-min(32, rows - r0) // 16)
        dkv_mma += int((tiles * kv_warps).sum()) * steps * (2 * nk + 6 * nv + 12 * nv + 6 * nk)
    return {"dq_tc": 4096 * dq_mma * Hkv, "dkv_tc": 4096 * dkv_mma * Hkv}


def measure_bwd_shape(name, fa, ref, q, k, v, q_pos, kv_pos, do, dl, q_start=None):
    """Check both forward kernels (``measure_shape``: held to 1e-5, timed in
    turns, bounded) and both backward pairs at one training shape on the same bf16
    inputs, and time each backward kernel (its own device time under
    torch.profiler; one wrapper call launches a pair) with the pairs in
    turns (CUDA cores, tensor cores, tensor cores, CUDA cores), the plain
    backward and the backward of SDPA with the same mask.  Returns (the
    forward's rows, {"dq_tc", "dkv_tc", "dq", "dkv": row}).  Bounds count
    what this data needs: per visible (query, slot) pair and head, the dq
    kernel does s = q.k, dp = do.v and dq (three products), the dk/dv
    kernel s, dp, dk and dv (four); the pair's five products are 2.5x the
    forward's operations.  Bytes: the query-side rows and the K/V rows some
    query sees, read once; each output written once.  Beside the bound's
    operations, the printed line gives the operations the tensor-core
    kernels issue as modelled from their tiling (``tc_issued_ops``).  ``q_start``:
    a packed batch's [B, Tq] document window, which the bounds' visible
    pairs and rows follow."""
    fwd_rows = measure_shape(f"train {name}", fa, ref, q, k, v, q_pos, kv_pos, q_start)
    errs = {kernels: bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, do, dl,
                                  kernels=kernels)[:2] for kernels in BWD_PAIRS}
    B, Tq, H, hdk = q.shape
    S, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    vis = visible_mask(B, q_pos, kv_pos, q_start)
    n_vis = int(vis.sum())
    live_rows, kv_rows = int(vis.any(dim=2).sum()), int(vis.any(dim=1).sum())
    esz = q.element_size()
    rows_in = live_rows * H * (esz * hdk + 4 * (hdv + 2)) + kv_rows * Hkv * esz * (hdk + hdv)
    pos_bytes = 4 * (q_pos.numel() + S + (0 if q_start is None else q_start.numel()))
    ops = {"dq": 2 * H * n_vis * (hdk + hdv + hdk),
           "dkv": 2 * H * n_vis * (hdk + hdv + hdk + hdv)}
    out_bytes = {"dq": 4 * B * Tq * H * hdk, "dkv": 4 * B * S * Hkv * (hdk + hdv)}
    issued = tc_issued_ops(fa, vis, H // Hkv, Hkv, hdk, hdv)
    _, m, _ = ref.attention_partial_ref(q, k, v, q_pos, kv_pos, q_start=q_start)
    footprint = sum(t.numel() * t.element_size() for t in (q, k, v, do))
    copies = cold_copies((q, k, v, q_pos, kv_pos, do, m, dl, q_start), footprint)
    turns = {part: [] for part in BWD_GROUPS}
    for kernels in ("cuda_cores", "tensor_cores", "tensor_cores", "cuda_cores"):
        def call(*a, kernels=kernels):
            return fa.flash_attention_partial_bwd(*a[:8], q_start=a[8], kernels=kernels)

        for args in copies:
            call(*args)
        torch.cuda.synchronize()
        _, by_group = profiled_ms(call, copies, reps=6,
                                  want=[BWD_GROUPS[part] for part in BWD_PAIRS[kernels]])
        for part in BWD_PAIRS[kernels]:
            turns[part].append(by_group[BWD_GROUPS[part]])
    check(all(t > 0 for ts in turns.values() for t in ts),
          f"the profiler missed a backward kernel at [{name}]: {turns}")
    rows = {}
    for kernels, parts in BWD_PAIRS.items():
        err, rel = errs[kernels]
        for part, base in zip(parts, ("dq", "dkv")):
            t_bytes = (rows_in + pos_bytes + out_bytes[base]) / HBM_BYTES_PER_S
            t_ops = ops[base] / BF16_FLOPS
            rows[part] = {"shape": name, "q": list(q.shape), "kv": list(k.shape),
                          "dtype": str(q.dtype), "ms": sum(turns[part]) / len(turns[part]),
                          "ms_turns": turns[part], "bound_ms": 1e3 * max(t_bytes, t_ops),
                          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                          "ops": ops[base],
                          "max_abs_err": err["dq"] if base == "dq" else max(err["dk"], err["dv"]),
                          "rel_err": rel["dq"] if base == "dq" else max(rel["dk"], rel["dv"])}
    plain_ms = time_ms(lambda *a: ref.attention_partial_bwd_ref(*a[:5], a[8], *a[5:8]),
                       copies, reps=len(copies), label=f"the plain backward [{name}]")
    # SDPA's backward with the same mask: a graph per input copy, then the
    # timed calls run only the backward
    mask = vis[:, None]
    backend = sdpa_backend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask)
    graphs = []
    for cq, ck, cv, *_rest in copies:
        leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (cq, ck, cv)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask, enable_gqa=True)
        graphs.append((out, leaves, torch.randn_like(out)))
    lib_ms = time_ms(lambda out, leaves, g: torch.autograd.grad(out, leaves, g,
                                                                retain_graph=True),
                     graphs, reps=6, label=f"the sdpa backward [{name}]")
    del graphs
    for row in rows.values():
        row.update(plain_ms=plain_ms, library_ms=lib_ms, library=f"sdpa backward ({backend})")
    pair_ops = 2 * H * n_vis * (3 * hdk + 2 * hdv)
    for kernels, (dq, dkv) in BWD_PAIRS.items():
        a, b = rows[dq], rows[dkv]
        print(f"bwd kernels [{name}] {kernels} ({q.dtype}) q {tuple(q.shape)} kv {tuple(k.shape)}: "
              f"dq {a['ms']:.3f} ms (turns {', '.join(f'{t:.3f}' for t in a['ms_turns'])}; err "
              f"{a['max_abs_err']:.3e}, rel {a['rel_err']:.2e}), dk/dv {b['ms']:.3f} ms (turns "
              f"{', '.join(f'{t:.3f}' for t in b['ms_turns'])}; err {b['max_abs_err']:.3e}, rel "
              f"{b['rel_err']:.2e})" + (f"; modelled from the tiling, issued {issued[dq]:.3e} / "
                                        f"{issued[dkv]:.3e} ops against the bound's {a['ops']:.3e}"
                                        f" / {b['ops']:.3e}" if dq in issued else ""))
    print(f"bwd [{name}]: tensor cores / CUDA cores: dq {rows['dq_tc']['ms'] / rows['dq']['ms']:.3f}, "
          f"dk/dv {rows['dkv_tc']['ms'] / rows['dkv']['ms']:.3f}; plain {plain_ms:.3f} ms, sdpa "
          f"backward ({backend}) {lib_ms:.3f} ms; bounds {rows['dq']['bound_ms']:.4f} / "
          f"{rows['dkv']['bound_ms']:.4f} ms ({rows['dq']['bound_by']}), the pair's five products "
          f"{pair_ops:.3e} ops = {1e3 * pair_ops / BF16_FLOPS:.4f} ms; fp32 outside the tensor "
          f"cores at the data sheet's {FP32_FLOPS / 1e12:.0f} TFLOP/s would take "
          f"{1e3 * ops['dq'] / FP32_FLOPS:.4f} / {1e3 * ops['dkv'] / FP32_FLOPS:.4f} ms")
    return fwd_rows, rows


def attention_ops(cell) -> float:
    """Operations of a training step's attention that the data needs:
    per layer and chunk, the visible (query, slot) pairs x heads x (the
    forward's q.k and p.v, 4 hd, plus the backward's five products, 10 hd)."""
    cfg = cell.cfg
    pairs = sum(ln * off + ln * (ln + 1) // 2
                for off, ln in zip(cell.sched.offsets, cell.sched.lengths))
    return cell.shape.global_batch * pairs * cfg.n_heads * 14 * cfg.hd * cfg.n_layers


# the training plans of phase 4, as plan overrides of ``launch.train.train``;
# (d) passes none: the reference's default plan
PLANS = {"a": ("offload off, remat none", dict(offload=False, remat="none")),
         "b": ("offload off, remat sppo", dict(offload=False, remat="sppo")),
         "c": ("offload on, prefetch sync", dict(prefetch="sync")),
         "d": ("offload on, prefetch ahead (the default plan)", None),
         "e": ("offload off, remat full", dict(offload=False, remat="full"))}
PLAN_FORM = {"a": (False, "none", None), "b": (False, "sppo", None), "c": (True, "sppo", "sync"),
             "d": (True, "sppo", "ahead"), "e": (False, "full", None)}


def merged(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(iv, union, starts):
    """Microseconds of the interval ``iv`` covered by the disjoint sorted
    ``union`` (``starts``: its start points)."""
    a, b = iv
    k = max(0, bisect.bisect_right(starts, a) - 1)
    cov = 0.0
    while k < len(union) and union[k][0] < b:
        cov += max(0.0, min(b, union[k][1]) - max(a, union[k][0]))
        k += 1
    return cov


def copy_timeline(prof, moment_copies=(0, 0)):
    """From a torch.profiler run's device events: the device's busy time
    (the union of every kernel's and copy's interval), and for the pinned
    D2H and H2D copies of the activation rows (pageable scalar reads are
    left out where the names tell them apart) their device ms, the share of
    it that overlaps some compute kernel, and the ms that does not
    (exposed).  ``moment_copies``: (H2D, D2H) copies the update made; they
    are told apart as the copies on the streams (``device_resource_id``)
    that carry no kernel and one direction only (the rows' copy stream
    carries both), and their device ms, exposed ms (the union of their
    intervals not covered by a compute kernel) and window are reported
    apart."""
    kern, copies, names, kernel_streams = [], [], set(), set()
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        iv = (evt.time_range.start, evt.time_range.end)
        name = evt.name.lower()
        stream = getattr(evt, "device_resource_id", None)
        if "memcpy" in name and ("dtoh" in name or "htod" in name):
            names.add(evt.name)
            copies.append((iv, "d2h" if "dtoh" in name else "h2d", "pinned" in name, stream))
        else:
            kern.append(iv)
            kernel_streams.add(stream)
    union = merged(kern)
    starts = [a for a, _ in union]
    out = {"device_busy_ms": sum(b - a for a, b in merged(
        kern + [c[0] for c in copies])) / 1e3, "copy_event_names": sorted(names)}
    n_way = dict(zip(("h2d", "d2h"), moment_copies))
    moment = set()
    if any(moment_copies):
        by_stream = {}
        for i, (_, way, _, stream) in enumerate(copies):
            if stream not in kernel_streams:
                by_stream.setdefault(stream, []).append(i)
        ways_by_stream, seen = {}, {}
        for stream, idx in by_stream.items():
            ways = {copies[i][1] for i in idx}
            ways_by_stream[str(stream)] = {w: sum(copies[i][1] == w for i in idx) for w in ways}
            if len(ways) == 1:          # the rows' stream carries both directions
                seen.setdefault(ways.pop(), []).append(idx)
        # CUPTI may not deliver every record of a step this busy: a run of
        # the full-depth fp8 cell saw 1466 of the 1468 D2H moment copies that
        # runtime/hostmem.py counted (and train_plan held to the closed
        # form).  At most MISSED_COPY_SHARE of each direction may be missing
        # from the profile, none may be extra.
        ok = all(len(seen.get(w, [])) == 1 and
                 n_way[w] * (1 - MISSED_COPY_SHARE) <= len(seen[w][0]) <= n_way[w]
                 for w in n_way)
        check(ok, f"the profile's moment copies do not match the {moment_copies} (H2D, D2H) "
                  f"the update made: kernel-free streams' copies {ways_by_stream}")
        moment = {i for w in n_way for i in seen[w][0]}
        out["moment_copies_seen"] = {w: len(seen[w][0]) for w in n_way}
        ivs = [copies[i][0] for i in moment]
        cover = sum(overlap_us(iv, union, starts) for iv in merged(ivs))
        span = merged(ivs)
        out.update({"moment_h2d_ms": sum(b - a for i in moment if copies[i][1] == "h2d"
                                         for a, b in [copies[i][0]]) / 1e3,
                    "moment_d2h_ms": sum(b - a for i in moment if copies[i][1] == "d2h"
                                         for a, b in [copies[i][0]]) / 1e3,
                    "moment_copy_union_ms": sum(b - a for a, b in span) / 1e3,
                    "moment_exposed_ms": (sum(b - a for a, b in span) - cover) / 1e3,
                    "moment_window_ms": (max(b for _, b in span) - min(a for a, _ in span)) / 1e3})
    for way in ("d2h", "h2d"):
        evs = [(c[0], c[2]) for i, c in enumerate(copies) if c[1] == way and i not in moment]
        pinned = [iv for iv, p in evs if p] if any(p for _, p in evs) else [iv for iv, _ in evs]
        ms = sum(b - a for a, b in pinned) / 1e3
        cov = sum(overlap_us(iv, union, starts) for iv in pinned) / 1e3
        out[f"{way}_ms"] = ms
        out[f"{way}_overlap_share"] = cov / ms if ms > 0 else None
        out[f"{way}_exposed_ms"] = ms - cov
        out[f"{way}_copies"] = len(pinned)
    return out


def offload_bytes(cell) -> int:
    """D2H bytes of one step by the port's cost model: Σ over chunks of
    split_rows(rows, α_c) x batch x the tagged bytes of a token in every
    layer (bf16), times the codec's wire ratio (its 1-byte payload; the
    scales stay on the device)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import offload as ofl

    per_row = (cell.shape.global_batch * cm.tagged_bytes_per_token(cell.cfg) * cell.cfg.n_layers
               * cm.offload_wire_ratio(cell.plan.offload_dtype))
    return int(sum(ofl.split_rows(ln, a) * per_row
                   for ln, a in zip(cell.sched.lengths, cell.alphas)))


def param_shapes(cell) -> list:
    """The cell's parameter shapes, built on the meta device."""
    from repro_torch.core import tree

    gen = torch.Generator()
    params = {"stages": cell.mdef.init_stage_params(gen, device="meta"),
              "globals": cell.mdef.init_globals(gen, device="meta")}
    return [tuple(t.shape) for t in tree.leaves(params)]


def moment_copies(cell) -> tuple:
    """(bytes, copies) one update moves each way by the closed form: the
    fp32 moments, or a codec's payload and scales; one copy per host tensor
    (m and v per leaf, each a pair under a codec); (0, 0) on the device."""
    from repro_torch.core import costmodel as cm

    if not cell.plan.offload_moments:
        return 0, 0
    shapes = param_shapes(cell)
    per_leaf = 2 if cell.plan.moments_dtype == "none" else 4
    return (int(cm.moment_bytes_from_shapes(shapes, "float32", cell.plan.moments_dtype)),
            per_leaf * len(shapes))


def grads_call(serve, runner, cell, seq, *, keep=True):
    """One untimed loss-and-gradients call of ``cell`` on fresh weights
    (seed 0) and step 0's tokens, outside the training run.  Returns the
    allocator's peak during it less the weights it started from (the
    activations, the host-copy staging and the gradients, without AdamW's
    moments and temporaries) and the gradients, on the host, by path (None
    without ``keep``)."""
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM

    params = serve.build_params(cell, "cuda", seed=0)
    tokens, labels = (torch.from_numpy(a).cuda() for a in
                      SyntheticLM(cell.cfg.vocab_size, seq, 1).sample_step(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, grads = runner.loss_and_grads(cell, params, tokens, labels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    grads = {path: g.cpu() for path, g in tree.items(grads)} if keep else None
    del params
    torch.cuda.empty_cache()
    return peak, grads


def compare_grads(grads, ref, plan, ref_plan, label, *, bitwise):
    """Holds one plan's step-0 gradients against another's: every leaf
    bitwise equal (``bitwise``; the embedding table's too, its backward
    deterministic since the gather is ``F.embedding``), or within
    GRAD_PLAN_TOL relative L2 at the worst leaf.  Returns (worst relative
    L2, whether every leaf was bitwise equal)."""
    worst, differ = 0.0, []
    for path, g in grads.items():
        want = ref[path]
        rel = ((g.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30)).item()
        worst = max(worst, rel)
        if not torch.equal(g, want):
            differ.append((path, rel))
    check(not (bitwise and differ),
          f"[{label}] plan ({plan})'s step-0 gradients differ from ({ref_plan})'s at "
          f"{len(differ)} leaves, expected bitwise equal: {differ[:8]}")
    check(worst <= GRAD_PLAN_TOL, f"[{label}] plan ({plan})'s step-0 gradients differ from "
                                  f"({ref_plan})'s by {worst:.3e} relative L2 at the worst leaf "
                                  f"(tol {GRAD_PLAN_TOL})")
    print(f"train [{label}] plan ({plan}) step-0 gradients vs ({ref_plan})'s: "
          f"{'bitwise equal' if not differ else f'{len(differ)} leaves differ'} (every leaf, "
          f"the embedding's included); worst leaf relative L2 {worst:.3e}")
    return worst, not differ


def train_plan(fa, hostmem, serve, runner, train_mod, cfg, card, plan, *, seq, n_chunks,
               steps, label, extra=None, grads="keep", packed=None):
    """One training plan through ``launch.train.train``, as the CLI runs it,
    counted and timed: each step's kernel launches and host copies, the last
    step under torch.profiler (device busy and idle, kernel groups, copy
    overlap).  ``extra``: plan overrides beside the plan's own (the moment
    offload, the codecs).  Checks the launches (remat "none": one each of
    the tensor-core forward, dq and dk/dv a step per layer and chunk;
    "sppo" and "full": the forward twice that, its replay), no CUDA-core
    launch, finite losses, that the D2H bytes of every step equal the cost
    model's closed form (at the codec's payload under one), the H2D bytes
    the D2H bytes and every host buffer pinned, and, with the moments in
    host memory, that each step's moment copies move the closed form's
    bytes each way, one copy per host tensor, into pinned buffers.  Then
    one untimed loss-and-gradients call (``grads_call``; ``grads``: "keep"
    its gradients, "peak" read its peak only, "none" skip it).  ``packed``:
    a ``PackedBatch`` trained on at every step (``train(packed=)``), its rows
    the batch; each step then launches each kernel once a microbatch more
    (``grad_accum``), and the untimed call is skipped.  Returns the launch
    counts, a summary and that call's gradients."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import costmodel as cm
    from repro_torch.core import offload as ofl

    what, overrides = PLANS[plan]
    if extra:
        what = f"{what}, {', '.join(f'{k}={v}' for k, v in extra.items())}"
        overrides = {**(overrides or {}), **extra}
    after, prof = [], {}

    def on_step(step, rec):
        after.append({**fa.counts(), **{"copy_" + k: v for k, v in hostmem.counts().items()}})

    def step_context(step):
        if step != steps - 1:
            return contextlib.nullcontext()
        prof["p"] = profile(activities=[ProfilerActivity.CUDA])
        return prof["p"]

    check(packed is None or grads == "none", "a packed run takes no untimed gradients call")
    batch = 1 if packed is None else packed.tokens.shape[0]
    fa.reset_counts()
    hostmem.reset_counts()
    t0 = time.perf_counter()
    out = train_mod.train(cfg, steps=steps, seq=seq, batch=batch, n_chunks=n_chunks,
                          log_every=steps, device="cuda", overrides=overrides,
                          on_step=on_step, step_context=step_context, packed=packed)
    seconds = {"train_call": time.perf_counter() - t0}
    totals = after[-1]
    cell, hist = out["cell"], out["history"]
    offload, remat, prefetch = PLAN_FORM[plan]
    check((cell.plan.offload, cell.plan.remat) == (offload, remat)
          and (prefetch is None or cell.plan.prefetch == prefetch)
          and all(getattr(cell.plan, k) == v for k, v in (extra or {}).items()),
          f"plan ({plan}) resolved to {cell.plan}")
    per_step = [{k: a[k] - b.get(k, 0) for k in a} for a, b in zip(after, [{}] + after[:-1])]
    n_calls = cfg.n_layers * cell.sched.n * cell.plan.grad_accum
    fwd_want = n_calls * (1 if cell.plan.remat == "none" else 2)
    bytes_want = offload_bytes(cell)
    mom_bytes, mom_copies = moment_copies(cell)
    for step, c in enumerate(per_step):
        check(c["fwd_tc"] == fwd_want and c["bwd_dq_tc"] == n_calls
              and c["bwd_dkv_tc"] == n_calls and c["merged_in_kernel"] == 0
              and c["fwd"] == c["bwd_dq"] == c["bwd_dkv"] == c["merge"] == 0,
              f"[{label}] step {step} launched {c}; expected {fwd_want} tensor-core forward "
              f"and {n_calls} each of dq and dk/dv, no split and no CUDA-core launch")
        check(c["copy_d2h_bytes"] == bytes_want and c["copy_h2d_bytes"] == bytes_want
              and c["copy_d2h_pinned"] == c["copy_d2h"] == c["copy_h2d"],
              f"[{label}] step {step} copied {c}; expected {bytes_want} bytes each way by the "
              f"closed form, every host buffer pinned")
        check(c["copy_moment_d2h_bytes"] == c["copy_moment_h2d_bytes"] == mom_bytes
              and c["copy_moment_d2h"] == c["copy_moment_h2d"] == c["copy_moment_d2h_pinned"]
              == mom_copies,
              f"[{label}] step {step} moved moments {c}; expected {mom_bytes} bytes and "
              f"{mom_copies} copies each way by the closed form, into pinned buffers")
    losses = [r["loss"] for r in hist]
    check(len(hist) == steps and all(np.isfinite(losses)), f"[{label}] losses {losses}")
    t0 = time.perf_counter()
    timeline = copy_timeline(prof["p"], (mom_copies, mom_copies))
    if bytes_want:
        check(timeline["d2h_ms"] > 0 and timeline["h2d_ms"] > 0,
              f"[{label}] the profiler saw no offload copy: {timeline}")
    busy_k, groups, _ = device_time(prof["p"])
    seconds["profile_reading"] = time.perf_counter() - t0
    prof_wall = 1e3 * hist[-1]["dt"]
    warm = [1e3 * r["dt"] for r in hist[1:-1]] or [prof_wall]
    warm_ms = sum(warm) / len(warm)
    busy = timeline["device_busy_ms"]
    acts = cm.chunk_act_bytes(cell.cfg, cell.sched.lengths, batch=batch, pp=1, sp=1,
                              grad_accum=cell.plan.grad_accum)
    quantized = [ofl.quantized_alpha(ln, a) for ln, a in zip(cell.sched.lengths, cell.alphas)]
    peak, base, host_moments = out["peak_bytes"], out["base_bytes"], out["host_moment_bytes"]
    del out
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lg_peak, grad_tree = (grads_call(serve, runner, cell, seq, keep=grads == "keep")
                          if grads != "none" else (None, None))
    seconds["grads_call"] = time.perf_counter() - t0
    row = {"plan": plan, "what": what, "seq": seq, "layers": cfg.n_layers, "batch": batch,
           "grad_accum": cell.plan.grad_accum, "chunks": list(cell.sched.lengths),
           "alphas": list(cell.alphas), "quantized_alphas": quantized,
           "losses": losses, "step_s": [r["dt"] for r in hist],
           "tokens_per_s": [r["tgs"] for r in hist], "mfu": [r["mfu"] for r in hist],
           "warm_step_ms": warm_ms, "peak_bytes": peak, "base_bytes": base,
           "host_moment_bytes": host_moments,
           "grads_peak_over_weights_bytes": lg_peak,
           "tagged_peak_model_bytes": ofl.peak_memory(acts, quantized),
           "d2h_bytes_per_step": per_step[-1]["copy_d2h_bytes"],
           "h2d_bytes_per_step": per_step[-1]["copy_h2d_bytes"],
           "moment_bytes_each_way_per_step": per_step[-1]["copy_moment_d2h_bytes"],
           "launches_per_step": {k: v for k, v in per_step[-1].items() if not k.startswith("copy_")},
           "profiled_wall_ms": prof_wall, "device_busy_ms": busy,
           "device_kernel_ms_by_group": groups, "kernel_ms_sum": busy_k,
           "idle_share": 1 - busy / prof_wall, "idle_share_vs_unprofiled_wall": 1 - busy / warm_ms,
           **{k: v for k, v in timeline.items() if k != "device_busy_ms"},
           "smoke_seconds": seconds}
    print_plan(row, hist, cell, card, label, steps)
    return totals, row, grad_tree


def print_plan(row, hist, cell, card, label, steps):
    gib = 2**30
    print(f"train [{label}] plan ({row['plan']}) {row['what']} ({card}): chunks "
          f"{cell.sched.lengths}, alpha deployed [{', '.join(f'{a:.4f}' for a in cell.alphas)}], "
          f"quantized [{', '.join(f'{a:.4f}' for a in row['quantized_alphas'])}]")
    for r in hist:
        print(f"  step {r['step']}: loss {r['loss']!r}, {r['dt']:.4f} s, {r['tgs']:.1f} tokens/s, "
              f"MFU {r['mfu']:.4f}" + (" [profiled]" if r["step"] == steps - 1 else ""))
    lg = row["grads_peak_over_weights_bytes"]
    print(f"  warm step {row['warm_step_ms']:.1f} ms (unprofiled mean of steps 1..{steps - 2}); "
          f"peak {row['peak_bytes'] / gib:.3f} GiB over the {steps} steps (weights and moments "
          f"on the device {row['base_bytes'] / gib:.3f} GiB, moments in host memory "
          f"{row['host_moment_bytes'] / gib:.3f} GiB); one untimed loss-and-gradients call peaks "
          + (f"{lg / gib:.3f} GiB above its weights" if lg is not None else "(not run)")
          + f"; the cost model's tagged-activation peak (peak_memory of chunk_act_bytes at the "
          f"quantized alphas) {row['tagged_peak_model_bytes'] / gib:.3f} GiB")
    print(f"  smoke seconds {json.dumps({k: round(v, 2) for k, v in row['smoke_seconds'].items()})}")
    print(f"  device busy {row['device_busy_ms']:.1f} ms of {row['profiled_wall_ms']:.1f} ms "
          f"profiled wall (idle {row['idle_share']:.3f}; {row['idle_share_vs_unprofiled_wall']:.3f} "
          f"against the unprofiled warm wall); kernels by group "
          f"{json.dumps(row['device_kernel_ms_by_group'])}")
    print(f"  copies a step: D2H {row['d2h_bytes_per_step']} bytes, H2D "
          f"{row['h2d_bytes_per_step']} bytes; device ms DtoH {row['d2h_ms']:.3f} "
          f"({row['d2h_copies']} copies, overlap with compute {row['d2h_overlap_share']}, "
          f"exposed {row['d2h_exposed_ms']:.3f} ms), HtoD {row['h2d_ms']:.3f} "
          f"({row['h2d_copies']} copies, overlap {row['h2d_overlap_share']}, exposed "
          f"{row['h2d_exposed_ms']:.3f} ms); copy events {row['copy_event_names']}")
    if row["moment_bytes_each_way_per_step"]:
        print(f"  moments a step: {row['moment_bytes_each_way_per_step']} bytes each way; device "
              f"ms HtoD {row['moment_h2d_ms']:.3f}, DtoH {row['moment_d2h_ms']:.3f}, their union "
              f"{row['moment_copy_union_ms']:.3f} over a {row['moment_window_ms']:.3f} ms window, "
              f"exposed (no compute kernel beside) {row['moment_exposed_ms']:.3f} ms")


def link_rate(hostmem, card):
    """The pinned D2H and H2D rates of a 1 GiB copy, timed by CUDA events
    (5 copies each way after one warm-up), beside the cost model's data-sheet
    link rate."""
    from repro_torch.core.costmodel import H100

    n = 1 << 30
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    check(host.is_pinned(), "a pinned 1 GiB host buffer came back pageable")
    rates = {}
    for way, (dst, src) in (("d2h", (host, dev)), ("h2d", (dev, host))):
        dst.copy_(src, non_blocking=True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            dst.copy_(src, non_blocking=True)
        end.record()
        end.synchronize()
        rates[way] = 5 * n / (start.elapsed_time(end) / 1e3)
    print(f"link ({card}): pinned 1 GiB copies D2H {rates['d2h'] / 1e9:.2f} GB/s, H2D "
          f"{rates['h2d'] / 1e9:.2f} GB/s; the cost model's H100.d2h_bw {H100.d2h_bw / 1e9:.0f} "
          f"GB/s (data sheet, PCIe Gen5 x16), left as it is")
    del dev, host
    return rates


def embed_check(card):
    """The deterministic embedding backward (``layers.embed_tokens``, an
    ``F.embedding`` gather) at the train cell's shape, qwen2-7b's padded
    table (153600 x 3584, bf16) and step 0's 8192 token ids: two calls give
    bitwise the same table gradient, and its cost against the
    ``index_select`` gather it replaced (forward and backward, CUDA events,
    in turns), printed with whether that one was bitwise repeatable."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import layers as L
    from repro_torch.models.model_zoo import build_model

    cfg = get_config("qwen2-7b")
    gen = torch.Generator(device="cuda").manual_seed(3)
    shape = build_model(cfg).init_globals(torch.Generator(), device="meta")["embed"]["table"].shape
    table = (0.02 * torch.randn(*shape, device="cuda", generator=gen)).to(torch.bfloat16)
    ids = torch.from_numpy(SyntheticLM(cfg.vocab_size, TRAIN_SEQ, 1).sample_step(0)[0]).cuda()
    gout = torch.randn(*ids.shape, cfg.d_model, device="cuda", generator=gen).to(torch.bfloat16)

    def index_select_gather(t):
        return t.index_select(0, ids.reshape(-1).long()).reshape(*ids.shape, -1)

    def grad(fn):
        t = table.detach().requires_grad_()
        return torch.autograd.grad(fn(t), t, gout)[0]

    def port(t):
        return L.embed_tokens(ids, t)

    repeat = {name: torch.equal(grad(fn), grad(fn))
              for name, fn in (("embedding", port), ("index_select", index_select_gather))}
    check(repeat["embedding"], "two calls of the embedding backward on the same ids differ")
    ms = {"embedding": [], "index_select": []}
    for name in ("index_select", "embedding", "embedding", "index_select"):
        fn = port if name == "embedding" else index_select_gather
        grad(fn)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            grad(fn)
        end.record()
        end.synchronize()
        ms[name].append(start.elapsed_time(end) / 10)
    out = {k: sum(v) / len(v) for k, v in ms.items()}
    print(f"embedding ({card}): table {tuple(table.shape)} bf16, {ids.numel()} ids of step 0: "
          f"forward and backward F.embedding {out['embedding']:.4f} ms, index_select "
          f"{out['index_select']:.4f} ms (turns {ms}); bitwise repeatable: {repeat}")
    return {"embed_ms": out, "embed_ms_turns": ms, "embed_bitwise_repeatable": repeat}


def rel_l2(got, want) -> float:
    """Relative L2 of ``got`` against ``want`` over every leaf (dicts path
    -> tensor, on the host or the card), summed on the card in fp64."""
    num = den = 0.0
    for path, w in want.items():
        w = w.cuda().float()
        g = got[path].cuda().float()
        num += torch.linalg.vector_norm(g - w, dtype=torch.float64).item() ** 2
        den += torch.linalg.vector_norm(w, dtype=torch.float64).item() ** 2
    return (num / max(den, 1e-300)) ** 0.5


def moment_phase(hostmem, serve, runner, cfg4, card, ref_grads):
    """The moment offload and the codecs on the 4-layer S = 8192 cell, the
    default plan, steps driven through ``runner.make_train_step`` as
    ``launch.train.train`` drives them (same data, schedule and seed).

    1. fp32 moments in pinned host memory and on the device, in lockstep
       for MOMENT_STEPS steps: the losses, the parameters and both moments
       bitwise equal after every step; each step moves ``opt_state_bytes``
       each way, one copy per host tensor into a pinned buffer; every host
       moment is pinned.  Then one more update of each on the same
       gradients: the offloaded update's device peak above what was
       allocated before it is at most the on-device update's plus the
       moments of two leaves (the bound of ``optim/adamw.py``).
    2. The codecs, MOMENT_STEPS steps each: ``offload_dtype`` fp8 and
       int8, ``moments_dtype`` fp8 and int8: the activation bytes each way
       equal the closed form at the codec's α (payload bytes), the moment
       bytes theirs; the step-0 loss within CODEC_LOSS_TOL of the
       uncompressed run's; the step-0 gradients (an untimed call) within
       CODEC_GRAD_TOL of the default plan's (``ref_grads``), drifting under
       an activation codec; the parameters after two updates within
       CODEC_PARAM_TOL of the uncompressed run's, and not equal."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import costmodel as cm
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.optim import adamw

    gib = 2**30
    shape = ShapeConfig("moments", TRAIN_SEQ, 1, "train")
    lr_kwargs = dict(peak=3e-4, warmup=20, total=100)       # train()'s at its default lr

    def cell_for(**ov):
        return runner.resolve_cell(cfg4, shape, overrides=dict(pp=1, dp=1,
                                                               n_chunks=TRAIN_CHUNKS, **ov))

    def start(cell):
        params = serve.build_params(cell, "cuda", seed=0)
        plan = cell.plan
        state = adamw.init_state(params, offload_moments=plan.offload_moments,
                                 moments_dtype=plan.moments_dtype)
        return params, state, runner.make_train_step(cell, lr_kwargs=lr_kwargs)

    data = SyntheticLM(cfg4.vocab_size, TRAIN_SEQ, 1)
    batches = [tuple(torch.from_numpy(a).cuda() for a in data.sample_step(s))
               for s in range(MOMENT_STEPS)]
    ref_grads = {path: g.cuda() for path, g in ref_grads.items()}
    ref_cell, on_cell = cell_for(), cell_for(offload_moments=True)
    p_ref, s_ref, step_ref = start(ref_cell)
    p_on, s_on, step_on = start(on_cell)
    host = tree.leaves([s_on.m, s_on.v])
    check(all(t.device.type == "cpu" and t.is_pinned() for t in host),
          "a host moment buffer is not pinned")
    mom_bytes, mom_copies = moment_copies(on_cell)
    check(mom_bytes == cm.opt_state_bytes(sum(t.numel() for t in tree.leaves(p_ref))),
          "the moment closed forms disagree")
    ref_losses, ref_after_two, step_s = [], None, {"on": [], "off": []}
    for step, (tok, lab) in enumerate(batches):
        t0 = time.perf_counter()
        p_ref, s_ref, m_ref = step_ref(p_ref, s_ref, tok, lab)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        hostmem.reset_counts()
        p_on, s_on, m_on = step_on(p_on, s_on, tok, lab)
        torch.cuda.synchronize()
        step_s["off"].append(t1 - t0)
        step_s["on"].append(time.perf_counter() - t1)
        c = hostmem.counts()
        check(c["moment_d2h_bytes"] == c["moment_h2d_bytes"] == mom_bytes
              and c["moment_d2h"] == c["moment_h2d"] == c["moment_d2h_pinned"] == mom_copies,
              f"[moments] step {step} moved {c}; expected {mom_bytes} bytes and {mom_copies} "
              f"pinned copies each way")
        loss_ref, loss_on = float(m_ref["loss"]), float(m_on["loss"])
        check(loss_ref == loss_on, f"[moments] step {step} loss {loss_on!r} with the moments in "
                                   f"host memory, {loss_ref!r} on the device")
        differ = [path for (path, a), b in zip(tree.items(p_on), tree.leaves(p_ref))
                  if not torch.equal(a, b)]
        for name, hosts, devs in (("m", s_on.m, s_ref.m), ("v", s_on.v, s_ref.v)):
            differ += [f"{name}:{path}" for (path, h), d in zip(tree.items(hosts), tree.leaves(devs))
                       if not torch.equal(h.cuda(), d)]
        check(not differ, f"[moments] after step {step} offload on and off differ at {differ[:8]}")
        ref_losses.append(loss_ref)
        if step == 1:
            ref_after_two = {path: t.clone() for path, t in tree.items(p_ref)}
    print(f"train [moments] ({card}) 4 layers, S = {TRAIN_SEQ}, default plan: fp32 moments in "
          f"pinned host memory == on the device, bitwise (losses, parameters, m, v) after each of "
          f"{MOMENT_STEPS} steps; {mom_bytes} bytes and {mom_copies} copies each way a step; "
          f"losses {ref_losses}; lockstep step s on {step_s['on']}, off {step_s['off']}")
    _, grads = runner.loss_and_grads(ref_cell, p_ref, *batches[0])

    def update_extra(params, state, offload):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        adamw.apply_update(params, grads, state, lr=1e-5, offload_moments=offload)
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated() - base

    extra_off = update_extra(p_ref, s_ref, False)
    extra_on = update_extra(p_on, s_on, True)
    leaf_moments = 8 * max(t.numel() for t in tree.leaves(p_ref))
    print(f"train [moments] update's device peak above its start: moments on the device "
          f"{extra_off / gib:.3f} GiB, in host memory {extra_on / gib:.3f} GiB; the largest "
          f"leaf's m and v {leaf_moments / gib:.3f} GiB, all moments {mom_bytes / gib:.3f} GiB")
    check(extra_on <= extra_off + 2 * leaf_moments,
          f"the offloaded update held {extra_on} bytes above its start, more than the on-device "
          f"update's {extra_off} plus two leaves' moments ({2 * leaf_moments})")
    out = {"moments_lockstep_losses": ref_losses, "moments_lockstep_step_s": step_s,
           "update_extra_bytes": {"device": extra_off, "host": extra_on},
           "largest_leaf_moment_bytes": leaf_moments}
    del p_ref, s_ref, p_on, s_on, grads, step_ref, step_on
    torch.cuda.empty_cache()
    codecs = {}
    for kind, codec in (("offload_dtype", "fp8"), ("offload_dtype", "int8"),
                        ("moments_dtype", "fp8"), ("moments_dtype", "int8")):
        ov = {kind: codec, **({"offload_moments": True} if kind == "moments_dtype" else {})}
        cell = cell_for(**ov)
        params, state, step_fn = start(cell)
        want, (mom_bytes, mom_copies) = offload_bytes(cell), moment_copies(cell)
        losses, param_drift = [], None
        for step, (tok, lab) in enumerate(batches):
            hostmem.reset_counts()
            params, state, met = step_fn(params, state, tok, lab)
            torch.cuda.synchronize()
            c = hostmem.counts()
            check(c["d2h_bytes"] == c["h2d_bytes"] == want > 0
                  and c["moment_d2h_bytes"] == c["moment_h2d_bytes"] == mom_bytes
                  and c["moment_d2h"] == c["moment_d2h_pinned"] == mom_copies,
                  f"[{kind}={codec}] step {step} copied {c}; expected {want} activation bytes "
                  f"and {mom_bytes} moment bytes each way")
            losses.append(float(met["loss"]))
            if step == 1:
                param_drift = rel_l2(dict(tree.items(params)), ref_after_two)
        del params, state, step_fn
        torch.cuda.empty_cache()
        # step 0's gradients on fresh weights, as grads_call takes them
        _, g = runner.loss_and_grads(cell, serve.build_params(cell, "cuda", seed=0),
                                     *batches[0])
        grad_drift = rel_l2(dict(tree.items(g)), ref_grads)
        del g
        loss_drift = abs(losses[0] - ref_losses[0]) / abs(ref_losses[0])
        print(f"train [{kind}={codec}] ({card}) alpha {[round(a, 4) for a in cell.alphas]}: "
              f"activation bytes {want} each way, moment bytes {mom_bytes}; losses {losses} "
              f"(uncompressed {ref_losses}); step-0 loss drift {loss_drift:.3e} (tol "
              f"{CODEC_LOSS_TOL}), step-0 gradient drift {grad_drift:.3e} (tol "
              f"{CODEC_GRAD_TOL[codec]}), parameter drift after two updates {param_drift:.3e} "
              f"(tol {CODEC_PARAM_TOL[codec]})")
        check(all(np.isfinite(losses)) and loss_drift <= CODEC_LOSS_TOL,
              f"[{kind}={codec}] losses {losses} against {ref_losses}")
        check(grad_drift <= CODEC_GRAD_TOL[codec] and (grad_drift > 0) == (kind == "offload_dtype"),
              f"[{kind}={codec}] step-0 gradient drift {grad_drift}")
        check(0 < param_drift <= CODEC_PARAM_TOL[codec],
              f"[{kind}={codec}] parameter drift after two updates {param_drift}")
        codecs[f"{kind}={codec}"] = {"alphas": list(cell.alphas), "losses": losses,
                                     "activation_bytes_each_way": want,
                                     "moment_bytes_each_way": mom_bytes,
                                     "loss_drift": loss_drift, "grad_drift": grad_drift,
                                     "param_drift_after_two_updates": param_drift}
    out["codecs"] = codecs
    return out


def full_depth_phase(fa, hostmem, serve, runner, train_mod, cfg, card):
    """qwen2-7b at all 28 layers, S = 8192 (4 FLOPs-balanced chunks), B = 1,
    the default plan with the moments in pinned host memory, FULL_STEPS
    steps through ``launch.train.train`` for each moment setting of
    FULL_DEPTH_MOMENTS (``train_plan``'s checks: 28 x 4 launches of dq and
    dk/dv and twice that of the forward a step, the rows' and the moments'
    bytes by the closed forms, pinned, finite losses), the step's device
    peak under the card's 80 GB.  Prints the host's memory first."""
    for cmd in ("free -g", "ulimit -l"):
        got = subprocess.run(["sh", "-c", cmd], capture_output=True, text=True).stdout.strip()
        print(f"host ({card}): $ {cmd}\n{got}")
    rows, counts = {}, {}
    for md in FULL_DEPTH_MOMENTS:
        extra = {"offload_moments": True, **({"moments_dtype": md} if md != "none" else {})}
        counts[md], rows[md], _ = train_plan(
            fa, hostmem, serve, runner, train_mod, cfg, card, "d", seq=TRAIN_SEQ,
            n_chunks=TRAIN_CHUNKS, steps=FULL_STEPS, label=f"full depth, moments {md}",
            extra=extra, grads="peak" if md == FULL_DEPTH_MOMENTS[0] else "none")
        check(rows[md]["peak_bytes"] < CARD_BYTES,
              f"full depth peaked at {rows[md]['peak_bytes']} bytes, over the card's {CARD_BYTES}")
        torch.cuda.empty_cache()
    return counts, rows


def train_phase(fa, hostmem, serve, runner, train_mod, cfg, card):
    """Phase 4: the link's rate and the embedding's backward, then the five
    plans on the 4-layer S = 8192 cell in turns ((d), the default plan,
    first: the main path's training run), their step-0 losses within 1e-3
    relative, and the losses of (b), (c) and (d) (the same remat, with and
    without the offload) bitwise equal at every step.  Each plan's untimed
    step-0 gradients are held against (d)'s: (b) and (c) bitwise (the
    replay reads the same values whether a row stayed on the device or went
    to host and back, so a reload read before its copy landed would show),
    (a) and (e) within GRAD_PLAN_TOL, and whether they are bitwise equal
    too is printed.  Then the moment offload and the codecs on the same
    cell (``moment_phase``), the full-depth cell (``full_depth_phase``),
    and the long cell (S = 32768, 8 chunks): plans (d), (b) (the same remat
    without the offload) and (e) (full recompute), LONG_STEPS steps each,
    held alike, and plan (a) only if its predicted peak is under 75 GiB."""
    t_start = time.perf_counter()
    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    rates = link_rate(hostmem, card)
    embed = embed_check(card)

    def run_cell(plans, seq, n_chunks, label):
        rows, totals, ref = {}, {}, None
        for plan in plans:
            totals[plan], rows[plan], grads = train_plan(
                fa, hostmem, serve, runner, train_mod, cfg4, card, plan, seq=seq,
                n_chunks=n_chunks, steps=TRAIN_STEPS if seq == TRAIN_SEQ else LONG_STEPS,
                label=label)
            torch.cuda.empty_cache()
            if ref is None:
                ref = grads
            else:
                rows[plan]["grads_rel_l2_vs_d"], rows[plan]["grads_bitwise_vs_d"] = compare_grads(
                    grads, ref, plan, plans[0], label, bitwise=plan in ("b", "c"))
            del grads
        first = [rows[p]["losses"][0] for p in plans]
        check(max(first) - min(first) <= 1e-3 * abs(first[0]),
              f"[{label}] the plans' step-0 losses disagree by more than 1e-3 relative: {first}")
        same = {p: rows[p]["losses"] for p in plans if p in ("b", "c", "d")}
        check(len({tuple(v) for v in same.values()}) == 1,
              f"[{label}] the losses of plans {sorted(same)} differ: {same}")
        print(f"train [{label}] step-0 losses of plans {', '.join(plans)}: {first}; the losses "
              f"of plans {', '.join(sorted(same))} bitwise equal at every step")
        return rows, totals, ref

    rows, totals, ref = run_cell(("d", "a", "b", "c", "e"), TRAIN_SEQ, TRAIN_CHUNKS,
                                 f"S={TRAIN_SEQ}")
    check(rows["d"]["chunks"] == [2560, 2048, 1920, 1664],
          f"train chunks {rows['d']['chunks']}, expected (2560, 2048, 1920, 1664)")
    seconds = {"plans_s8192": time.perf_counter() - t_start}
    t0 = time.perf_counter()
    moments = moment_phase(hostmem, serve, runner, cfg4, card, ref)
    seconds["moments_and_codecs"] = time.perf_counter() - t0
    del ref
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    full_counts, full_rows = full_depth_phase(fa, hostmem, serve, runner, train_mod, cfg, card)
    seconds["full_depth"] = time.perf_counter() - t0
    totals.update({f"full_depth_{md}": c for md, c in full_counts.items()})
    long_plans = ("d", "b", "e") + (("a",) if LONG_PLAN_A_PREDICTED_GIB < 75 else ())
    t0 = time.perf_counter()
    long_rows, long_totals, _ = run_cell(long_plans, LONG_SEQ, LONG_CHUNKS, f"S={LONG_SEQ}")
    seconds["plans_s32768"] = time.perf_counter() - t0
    print(f"train phase seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    if "a" not in long_plans:
        print(f"train [S={LONG_SEQ}] plan (a) not run: predicted peak "
              f"{LONG_PLAN_A_PREDICTED_GIB} GiB (PERF.md), not under 75 GiB")
    totals.update({f"long_{p}": c for p, c in long_totals.items()})
    return totals, {"link_rate_bytes_per_s": rates, **embed, "train_phase_seconds": seconds,
                    "train_plans": rows,
                    "train_moments": moments, "train_full_depth": full_rows,
                    "train_long": long_rows}


def doc_lengths(pb) -> list:
    """The document lengths of a packed batch, in document order."""
    return [end - start for _, start, end, _ in sorted(pb.spans, key=lambda sp: sp[3])]


def packed_batches(vocab, corpus, seq):
    """The seeded corpus packed into rows of ``seq`` tokens, and its
    pad-to-max layout: one document a row, at its packed offsets."""
    from repro_torch.data import pipeline as dpipe

    docs = dpipe.sample_corpus(vocab_size=vocab, **corpus)
    packed = dpipe.pack_documents(docs, seq)
    return packed, dpipe.pad_to_max(docs, seq, at_packed_offsets=packed)


def packed_phase(fa, hostmem, serve, runner, train_mod, cfg, card, uniform_warm_ms):
    """Packed variable-length training: qwen2-7b at full width cut to 4
    layers, S = 8192 in 4 chunks, the 32-document corpus packed into 3 rows
    (``train(packed=)``, one row a microbatch): the default plan (d) and
    plan (b), then the pad-to-max baseline (one document a row at its
    packed offsets, 32 microbatches) under plan (d), PACKED_STEPS steps
    each, each held as ``train_plan`` holds a plan (launches a step,
    the rows' copy bytes by the closed form, finite losses).  Checks (d)'s
    losses bitwise (b)'s at every step, and packed real tokens/s (labels >=
    0 over the warm step) at least VARLEN_FACTOR times pad-to-max's.  The
    losses of the two layouts are not compared here: each microbatch's loss
    is a mean over its own tokens, so 3 and 32 microbatches weight the same
    tokens differently (the fp32 check holds them at grad_accum = 1).
    Beside the measured steps, the solver's predicted step
    (``simulate_candidate`` at pp = 1, 4 chunks, sp = 1) for the packed and
    the uniform S = 8192 cell."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import solver
    from repro_torch.models.model_zoo import build_model

    cfg4 = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS)
    packed, pad = packed_batches(cfg.vocab_size, PACKED_CORPUS, PACKED_SEQ)
    lens = doc_lengths(packed)
    real = int((packed.labels >= 0).sum())
    row_fill = [int((packed.seg_ids[r] >= 0).sum()) for r in range(len(packed.tokens))]
    check(packed.tokens.shape == (3, PACKED_SEQ) and pad.tokens.shape == (32, PACKED_SEQ)
          and sum(lens) == 24574 and real == int((pad.labels >= 0).sum()) == 24574 - len(lens),
          f"packed corpus: rows {packed.tokens.shape}, pad {pad.tokens.shape}, {sum(lens)} "
          f"real tokens, {real} labelled")
    print(f"packed corpus: {len(lens)} documents, {sum(lens)} real tokens ({real} labelled), "
          f"packed into {len(row_fill)} rows of {PACKED_SEQ} filled {row_fill}; pad-to-max "
          f"{len(lens)} rows, {1 - sum(lens) / (len(lens) * PACKED_SEQ):.3f} padding")
    n_active = cm.count_active_params(build_model(cfg4))
    rows, totals = {}, {}
    for key, plan, pb in (("packed_d", "d", packed), ("packed_b", "b", packed),
                          ("pad_d", "d", pad)):
        totals[key], rows[key], _ = train_plan(
            fa, hostmem, serve, runner, train_mod, cfg4, card, plan, seq=PACKED_SEQ,
            n_chunks=PACKED_CHUNKS, steps=PACKED_STEPS, label=key,
            extra=dict(grad_accum=len(pb.tokens)), grads="none", packed=pb)
        r = rows[key]
        warm_s = r["warm_step_ms"] / 1e3
        r.update(real_tokens=real, real_tokens_per_s=real / warm_s,
                 mfu_real=6 * n_active * real / warm_s / BF16_FLOPS, doc_lens=lens)
        print(f"train [{key}] ({card}): chunks {r['chunks']}, alpha "
              f"{[round(a, 4) for a in r['alphas']]}; warm step {r['warm_step_ms']:.1f} ms, "
              f"{r['real_tokens_per_s']:.1f} real tokens/s, MFU over real tokens "
              f"{r['mfu_real']:.4f}; peak {r['peak_bytes'] / 2**30:.3f} GiB; rows' copies "
              f"{r['d2h_bytes_per_step']} bytes each way a step (the closed form); launches a "
              f"step {r['launches_per_step']}; idle share {r['idle_share']:.3f}")
        torch.cuda.empty_cache()
    check(rows["packed_d"]["losses"] == rows["packed_b"]["losses"],
          f"packed plans (d) and (b) differ: {rows['packed_d']['losses']} vs "
          f"{rows['packed_b']['losses']}")
    ratio = rows["packed_d"]["real_tokens_per_s"] / rows["pad_d"]["real_tokens_per_s"]
    print(f"packed vs pad-to-max ({card}): {ratio:.3f}x real tokens/s (gate {VARLEN_FACTOR}x); "
          f"plans (d) and (b) bitwise equal losses at every step "
          f"{rows['packed_d']['losses']}")
    check(ratio >= VARLEN_FACTOR, f"packed real tokens/s only {ratio:.3f}x pad-to-max's "
          f"(gate {VARLEN_FACTOR}x)")
    pred = {}
    for key, seq, batch, dl, measured in (
            ("packed", PACKED_SEQ, len(packed.tokens), lens, rows["packed_d"]["warm_step_ms"]),
            ("uniform", TRAIN_SEQ, 1, None, uniform_warm_ms)):
        t, alphas, res = solver.simulate_candidate(cfg4, seq, batch, n_active, 1, PACKED_CHUNKS,
                                                   1, cm.H100, doc_lens=dl)
        pred[key] = {"predicted_ms": 1e3 * t, "measured_warm_ms": measured,
                     "alphas": list(alphas), "d2h_stall_ms": 1e3 * res.d2h_stall}
        print(f"solver ({key}, pp 1, {PACKED_CHUNKS} chunks, sp 1, H100 data sheet): predicted "
              f"step {1e3 * t:.1f} ms, alpha {[round(a, 4) for a in alphas]}; measured warm "
              f"step {measured:.1f} ms ({card}), measured / predicted {measured / (1e3 * t):.3f}")
    return totals, {"packed_plans": rows, "packed_over_pad_tokens_per_s": ratio,
                    "solver_prediction": pred}


def packed_cpu_check(fa, hostmem, serve, runner, cfg, card):
    """The seed-built model cut to 2 layers, fp32, the default plan, one
    step's loss and gradients on the packed rows of FP32_PACKED_CORPUS at S
    = 256 (2 chunks, grad_accum = 1): on the card (CUDA-core kernels with
    the document windows; no TF32) within GRAD_REL_TOL relative L2 of the
    CPU's (plain path) for the loss and layer 0's wq, wk, wv and the head;
    and on the card its loss within PACKED_LOSS_TOL of the pad-to-max
    oracle's (one document a row at its packed offsets)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import offload as ofl

    S = 256
    packed, oracle = packed_batches(cfg.vocab_size, FP32_PACKED_CORPUS, S)
    lens = doc_lengths(packed)
    cfg2 = dataclasses.replace(cfg, n_layers=2)

    def cell_of(pb):
        return runner.resolve_cell(cfg2, ShapeConfig("packed_check", S, len(pb.tokens), "train"),
                                   overrides=dict(pp=1, dp=1, n_chunks=2), dtype=torch.float32,
                                   doc_lens=lens)

    def batch_of(pb, dev):
        return [torch.from_numpy(a).to(dev) for a in (pb.tokens, pb.labels, pb.doc_start)]

    cell = cell_of(packed)
    check(cell.sched.n == 2 and cell.plan.offload and cell.plan.remat == "sppo",
          f"packed check plan {cell.plan}, chunks {cell.sched.lengths}")
    params = serve.build_params(cell, "cuda", seed=0)

    def pick(loss, g):
        layer = g["stages"][0]["attn"]
        return {"loss": loss, "wq": layer["wq"], "wk": layer["wk"], "wv": layer["wv"],
                "head": g["globals"]["head"]["w"]}

    B, n_sm = len(packed.tokens), torch.cuda.get_device_properties(0).multi_processor_count
    splits = sum(fa._geometry(B, ln, off + ln, cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads,
                              n_sm)[2] > 1
                 for off, ln in zip(cell.sched.offsets, cell.sched.lengths))
    fa.reset_counts()
    hostmem.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, *batch_of(packed, "cuda"))
    on_card = {k: v.cpu() for k, v in pick(loss, grads).items()}
    launched, copied = fa.counts(), hostmem.counts()
    want = {"fwd": 8, "merge": 4 * splits, "bwd_dq": 4, "bwd_dkv": 4}
    check(launched == {**{key: 0 for key in launched}, **want},
          f"the card's packed fp32 step launched {launched}, expected {want}")
    n_bytes = 2 * offload_bytes(cell)          # fp32 rows: twice the bf16 closed form
    n_copies = 10 * sum(1 for ln, a in zip(cell.sched.lengths, cell.alphas)
                        if ofl.split_rows(ln, a) > 0)
    check(copied["d2h_bytes"] == copied["h2d_bytes"] == n_bytes and copied["d2h"] == n_copies
          and copied["d2h_pinned"] == n_copies,
          f"the card's packed fp32 step copied {copied}, expected {n_copies} pinned D2H of "
          f"{n_bytes} bytes in all and the same back")
    del grads
    loss_oracle, _ = runner.loss_and_grads(cell_of(oracle), params, *batch_of(oracle, "cuda"))
    oracle_diff = abs(float(loss_oracle) - float(loss))
    params_cpu = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    loss_cpu, grads = runner.loss_and_grads(cell, params_cpu, *batch_of(packed, "cpu"))
    on_cpu = pick(loss_cpu, grads)
    rel = {k: ((on_card[k] - on_cpu[k]).norm() / on_cpu[k].norm()).item() for k in on_cpu}
    print(f"2-layer packed train check ({card}), default plan, {B} rows, chunks "
          f"{cell.sched.lengths}, alphas {cell.alphas}: fp32 loss card {float(loss):.7f} vs CPU "
          f"{float(loss_cpu):.7f} vs the pad-to-max oracle on the card {float(loss_oracle):.7f} "
          f"(|diff| {oracle_diff:.3e}); copies {copied}; launches {launched}; relative L2 "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    check(all(torch.isfinite(v).all() for v in on_card.values()) and
          all(v <= GRAD_REL_TOL for v in rel.values()),
          f"card and CPU packed steps disagree: relative L2 {rel} (tol {GRAD_REL_TOL})")
    check(oracle_diff <= PACKED_LOSS_TOL, f"packed loss {float(loss)} and the pad-to-max "
          f"oracle's {float(loss_oracle)} differ by {oracle_diff} (tol {PACKED_LOSS_TOL})")
    return {"rel_l2": rel, "oracle_loss_diff": oracle_diff}, launched


def config_phase(fa, hostmem, serve, runner, train_mod, card):
    """glm4-9b, nemotron-4-15b and starcoder2-3b (G = 16, 6, 12) at full
    width cut to CONFIG_LAYERS layers, B = 1, S = CONFIG_SEQ in CONFIG_CHUNKS
    chunks, the default plan, CONFIG_STEPS steps each through
    ``train_plan``: finite losses, each step's forward, dq and dk/dv
    launches by the closed form (the forward twice a layer and chunk, its
    replay), the rows' copies by theirs."""
    from repro_torch.configs.base import get_config

    rows, totals = {}, {}
    for arch in CONFIG_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=CONFIG_LAYERS)
        totals[arch], rows[arch], _ = train_plan(
            fa, hostmem, serve, runner, train_mod, cfg, card, "d", seq=CONFIG_SEQ,
            n_chunks=CONFIG_CHUNKS, steps=CONFIG_STEPS, label=arch, grads="none")
        r = rows[arch]
        print(f"train [{arch}] ({card}): G = {cfg.n_heads // cfg.n_kv_heads}, chunks "
              f"{r['chunks']}, steps {[round(1e3 * t, 1) for t in r['step_s']]} ms, peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB, launches a step {r['launches_per_step']}")
        torch.cuda.empty_cache()
    return totals, rows


def train_cpu_check(fa, hostmem, serve, runner, cfg, card):
    """The seed-built model cut to 2 layers: one step's loss and gradients
    at S = 256 (2 chunks), fp32, under the default plan (chunk 0 offloads
    every tagged row, α = 1), on the card (kernels, no TF32) and on the CPU
    (plain path, CPU clones for host copies); relative L2 within 1e-4 for
    the loss and the gradients of layer 0's wq, wk, wv and the head."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM

    S = 256
    cell = runner.resolve_cell(dataclasses.replace(cfg, n_layers=2),
                               ShapeConfig("train_check", S, 1, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=2), dtype=torch.float32)
    check(cell.sched.n == 2, f"check ran {cell.sched.n} chunks, expected 2")
    check(cell.plan.offload and cell.plan.remat == "sppo" and cell.alphas == (1.0, 0.0),
          f"check plan {cell.plan} alphas {cell.alphas}, expected the default plan, (1, 0)")
    tokens, labels = (torch.from_numpy(a) for a in SyntheticLM(cfg.vocab_size, S, 1)
                      .sample_step(0))
    params = serve.build_params(cell, "cuda", seed=0)

    def pick(g):
        layer = g["stages"][0]["attn"]
        return {"loss": None, "wq": layer["wq"], "wk": layer["wk"], "wv": layer["wv"],
                "head": g["globals"]["head"]["w"]}

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    splits = sum(fa._geometry(1, ln, off + ln, cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads,
                              n_sm)[2] > 1
                 for off, ln in zip(cell.sched.offsets, cell.sched.lengths))
    fa.reset_counts()
    hostmem.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, tokens.cuda(), labels.cuda())
    on_card = {k: (loss if v is None else v).cpu() for k, v in pick(grads).items()}
    launched = fa.counts()
    copied = hostmem.counts()
    # the forward twice a layer and chunk (its replay), with its merges
    want = {"fwd": 8, "merge": 4 * splits, "bwd_dq": 4, "bwd_dkv": 4}
    check(launched == {**{key: 0 for key in launched}, **want},
          f"the card's fp32 step launched {launched}, expected {want} (the CUDA-core forward "
          f"with its merge kernel and backward pair) and no tensor-core launch")
    n_bytes = 2 * offload_bytes(cell)          # fp32 rows: twice the bf16 closed form
    check(copied["d2h_bytes"] == copied["h2d_bytes"] == n_bytes and copied["d2h"] == 10
          and copied["d2h_pinned"] == 10,
          f"the card's fp32 step copied {copied}, expected 10 pinned D2H of {n_bytes} bytes "
          f"in all and the same back")
    del grads
    params_cpu = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    loss, grads = runner.loss_and_grads(cell, params_cpu, tokens, labels)
    on_cpu = {k: (loss if v is None else v) for k, v in pick(grads).items()}
    rel = {k: ((on_card[k] - on_cpu[k]).norm() / on_cpu[k].norm()).item() for k in on_cpu}
    print(f"2-layer train check ({card}), default plan, alphas {cell.alphas}: fp32 loss card "
          f"{float(on_card['loss']):.6f} vs CPU {float(on_cpu['loss']):.6f}; copies {copied}; "
          f"relative L2 " + ", ".join(
              f"{k} {v:.3e}" for k, v in rel.items()))
    check(all(torch.isfinite(v).all() for v in on_card.values()) and
          all(v <= GRAD_REL_TOL for v in rel.values()),
          f"card and CPU training steps disagree: relative L2 {rel} (tol {GRAD_REL_TOL})")
    return rel, launched


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    src = Path(__file__).resolve().parent / "src"
    check((src / "repro_torch").is_dir(), f"no port sources under {src}")
    sys.path.insert(0, str(src))
    global HBM_BYTES_PER_S, BF16_FLOPS
    from repro_torch.configs.base import get_config
    from repro_torch.core.costmodel import H100
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_mod
    from repro_torch.parallel import runner
    from repro_torch.runtime import hostmem

    HBM_BYTES_PER_S, BF16_FLOPS = H100.hbm_bw, H100.peak_flops_bf16
    # the train entry point's log: its set-up (weights, moments) and steps, timestamped
    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(name)s %(message)s")
    logging.getLogger("repro_torch.train").setLevel(logging.INFO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # ---- phase 1: device and build
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    card = smi.strip()
    print(f"device: {kind}, count {count}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    t0 = time.perf_counter()
    built = fa.build()
    print(f"built {', '.join(fa.SOURCES[n].name for n in built)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)")
    for name, (_, build_log) in built.items():
        for line in build_log.splitlines():
            if "registers" in line or "bytes stack frame" in line or "Compiling entry" in line:
                print(f"  ptxas [{name}]:", line.strip())

    # ---- phase 2: kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    grid_err, n_grid = edge_grid(fa, ref, gen)
    print(f"forward edge grid: {n_grid} cases (fp32 on the CUDA cores, bf16 on the tensor cores "
          f"and on the CUDA cores) within {KERNEL_TOL} (worst {json.dumps(grid_err)}), dead "
          f"rows exact")
    prefill_in, decode_in = serving_shapes(gen)
    rows = [measure_shape("prefill chunk", fa, ref, *prefill_in),
            measure_shape("decode step", fa, ref, *decode_in)]
    del prefill_in, decode_in
    bwd_err, n_bwd = bwd_edge_grid(fa, ref, gen)
    print(f"backward edge grid: {n_bwd} cases (fp32 on the CUDA cores, bf16 on the tensor "
          f"cores), each gradient within {KERNEL_TOL} x max |plain| (worst "
          f"{json.dumps(bwd_err)}), dead rows' dq exactly 0")
    fp32_fwd_err, fp32_bwd_rel, _ = fp32_check_shapes(fa, ref, gen, runner, get_config("qwen2-7b"))
    cfg = get_config("qwen2-7b")
    train_cell, bwd_in = train_chunk_shapes(gen, runner, cfg)
    measured = [measure_bwd_shape(name, fa, ref, *args) for name, args in bwd_in.items()]
    rows += [fwd_rows for fwd_rows, _ in measured]
    bwd_rows = [bwd for _, bwd in measured]
    del bwd_in, measured
    torch.cuda.empty_cache()
    # this slice's shapes: the packed cell's chunks (3 rows, document
    # windows), the packed fp32 check's, and a train chunk at G = 16, 6, 12
    _, packed_in = train_chunk_shapes(
        gen, runner, cfg, packed=packed_batches(cfg.vocab_size, PACKED_CORPUS, PACKED_SEQ)[0])
    extra_measured = [measure_bwd_shape(f"packed {name}", fa, ref, *args)
                      for name, args in packed_in.items()]
    del packed_in
    fp32_packed_err, fp32_packed_rel, _ = fp32_check_shapes(
        fa, ref, gen, runner, cfg, packed=packed_batches(cfg.vocab_size, FP32_PACKED_CORPUS,
                                                         256)[0])
    for arch in CONFIG_ARCHS:
        _, g_in = train_chunk_shapes(gen, runner, get_config(arch), n_layers=CONFIG_LAYERS,
                                     seq=CONFIG_SEQ, n_chunks=CONFIG_CHUNKS)
        extra_measured.append(measure_bwd_shape(f"{arch} last chunk", fa, ref,
                                                *g_in["last chunk"]))
        del g_in
    extra_fwd = [fwd for fwd, _ in extra_measured]
    extra_bwd = [bwd for _, bwd in extra_measured]
    del extra_measured
    torch.cuda.empty_cache()

    t_phase3 = time.perf_counter()
    print(f"phases 1-2 took {t_phase3 - t_start:.1f} s")
    # ---- phase 3: the serving path, through the CLI entry point
    fa.reset_counts()
    hostmem.reset_counts()
    out = serve.main(["--arch", "qwen2-7b", "--prompt-len", str(PREFILL_LEN),
                      "--batch", str(BATCH), "--decode-steps", str(DECODE_STEPS),
                      "--repeats", str(REPEATS)])
    serve_counts = fa.counts()
    check(not any(hostmem.counts().values()),
          f"serving copied to or from host memory: {hostmem.counts()}")
    launches, merged = serve_counts["fwd_tc"], serve_counts["merged_in_kernel"]
    n_chunks = out["n_chunks"]
    expected = REPEATS * cfg.n_layers * (n_chunks + DECODE_STEPS)
    print(f"serve path: {cfg.name} {cfg.n_layers} layers, {REPEATS} runs of prefill "
          f"{n_chunks} chunks + {DECODE_STEPS} decode steps: tensor-core forward launches "
          f"{launches} (expected {expected}), of which {merged} merged their KV splits in the "
          f"launch (one per decode call); all launches {serve_counts}")
    check(n_chunks == 16, f"prefill ran {n_chunks} chunks, expected 16")
    check(launches == expected, f"tensor-core forward launched {launches} times, expected {expected}")
    check(merged == REPEATS * cfg.n_layers * DECODE_STEPS,
          f"{merged} launches merged their splits, expected one per decode call")
    check(all(serve_counts[k] == 0 for k in serve_counts if k not in ("fwd_tc", "merged_in_kernel")),
          f"serving launched other kernels than the tensor-core forward: {serve_counts}")
    toks, hidden = out["tokens"], out["last_hidden"]
    check(toks.shape == (BATCH, DECODE_STEPS), f"tokens shape {toks.shape}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "token ids out of range")
    check(tuple(hidden.shape) == (BATCH, 128, cfg.d_model)
          and bool(torch.isfinite(hidden).all()), "prefill hidden state not finite")
    pre_s, dec_s, peak = out["prefill_s"], out["decode_s"], out["peak_bytes"]
    pre_runs, dec_runs = out["prefill_s_runs"], out["decode_s_runs"]
    for run, (p_s, d_s) in enumerate(zip(pre_runs, dec_runs)):
        print(f"run {run} ({card}): prefill {p_s:.4f} s, {BATCH * PREFILL_LEN / p_s:.1f} "
              f"tokens/s; decode {1e3 * d_s / DECODE_STEPS:.3f} ms/step, "
              f"{BATCH * DECODE_STEPS / d_s:.1f} tokens/s")
    print(f"peak memory ({card}): torch.cuda.max_memory_allocated = "
          f"{peak / 2**30:.3f} GiB")
    del out, hidden
    torch.cuda.empty_cache()
    rel = cpu_check(serve, runner, cfg, card)
    profile = profile_main_path(serve, runner, cfg, 1e3 * pre_s, 1e3 * dec_s / DECODE_STEPS,
                                card)
    torch.cuda.empty_cache()

    t_phase4 = time.perf_counter()
    print(f"phase 3 took {t_phase4 - t_phase3:.1f} s")
    # ---- phase 4: the training path, through the train CLI's function
    plan_counts, train_summary = train_phase(fa, hostmem, serve, runner, train_mod, cfg, card)
    train_counts = plan_counts["d"]      # the main path: the default plan at S = 8192
    torch.cuda.empty_cache()
    train_rel, fp32_counts = train_cpu_check(fa, hostmem, serve, runner, cfg, card)
    torch.cuda.empty_cache()
    # ---- this slice's paths: packed training, its fp32 check, three configs
    t_packed = time.perf_counter()
    packed_counts, packed_summary = packed_phase(
        fa, hostmem, serve, runner, train_mod, cfg, card,
        train_summary["train_plans"]["d"]["warm_step_ms"])
    packed_fp32, packed_fp32_counts = packed_cpu_check(fa, hostmem, serve, runner, cfg, card)
    config_counts, config_rows = config_phase(fa, hostmem, serve, runner, train_mod, card)
    print(f"packed and config phases took {time.perf_counter() - t_packed:.1f} s")

    tc_rows = [r["tensor_cores"] for r in rows]
    cc_rows = [r["cuda_cores"] for r in rows]
    decode_cc = rows[1]["cuda_cores"]
    common = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    full = {f"train_full_depth_moments_{md}": plan_counts[f"full_depth_{md}"]
            for md in FULL_DEPTH_MOMENTS}
    paths = {"serve": serve_counts, "train": train_counts, **full,
             **{f"train_plan_{p}": c for p, c in plan_counts.items()
                if p != "d" and not p.startswith("full_depth_")},
             "train_fp32": fp32_counts, "train_packed": packed_counts["packed_d"],
             "train_packed_plan_b": packed_counts["packed_b"],
             "train_pad_to_max": packed_counts["pad_d"], "train_packed_fp32": packed_fp32_counts,
             **{f"train_{arch}": c for arch, c in config_counts.items()}}

    def by_path(key):
        return {path: c[key] for path, c in paths.items()}

    # launches: on the main paths that run each kernel (bf16 serving,
    # training, full-depth training and packed training for the tensor
    # cores, the fp32 training checks, uniform and packed, for the CUDA
    # cores); the row's times are the serving prefill chunk's (the decode
    # step's for the merge), every shape's in "shapes"
    kernels = [
        {"name": "flash_attention_partial_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_partial_tc.cu",
         "replaces": "src/repro/kernels/flash_attention.py:260",
         "launches": serve_counts["fwd_tc"] + train_counts["fwd_tc"]
         + sum(c["fwd_tc"] for c in full.values()) + packed_counts["packed_d"]["fwd_tc"],
         "launches_by_path": by_path("fwd_tc"),
         "merged_in_kernel_by_path": by_path("merged_in_kernel"),
         **{key: tc_rows[0][key] for key in common},
         "edge_grid_max_abs_err": grid_err["tensor_cores"],
         "shapes": tc_rows + [r["tensor_cores"] for r in extra_fwd]},
        {"name": "flash_attention_partial", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_partial.cu",
         "replaces": "src/repro/kernels/flash_attention.py:260",
         "launches": fp32_counts["fwd"] + packed_fp32_counts["fwd"],
         "launches_by_path": by_path("fwd"),
         **{key: cc_rows[0][key] for key in common},
         "edge_grid_max_abs_err": grid_err["cuda_cores"],
         "fp32_check_shapes_max_abs_err": fp32_fwd_err,
         "fp32_packed_check_shapes_max_abs_err": fp32_packed_err,
         "shapes": cc_rows + [r["cuda_cores"] for r in extra_fwd]},
        # the CUDA-core forward's split-KV merge (decode), launched by the
        # same wrapper call; its output is what the decode shape's check holds
        {"name": "flash_attention_partial_merge", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_partial.cu",
         "replaces": "src/repro/kernels/flash_attention.py:260",
         "launches": fp32_counts["merge"] + packed_fp32_counts["merge"],
         "launches_by_path": by_path("merge"),
         "max_abs_err": decode_cc["max_abs_err"],
         **{key: decode_cc["merge"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "shapes": [decode_cc["merge"]]},
    ]
    # launches: on the main paths that run each pair (bf16 training at 4
    # layers, at full depth and packed for the tensor cores, the fp32
    # training checks for the CUDA cores)
    tc_paths = ("train", *full, "train_packed")
    cc_paths = ("train_fp32", "train_packed_fp32")
    for part, name, line, source, main_paths in (
            ("dq_tc", "flash_attention_partial_bwd_dq_tc", 331, "flash_partial_bwd_tc.cu", tc_paths),
            ("dkv_tc", "flash_attention_partial_bwd_dkv_tc", 355, "flash_partial_bwd_tc.cu", tc_paths),
            ("dq", "flash_attention_partial_bwd_dq", 331, "flash_partial_bwd.cu", cc_paths),
            ("dkv", "flash_attention_partial_bwd_dkv", 355, "flash_partial_bwd.cu", cc_paths)):
        head = bwd_rows[-1][part]      # the last chunk: the most visible pairs
        kernels.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/flash_attention.py:{line}",
            "launches": sum(paths[path]["bwd_" + part] for path in main_paths),
            "launches_by_path": by_path("bwd_" + part),
            **{key: head[key] for key in common}, "library": head["library"],
            "edge_grid_max_rel_err": bwd_err["torch.bfloat16" if part.endswith("_tc")
                                             else "torch.float32"],
            **({} if part.endswith("_tc") else {"fp32_check_shapes_max_rel_err": fp32_bwd_rel,
                                                "fp32_packed_check_shapes_max_rel_err":
                                                    fp32_packed_rel}),
            "shapes": [r[part] for r in bwd_rows + extra_bwd]})
    summary = {"prefill_s_runs": pre_runs, "decode_s_runs": dec_runs,
               "prefill_s": pre_s, "prefill_tokens_per_s": BATCH * PREFILL_LEN / pre_s,
               "decode_ms_per_step": 1e3 * dec_s / DECODE_STEPS,
               "decode_tokens_per_s": BATCH * DECODE_STEPS / dec_s,
               "peak_bytes": peak, "cpu_check_rel_l2": rel,
               **profile, **train_summary, "train_cpu_check_rel_l2": train_rel,
               **packed_summary, "packed_fp32_check": packed_fp32, "train_configs": config_rows,
               "train_chunks": list(train_cell.sched.lengths),
               "seconds": time.perf_counter() - t_start}
    print("summary:", json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
