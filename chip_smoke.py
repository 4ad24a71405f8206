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
   FULL_STEPS steps each, held as the plans are (224 / 112 / 112 launches a step)
   with the moment copies by the closed form, the step's device peak under
   80 GB, and the update's moment copies and their exposed ms from the
   profiler.  Then the long cell, LONG_LAYERS layers at S = 32768 in 8
   chunks: plans (d), (b) and (e) for LONG_STEPS steps each, held alike.  Last, the same seed-built
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
   PACKED_STEPS steps each (pad-to-max PAD_STEPS, not profiled), held as
   the plans are; (d)'s losses bitwise
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
   each of the three configs.  Then the multi-rank phases, their ranks
   processes sharing the one card over gloo (``launch.mesh.spawn``;
   every transfer staged through pinned host memory): the data axis
   (``pipeline_phase``: pp = 2 plain and MSP at full width, PIPE_LAYERS
   layers, against pp = 1, and reduced fp32 layouts against the CPU) and
   the model axis (``model_axis_phase``): qwen2-7b at full width cut to
   SP_LAYERS layers, B = 1, S = 8192 in 4 chunks, the default plan, sp = 2 as two
   ranks, SP_STEPS steps under gather_q and as many under gather_kv with
   grad_compress; each mode's step-0 loss within 2e-3 of sp = 1's on the
   card with the same weights, gather_q's gradients (one untimed call),
   gathered to full, within 1e-2 relative L2 at the worst leaf; every
   step's launches, row copies and model collectives (calls and bytes,
   each kind) by their closed forms; then the reduced model in fp32 at S =
   256 in four layouts (sp 2; pp 2 x sp 2 with MSP, four ranks; dp 2 x sp
   2 with packed rows, four ranks, raw and with fp8 rows) within 1e-4 of
   the CPU's sp = 1 step under the same plan, but for the fp8 layout's
   gradients, held by the reference's codec law against the raw layout's
   (SP_FP32_LAYOUTS says why).  Phase 2 holds the kernels at the model axis's shapes: the
   last chunk's gather_q shape (every query of the chunk over one rank's
   gapped cache shard) and gather_kv shape (one rank's queries over both
   shards concatenated, positions that do not ascend), timed as the other
   training shapes are, and untimed the first chunk's gather_q shape on
   the rank whose slots every query of its first half precedes (those
   rows exactly dead) and the fp32 layouts' shapes.  Every path's launches
   and copies are counted from 0 just before it runs.

Paged continuous-batching serving (DESIGN.md §16; ``paged_serve_phase``,
right after phase 3): ``launch.serve.ServeEngine`` with qwen2-7b at full
width, all 28 layers, bf16, random weights from seed 0: a 2048-token
prompt bucket, 64 new tokens at most, 8 slots, blocks of 16 slots (the
default pool of 8 x 132 = 1056 blocks); 24 requests from
``numpy.random.default_rng(0)`` (prompts of 256-2048 tokens, 8-64 new
tokens, arrivals at steps 0-48) run continuously (the main path), then in
lock-step waves (static), then three of them alone; every request's tokens
bitwise alike in the three, the blocks recycled (peak <= the concurrency
bound <= the pool < blocks allocated), the pool's bytes at the closed form
(the cost model's ``kv_pool_bytes`` plus the sink), the tensor-core forward
launched 28 x (steps + prefill chunks x waves) times and no other kernel,
and the decode loop under ``torch.cuda.set_sync_debug_mode("error")``
(any torch call that makes the host wait for the card raises); then 8 warm
steps under the profiler (busy ms and idle share).  Phase 2 times both
forwards at the paged step's shape (8 rows at their own positions, each
over its 2112 gathered slots) and checks the CUDA-core forward in fp32 at
the multi-rank serving shapes.  Last, serving over ranks sharing the card
over gloo (``serve_ranks_phase``): qwen2-7b at full width cut to 2 layers
in fp32, static sp = 2 (prefill 256, 8 decode steps), static pp = 2 (4
rows in 4 microbatches) and the engine at mesh 1 x 2 on a short trace,
each rank's tokens as the CPU's one device's (a token may differ only where
the CPU's top-2 logit gap is under 1e-4, printed as a tie), each rank's
model collectives and hand-offs at their closed forms.

The MoE family (``moe_phase``, last): granite-moe-1b-a400m at full width
and all 24 layers (hd 64, G = 2, 32 experts top-8, a tied table), random
weights from seed 0.  (a) Static serving through the CLI, B 4, a 2048-token
prompt in 16 chunks and 32 decode steps, MOE_REPEATS runs: the
tensor-core forward launched 24 x (16 + 32) times a run, the calls whose
KV range splits merged in the launch, nothing else, no host copy; the
2-layer model in fp32 decodes the CPU's tokens.  (b) Training through
``launch.train.train``, B 1, S 8192 in 4 chunks, fp32 moments on the
card, MOE_STEPS steps under the default plan and under offload off with
remat "sppo" (``train_plan``: launches, D2H = H2D at the closed form of
the tag shapes the MoE layer uses (``moe_offload_elems``: the experts'
hidden is [E, Ce, ff]), finite losses, MFU with the active N, peak, the
last step profiled); the two plans' losses bitwise equal at every step.
(c) The 2-layer fp32 step under the default plan against the CPU within
1e-4 (loss, layer 0's attention and expert leaves, its router, the tied
table).  (d) Expert parallelism at sp = 2, two ranks sharing the card
over gloo, 2 full-width layers, fp32, S 1024: each rank's step against
the same ranks' step on the CPU (a context of CPU tensors over the same
process group) within 1e-4, its all-to-alls' calls and bytes, launches
and row copies at their closed forms.  Phase 2 times the kernels at
granite's shapes: the train cell's first and last chunk, forward and
backward, and the decode step.

Then MLA (``mla_phase``, deepseek-v3-671b's wide kernels, serving at 2
layers and loss and gradients at 1 layer at full width) and the SSM family
(``ssm_phase``): rwkv6-3b and zamba2-7b served at full width and depth
(B 4, a 2048-token prompt in 16 chunks, 32 decode steps, SSM_REPEATS
runs, the decode loop under sync-debug "error"; rwkv6 launches no kernel,
zamba2 the tensor-core forward 14 x (16 + 32) times a run), trained at
full width cut in depth (4 RWKV6 layers, 2 zamba2 groups; S 8192 in 4
chunks, plans (d) and (b), SSM_STEPS steps: launches, D2H = H2D at the
closed form of the SSM tag shapes (``ssm_offload_elems``), the losses
bitwise equal at every step, (d)'s last step profiled), and their reduced
configs in fp32 against the CPU (a train step, prefill and decode).
Phase 2 holds and times the three kernels at zamba2's shapes (hd 112, G
1): its serving prefill chunk and decode step, its train cell's first and
last chunk.

Then the VLM and audio families (``xattn_phase``): llama-3.2-vision-11b
(40 self layers in 8 groups, each followed by a gated cross-attention
layer over 1600 stub patches; its cross gates set to 0.5 and -0.3, 0 at
init) and whisper-tiny (4 encoder and 4 decoder layers over 1500 stub
frames) served at full width and depth (B 4, a 2048-token prompt in 16
chunks, 32 decode steps, XATTN_REPEATS runs, sync-debug "error"; the
tensor-core forward 2304 and 388 times a run, the encoder's calls once),
trained at full width (the VLM at one group, B 1; whisper at full depth, B
4; S 8192 in 4 chunks, plans (d) and (b), XATTN_STEPS steps: launches with
the encoder's once a step, D2H = H2D at the closed form of the real tag
shapes (``xattn_offload_elems``), the losses bitwise equal, an MFU that
counts the encoder and the cross K/V where they run), and their reduced
configs in fp32 against the CPU.  Phase 2 holds and times the three
kernels non-causal at their shapes: the VLM's cross layer at the serving
prefill chunk, the decode step and the train cell's first chunk, whisper's
encoder (1500 x 1500) and cross layer, and untimed PAD context tails and
dead rows (``xattn_edge_checks``).

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
import math
import subprocess
import sys
import threading
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
# the long cell runs 2 layers (4 until PR 24: cut for the script's time, PERF.md §4)
LONG_LAYERS, LONG_SEQ, LONG_CHUNKS, LONG_STEPS = 2, 32768, 8, 2
# plan (a)'s peak at S = 32768 and 4 layers as predicted in PERF.md before
# the first run (the weights and moments plus four times the S = 8192 run's
# activations): plan (a) ran on the long cell only if this was under 75 GiB;
# at LONG_LAYERS it stays out, for the script's time
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
FULL_STEPS = 2   # 2, not 3: cut for the script's time (PERF.md §4)
FULL_DEPTH_MOMENTS = ("none", "fp8")
CARD_BYTES = 80e9
# the share of an update's moment copies that the profiler may fail to
# deliver before copy_timeline refuses its reading (the copies themselves
# are counted exactly by runtime/hostmem.py)
MISSED_COPY_SHARE = 0.01
# kineto keeps only the device records whose times, converted to the host's
# clock, fall between the profiler's start and stop, and that conversion
# drifts from session to session: on the H100 machine a full-depth step's
# last 0.47 s of moment copies (136 of 734 H2D, 138 of 734 D2H) once fell
# past the stop, and kineto's "Record counts: Out-of-range" read 4 to 12
# records in other sessions of that step.  A profiled step is therefore
# padded with idle host time (seconds, before and after it) inside its
# profiling session; the step's own times are taken inside the padding.
PROFILE_PAD_S = (0.5, 2.0)
# packed variable-length training (DESIGN.md §13): qwen2-7b at full width, 4
# layers, S = 8192 in 4 chunks; 32 Zipf documents (24574 real tokens) packed
# into 3 rows, one row a microbatch, against the pad-to-max baseline (one
# document a row at its packed offsets, 32 microbatches)
PACKED_CORPUS = dict(n_docs=32, seed=0, dist="zipf", mean_len=768, max_len=8192)
PACKED_SEQ, PACKED_CHUNKS, PACKED_STEPS = 8192, 4, 3
# pad-to-max: 2 steps and no profiled step, for the script's time; its one
# check of its own is the varlen gate on the warm (unprofiled) step, the
# profiler's checks are the packed cell's (PERF.md §4)
PAD_STEPS = 2
# the reference's varlen gate: packed real tokens/s over pad-to-max's
# (benchmarks/bench_varlen.py, DEFAULT_FACTOR)
VARLEN_FACTOR = 1.5
# the 2-layer fp32 packed check: tests/test_varlen.py::_corpus at S = 256
FP32_PACKED_CORPUS = dict(n_docs=10, seed=3, dist="zipf", mean_len=48, max_len=200)
PACKED_LOSS_TOL = 1e-5    # packed vs the pad-to-max oracle (the reference's bar)
# three more dense configs at full width, cut to 2 layers: G = 16, 6, 12
CONFIG_ARCHS = ("glm4-9b", "nemotron-4-15b", "starcoder2-3b")
CONFIG_LAYERS, CONFIG_SEQ, CONFIG_CHUNKS, CONFIG_STEPS = 2, 4096, 4, 2
# the multi-rank pipeline (pipeline_phase, DESIGN.md §2, §4): qwen2-7b at
# full width cut to 4 layers, B = 1, S = 8192 in 4 equal chunks, pp = 2 as
# two ranks (processes) sharing the one card over gloo, the hand-offs and
# reductions staged through pinned host memory; the plain feed and MSP
# (msp_split 2), 3 steps each, against pp = 1 on the same card with the
# same weights; then the reduced model in fp32 (the CUDA-core kernels) at
# S = 256 in three layouts against the CPU's pp = 1 step
# 2 layers, one a stage (4 until PR 24: cut for the script's time, PERF.md §4)
PIPE_LAYERS, PIPE_SEQ, PIPE_CHUNKS, PIPE_STEPS, PIPE_PP, PIPE_SPLIT = 2, 8192, 4, 3, 2, 2
PIPE_BACKEND = "gloo"
PIPE_DEADLINE_S = 600.0
PIPE_FP32_SEQ, PIPE_FP32_BATCH = 256, 2
PIPE_FP32_LAYOUTS = {"pp4_msp": dict(dp=1, pp=4, n_chunks=4, msp=True),
                     "dp2_pp2": dict(dp=2, pp=2, n_chunks=4),
                     "dp2": dict(dp=2, pp=1, n_chunks=2)}
SHARED_CARD = "two ranks share one card: not a pipeline speed"
# the model axis (model_axis_phase, DESIGN.md §4): qwen2-7b at full width cut
# to SP_LAYERS layers, B = 1, S = 8192 in 4 chunks, the default plan, sp = 2 as two
# ranks sharing the one card over gloo (every collective staged through
# pinned host memory); SP_STEPS steps under gather_q, then as many under
# gather_kv with grad_compress and under the ring (DESIGN.md §15), each
# mode's step-0 loss, and the step-0 gradients of the SP_GRADS_MODES (one
# untimed call each, gathered to full), against sp = 1 on the card with the
# same weights; then the reduced model in fp32 at S = 256 in the
# SP_FP32_LAYOUTS against the CPU's sp = 1 step under the same plan
# 1 layer (2 until PR 24: cut for the script's time, PERF.md §4)
# one step a mode, for the script's time: step 0 holds every closed form
# (PERF.md §4)
SP, SP_LAYERS, SP_SEQ, SP_CHUNKS, SP_STEPS = 2, 1, 8192, 4, 1
SP_LOSS_TOL = 2e-3       # step-0 loss against sp = 1's, relative
SP_MODES = {"gather_q": dict(attn_mode="gather_q"),
            "gather_kv": dict(attn_mode="gather_kv", grad_compress=True),
            "ring": dict(attn_mode="ring")}
SP_GRADS_MODES = ("gather_q", "ring")
SP_FP32_SEQ, SP_FP32_BATCH = 256, 2
# the packed layouts run FP32_PACKED_CORPUS in 4 rows (2 a dp group), chunk
# 0 offloading every tagged row (α 1), raw and as fp8.  The fp8 layout is
# held by the reference's codec law against the raw one (``drift_of``) and
# against the CPU's fp8 step at the loss: a row whose last fp32 bit differs
# between sp = 2 and sp = 1 (its GEMM has half the rows) may round to the
# next fp8 step, which on the H100 moved the worst gradient leaf 1.1e-4
# from sp = 1's, the raw layout's 1.7e-6 (PERF.md §6)
SP_FP32_LAYOUTS = {"sp2": dict(dp=1, pp=1, sp=2, n_chunks=2),
                   "pp2_sp2_msp": dict(dp=1, pp=2, sp=2, n_chunks=4, msp=True),
                   "dp2_sp2_packed": dict(dp=2, pp=1, sp=2, n_chunks=2, packed=True,
                                          alphas=(1.0, 0.0)),
                   "dp2_sp2_packed_fp8": dict(dp=2, pp=1, sp=2, n_chunks=2, packed=True,
                                              plan=dict(offload_dtype="fp8"), alphas=(1.0, 0.0),
                                              drift_of="dp2_sp2_packed"),
                   # the ring (DESIGN.md §15) at sp 2 and under pp 2 with MSP; the pod
                   # axis at pods 2 x sp 2 with ZeRO-1 and the moments in pinned host
                   # memory, which also takes one update (its parameters against the
                   # CPU's sp = 1 update, its host moment bytes at the closed form)
                   "sp2_ring": dict(dp=1, pp=1, sp=2, n_chunks=2, plan=dict(attn_mode="ring")),
                   "pp2_sp2_msp_ring": dict(dp=1, pp=2, sp=2, n_chunks=4, msp=True,
                                            plan=dict(attn_mode="ring")),
                   "pods2_sp2_zero1": dict(dp=1, pp=1, sp=2, pods=2, n_chunks=2,
                                           plan=dict(offload_moments=True), update=True)}
SP_FP32_LR = dict(peak=1e-4, warmup=1, total=10)
SP_SHARED = "ranks share one card over gloo: not a model-axis speed"
# paged continuous-batching serving (paged_serve_phase, DESIGN.md §16):
# qwen2-7b at full width, all 28 layers, bf16; the engine's geometry (the
# default pool: slots x 132 blocks of a 2112-slot request = 1056) and a
# trace from numpy.random.default_rng(0): 24 requests, prompts of 256-2048
# tokens, 8-64 new tokens each, arrivals at steps 0-48; run continuous, then
# static, then PAGED_SOLO of its requests alone; PAGED_PROFILE_STEPS warm
# steps under the profiler
PAGED = dict(s_bucket=2048, max_new=64, slots=8, block_tokens=16, admit_min_free=2)
PAGED_TRACE = dict(n=24, prompt=(256, 2048), max_new=(8, 64), arrival=(0, 48))
PAGED_SOLO, PAGED_PROFILE_STEPS = 3, 8
# serving over ranks sharing the card (serve_ranks_phase): qwen2-7b at full
# width cut to 2 layers, fp32, the CPU's one device the oracle.  sp = 2
# static: prefill 256 and 8 decode steps of 2 rows; pp = 2 static: 4 rows
# in M = min(8, 4) = 4 microbatches, the planner's rule for a decode plan
# at pp > 1 (its pp here comes from an override, which the planner's
# microbatch count does not see); the engine at 1 x 2 on a 3-request trace.
# Weights are gathered over gloo at every use (≈ 0.9 GB a decode step a
# rank at 2 layers), which sets the depth and the step counts
SERVE_FP32_LAYERS = 2
SERVE_SP_SEQ, SERVE_SP_BATCH, SERVE_SP_STEPS = 256, 2, 8
SERVE_PP_SEQ, SERVE_PP_BATCH, SERVE_PP_MICRO, SERVE_PP_STEPS = 256, 4, 4, 4
SERVE_ENGINE = dict(s_bucket=128, slots=2, max_new=4, block_tokens=16, admit_min_free=1)
# a card token may differ from the CPU's only where the CPU's top-2 logit
# gap at that step is under this (a tie the two devices may break apart)
TIE_GAP = 1e-4
# the MoE family (moe_phase): granite-moe-1b-a400m at full width and all 24
# layers (d 1024, 16 heads over 8 KV heads, hd 64, 32 experts top-8, expert
# FFN 512, a tied 51200-row table), random weights from seed 0.  Static
# serving (B 4, prompt 2048 in 16 chunks, 32 decode steps, MOE_REPEATS runs),
# a 2-layer fp32 serving run against the CPU; training at B 1, S 8192 in 4
# chunks, fp32 moments on the device, MOE_STEPS steps under the default plan
# and under offload off with remat "sppo"; a 2-layer fp32 step against the
# CPU; expert parallelism at sp = 2 as two ranks sharing the card over gloo
# (2 full-width layers, fp32, S 1024), each rank's step against its own
# step on the CPU at the same layout (the drop set follows the EP width)
MOE_ARCH = "granite-moe-1b-a400m"
MOE_REPEATS, MOE_SEQ, MOE_CHUNKS, MOE_STEPS = 2, 8192, 4, 3
MOE_CHECK_SEQ, MOE_CHECK_STEPS = 256, 8
MOE_EP_LAYERS, MOE_EP_SEQ, MOE_EP_CHUNKS = 2, 1024, 2
# the reduced fp32 checks of MLA, the SSM family and the cross-attention
# families: a train step at CHECK_SEQ, a prefill of CHECK_SEQ and
# CHECK_DECODE decode steps on the card against the CPU
CHECK_SEQ, CHECK_DECODE = 256, 4
# deepseek-v3-671b (MLA) at full width: served at MLA_SERVE_LAYERS of its 61
# layers (2 x 23.0 GB of bf16 weights beside the 3.7 GB embedding and head;
# a third layer does not fit beside the transients), its loss and gradients
# at MLA_TRAIN_LAYERS (26.7 GB of weights and as much of gradients) at S
# 8192 in 4 chunks under plans (d) and (b), MLA_GRAD_CALLS calls each; the
# reduced model in fp32 against the CPU (a 2-layer step with AdamW's bf16
# moments, a prefill and CHECK_DECODE decode steps)
MLA_ARCH = "deepseek-v3-671b"
MLA_SERVE_LAYERS, MLA_REPEATS = 2, 2
MLA_TRAIN_LAYERS, MLA_SEQ, MLA_CHUNKS, MLA_GRAD_CALLS = 1, 8192, 4, 2
# the loss-and-gradients call's peak over its weights as predicted in
# PERF.md before the run that measured it: the gradients (24.9 GiB, summed
# in place by the seams' sink), one op's fresh expert gradient (7 GiB) and
# the activations (4-8 GiB)
MLA_GRAD_PEAK_PREDICTED_GIB = 38
# the SSM family (ssm_phase): rwkv6-3b (32 RWKV6 layers, d 2560, 40 heads
# of 64, FFN 8960, no attention) and zamba2-7b (81 Mamba2 mixers, d 3584,
# d_inner 7168 in 112 heads of 64, d_state 64, in 14 groups of 6, each
# group followed by the weight-shared attention block: 32 heads of hd 112,
# G 1, FFN 14336; the last group's 3 mixers past the 81st at gate 0), random
# weights from seed 0.  Served at full width and depth (B 4, prompt 2048
# in 16 chunks, 32 decode steps, SSM_REPEATS runs, the decode loop under
# sync-debug "error"); trained at full width cut in depth (SSM_TRAIN_LAYERS:
# 4 RWKV6 layers, 12 mixers = 2 zamba groups) at S 8192 in 4 chunks under
# plans (d) and (b), SSM_STEPS steps each; the reduced configs in fp32 (2
# RWKV6 layers, 2 zamba groups) on the card and the CPU
SSM_ARCHS = ("rwkv6-3b", "zamba2-7b")
SSM_REPEATS, SSM_SEQ, SSM_CHUNKS, SSM_STEPS = 2, 8192, 4, 3
SSM_TRAIN_LAYERS = {"rwkv6-3b": 4, "zamba2-7b": 12}
SSM_CHECK_LAYERS = {"rwkv6-3b": 2, "zamba2-7b": 4}
# the cross-attention families (xattn_phase): llama-3.2-vision-11b (40 self
# layers, d 4096, 32 heads over 8, hd 128, FFN 14336, a gated cross layer
# and its MLP after every 5: 8 groups; 1600 stub patches) and whisper-tiny
# (4 encoder and 4 decoder layers, d 384, 6 heads of 64, G 1, 1500 stub
# frames, learned positions), random weights from seed 0, the VLM's cross
# gates set to XATTN_GATES (0 at init: the cross layers would add nothing).
# Served at full width and depth (B 4, prompt 2048 in 16 chunks, 32 decode
# steps, XATTN_REPEATS runs, the decode loop under sync-debug "error");
# trained at full width, the VLM cut to one group (5 self layers and the
# cross layer, B 1), whisper at full depth (B 4), S 8192 in 4 chunks under
# plans (d) and (b), XATTN_STEPS steps each; the reduced configs in fp32 (one
# VLM group, 2 whisper layers) on the card and the CPU
XATTN_ARCHS = ("llama-3.2-vision-11b", "whisper-tiny")
XATTN_GATES = {"xgate_attn": 0.5, "xgate_mlp": -0.3}
XATTN_REPEATS, XATTN_SEQ, XATTN_CHUNKS, XATTN_STEPS = 2, 8192, 4, 3
XATTN_TRAIN_LAYERS = {"llama-3.2-vision-11b": 5, "whisper-tiny": 4}
XATTN_TRAIN_BATCH = {"llama-3.2-vision-11b": 1, "whisper-tiny": 4}


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


def fwd_nsplit(fa, kind, q, k, v=None):
    """KV splits of a forward call (the kernel's own geometry; the wide
    tensor-core kernel's where a head dim passes 128)."""
    B, Tq, H, hdk = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    hdv = hdk if v is None else v.shape[-1]
    if kind == "tensor_cores" and max(hdk, hdv) > fa.MAX_HD:
        return fa._tc_wide_geometry(B, Tq, S, H // Hkv, Hkv, n_sm)[0]
    geometry = fa._tc_geometry if kind == "tensor_cores" else fa._geometry
    return geometry(B, Tq, S, H // Hkv, Hkv, n_sm)[2]


def kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, causal=True, kernels=None,
                    scale=None):
    """Run a forward kernel (``kernels``: the wrapper's choice, None = by
    dtype) and the plain version on the same inputs and fail unless that
    kernel launched once (and merged its KV splits once, in the launch or by
    the merge kernel, where it split) and they agree; returns (max
    |normalized diff|, kernel outputs).  ``scale``: the scores' (None: 1 /
    sqrt(hd_k))."""
    kind = fwd_kind(kernels, q.dtype)
    before = fa.counts()
    o1, m1, l1 = fa.flash_attention_partial(q, k, v, q_pos, kv_pos, causal=causal,
                                            q_start=q_start, kernels=kernels, scale=scale)
    moved = {key: n - before[key] for key, n in fa.counts().items() if n != before[key]}
    launch, merge = FWD_KERNELS[kind]
    want = {launch: 1, **({merge: 1} if fwd_nsplit(fa, kind, q, k, v) > 1 else {})}
    check(moved == want, f"the forward launched {moved}, expected {want} ({q.dtype}, "
          f"kernels={kernels}) at q {tuple(q.shape)} k {tuple(k.shape)}")
    o2, m2, l2 = ref.attention_partial_ref(q, k, v, q_pos, kv_pos,
                                           causal=causal, q_start=q_start, scale=scale)
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


def measure_shape(name, fa, ref, q, k, v, q_pos, kv_pos, q_start, causal=True):
    """Check both forward kernels at one main-path shape on the same bf16
    inputs (each held to 1e-5) and time them in turns (CUDA cores, tensor
    cores, tensor cores, CUDA cores), each call whole (a split's merge
    included), beside the plain version and SDPA.  The bound counts what
    this data needs: q.k and p.v for each visible (query, slot) pair and
    head; bytes of the query rows that see some slot, the K/V rows some
    query of their batch row sees, every position read and every output
    written.  ``causal`` False: a cross-attention or encoder shape.
    Returns {kernels: row}."""
    errs = {kind: kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, causal=causal,
                                  kernels=kind)[0]
            for kind in FWD_KERNELS}
    B, Tq, H, hdk = q.shape
    S, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    vis = visible_mask(B, q_pos, kv_pos, q_start, causal)
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
            lambda *a, kind=kind: fa.flash_attention_partial(*a[:5], q_start=a[5], kernels=kind,
                                                             causal=causal),
            copies, label=f"the {kind} forward [{name}]"))
    plain_ms = time_ms(lambda *a: ref.attention_partial_ref(*a[:5], q_start=a[5], causal=causal),
                       copies, reps=len(copies), label=f"the plain forward [{name}]")
    mask = vis[:, None]                        # [B, 1, Tq, S]
    lib_ms = time_ms(lambda *a: F.scaled_dot_product_attention(
        a[0].transpose(1, 2), a[1].transpose(1, 2), a[2].transpose(1, 2), attn_mask=mask,
        enable_gqa=True), copies)
    bound_ms = 1e3 * max(t_bytes, t_ops)
    rows = {kind: {"shape": name, "q": list(q.shape), "kv": list(k.shape), "dtype": str(q.dtype),
                   "causal": causal, "kernels": kind, "nsplit": fwd_nsplit(fa, kind, q, k),
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
        cc["merge"] = measure_merge(name, fa, ref, copies, cc["nsplit"], (B, Tq, H, hdv),
                                    causal=causal)
    return rows


def measure_merge(name, fa, ref, copies, nsplit, shape, causal=True):
    """The CUDA-core forward's split-KV merge kernel at one shape: its own
    device time under torch.profiler (the forward call launches it), the
    plain merge (``merge_partials`` over as many partials) and its bound,
    the bytes of the partials read and of (o, m, l) written."""
    _, by_group = profiled_ms(
        lambda *a: fa.flash_attention_partial(*a[:5], q_start=a[5], kernels="cuda_cores",
                                              causal=causal),
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


def serving_shapes(gen, cfg=None):
    """The kernel's inputs at the serve path's shapes, as the path passes
    them (a position row shared by the batch, no q_start window): the last
    prefill chunk (Tq = 128 over a 2048-slot prefix view of the 2176-slot
    cache buffer) and decode step 1 (Tq = 1 over the whole buffer, a PAD
    tail); qwen2-7b's heads, or ``cfg``'s."""
    dev, bf16 = "cuda", torch.bfloat16
    H, Hkv, hd = (28, 4, 128) if cfg is None else (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
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
        # the kernels' own names first: their sources' names hold "flash_partial";
        # the wide (MLA) kernels are the same three kernels' wide-head blocks
        if "flash_fwd_tc_kernel" in name or "flash_fwd_wide_kernel" in name:
            groups["attention fwd tc kernel"] += ms
        elif "flash_bwd_dq_tc_kernel" in name or "flash_bwd_dq_wide_kernel" in name:
            groups["attention dq tc kernel"] += ms
        elif "flash_bwd_dkv_tc_kernel" in name or "flash_bwd_dkv_wide_kernel" in name:
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
                 kernels=None, scale=None):
    """A pair of backward kernels (``kernels``: the wrapper's choice, None =
    by dtype) and the plain backward on the same inputs (m from the plain
    forward); fails unless that pair launched once each and each gradient is
    within 1e-5 x max |plain gradient| and finite.  Returns ({name: max
    |diff|}, {name: max |diff| / max |plain|}, kernel gradients)."""
    _, m, _ = ref.attention_partial_ref(q, k, v, q_pos, kv_pos, causal=causal,
                                        q_start=q_start, scale=scale)
    before = fa.counts()
    got = fa.flash_attention_partial_bwd(q, k, v, q_pos, kv_pos, do, m, dl,
                                         causal=causal, q_start=q_start, kernels=kernels,
                                         scale=scale)
    moved = {key: n - before[key] for key, n in fa.counts().items() if n != before[key]}
    tc = kernels == "tensor_cores" or (kernels is None and q.dtype == torch.bfloat16)
    want_moved = {"bwd_dq_tc": 1, "bwd_dkv_tc": 1} if tc else {"bwd_dq": 1, "bwd_dkv": 1}
    check(moved == want_moved, f"the backward launched {moved}, expected {want_moved} "
          f"({q.dtype}, kernels={kernels})")
    want = ref.attention_partial_bwd_ref(q, k, v, q_pos, kv_pos, q_start, do, m, dl,
                                         causal=causal, scale=scale)
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
                       n_chunks=TRAIN_CHUNKS, dtype=torch.bfloat16, packed=None, batch=1):
    """The attention kernels' inputs at a training cell's first and last
    chunks, as the path passes them: q a head slice of the fused q|k
    projection output, K and V prefix views of the seq-slot cache buffer,
    one position row shared by the batch, fp32 do and dl, and the q_start
    window (None); the chunk plan is the cell's own.  The default is the
    bf16 training cell of phase 4, at ``batch`` rows.  ``packed`` (a
    ``PackedBatch``): its rows are the batch, the cell is resolved with its documents' lengths and
    each chunk's window is its slice of the packed ``doc_start``."""
    from repro_torch.configs.base import ShapeConfig

    B = batch if packed is None else packed.tokens.shape[0]
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


def self_attn_kernel_shapes(fa, ref, gen, runner, cfg, *, n_layers, seq, n_chunks, batch=1):
    """``cfg``'s causal self-attention at its main-path shapes: the serving
    prefill chunk (B 4, Tq 128 over a 2048-slot prefix) and decode step (Tq
    1 over the whole 2176-slot buffer), both forwards held and timed
    (``measure_shape``); the train cell's first and last chunk (``batch``
    rows, ``n_layers`` layers, ``seq`` in ``n_chunks`` chunks), forwards and
    backward pairs (``measure_bwd_shape``).  Returns (forward rows,
    backward rows)."""
    prefill_in, decode_in = serving_shapes(gen, cfg)
    fwd = [measure_shape(f"{cfg.name} prefill chunk", fa, ref, *prefill_in),
           measure_shape(f"{cfg.name} decode step", fa, ref, *decode_in)]
    del prefill_in, decode_in
    _, train_in = train_chunk_shapes(gen, runner, cfg, n_layers=n_layers, seq=seq,
                                     n_chunks=n_chunks, batch=batch)
    bwd = []
    for name, args in train_in.items():
        f, b = measure_bwd_shape(f"{cfg.name} {name}", fa, ref, *args)
        fwd.append(f)
        bwd.append(b)
    del train_in
    torch.cuda.empty_cache()
    return fwd, bwd


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


def measure_bwd_shape(name, fa, ref, q, k, v, q_pos, kv_pos, do, dl, q_start=None, causal=True):
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
    pairs and rows follow.  ``causal`` False: a cross-attention or encoder
    shape."""
    fwd_rows = measure_shape(f"train {name}", fa, ref, q, k, v, q_pos, kv_pos, q_start,
                             causal=causal)
    errs = {kernels: bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, do, dl,
                                  causal=causal, kernels=kernels)[:2] for kernels in BWD_PAIRS}
    B, Tq, H, hdk = q.shape
    S, Hkv, hdv = k.shape[1], k.shape[2], v.shape[-1]
    vis = visible_mask(B, q_pos, kv_pos, q_start, causal)
    n_vis = int(vis.sum())
    live_rows, kv_rows = int(vis.any(dim=2).sum()), int(vis.any(dim=1).sum())
    esz = q.element_size()
    rows_in = live_rows * H * (esz * hdk + 4 * (hdv + 2)) + kv_rows * Hkv * esz * (hdk + hdv)
    pos_bytes = 4 * (q_pos.numel() + S + (0 if q_start is None else q_start.numel()))
    ops = {"dq": 2 * H * n_vis * (hdk + hdv + hdk),
           "dkv": 2 * H * n_vis * (hdk + hdv + hdk + hdv)}
    out_bytes = {"dq": 4 * B * Tq * H * hdk, "dkv": 4 * B * S * Hkv * (hdk + hdv)}
    issued = tc_issued_ops(fa, vis, H // Hkv, Hkv, hdk, hdv)
    _, m, _ = ref.attention_partial_ref(q, k, v, q_pos, kv_pos, q_start=q_start, causal=causal)
    footprint = sum(t.numel() * t.element_size() for t in (q, k, v, do))
    copies = cold_copies((q, k, v, q_pos, kv_pos, do, m, dl, q_start), footprint)
    turns = {part: [] for part in BWD_GROUPS}
    for kernels in ("cuda_cores", "tensor_cores", "tensor_cores", "cuda_cores"):
        def call(*a, kernels=kernels):
            return fa.flash_attention_partial_bwd(*a[:8], q_start=a[8], kernels=kernels,
                                                  causal=causal)

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
                          "dtype": str(q.dtype), "causal": causal,
                          "ms": sum(turns[part]) / len(turns[part]),
                          "ms_turns": turns[part], "bound_ms": 1e3 * max(t_bytes, t_ops),
                          "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                          "ops": ops[base],
                          "max_abs_err": err["dq"] if base == "dq" else max(err["dk"], err["dv"]),
                          "rel_err": rel["dq"] if base == "dq" else max(rel["dk"], rel["dv"])}
    plain_ms = time_ms(lambda *a: ref.attention_partial_bwd_ref(*a[:5], a[8], *a[5:8],
                                                                causal=causal),
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


@contextlib.contextmanager
def padded(prof):
    """``prof``'s profiling session with PROFILE_PAD_S of idle host time on
    either side of the work it wraps."""
    with prof:
        time.sleep(PROFILE_PAD_S[0])
        yield prof
        time.sleep(PROFILE_PAD_S[1])


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
    scales stay on the device).  An MoE model's, an SSM model's and a
    cross-attention model's by the tag shapes their layers use
    (``moe_offload_elems``, ``ssm_offload_elems``, ``xattn_offload_elems``)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import offload as ofl

    cfg = cell.cfg
    if cfg.moe is not None or cfg.sub_quadratic or cfg.cross_attn is not None:
        elems = (moe_offload_elems(cell) if cfg.moe is not None
                 else ssm_offload_elems(cell) if cfg.sub_quadratic else xattn_offload_elems(cell))
        return int(elems * cm.ACT_ITEMSIZE * cm.offload_wire_ratio(cell.plan.offload_dtype))
    per_row = (cell.shape.global_batch * cm.tagged_bytes_per_token(cell.cfg) * cell.cfg.n_layers
               * cm.offload_wire_ratio(cell.plan.offload_dtype))
    return int(sum(ofl.split_rows(ln, a) * per_row
                   for ln, a in zip(cell.sched.lengths, cell.alphas)))


def moe_offload_elems(cell) -> int:
    """Elements of one rank's off rows a step at pp = 1 by the tag shapes an
    MoE layer uses: per chunk and layer, the rows of q, k, v and the
    attention output (MLA: of q_eff [H, dc + dr], k_eff [dc + dr] and o_v
    [H, dv]) and of the shared experts' hidden (split_rows of the rank's ln
    / sp rows, b_loc of each) and of the routed experts' hidden [E_loc, Ce,
    ff] (split_rows of its Ce capacity rows, Ce from the rank's b_loc x ln /
    sp tokens, ``models/moe.py``): not the cost model's top_k x ff a
    token."""
    from repro_torch.core import offload as ofl
    from repro_torch.models.moe import capacities, moe_dims

    cfg, sp, B = cell.cfg, cell.plan.sp, cell.b_loc
    _, e_loc = moe_dims(cfg, sp)
    if cfg.mla is not None:
        eff = cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
        attn = cfg.n_heads * eff + eff + cfg.n_heads * cfg.mla.v_head_dim
    else:
        attn = 2 * cfg.n_heads * cfg.hd + 2 * cfg.n_kv_heads * cfg.hd
    attn += cfg.moe.n_shared_experts * cfg.moe.d_ff_expert
    total = 0
    for ln, a in zip(cell.sched.lengths, cell.alphas):
        rows = ln // sp
        _, ce = capacities(cfg, B * rows, sp)
        total += (ofl.split_rows(rows, a) * B * attn
                  + e_loc * ofl.split_rows(ce, a) * cfg.moe.d_ff_expert)
    return total * cfg.n_layers


def ssm_offload_elems(cell) -> int:
    """Elements of a step's off rows at pp = 1 by the tag shapes of an SSM
    model: per chunk, split_rows of the chunk's rows, B of each, of every
    RWKV6 layer's time-mix output [d] and channel-mix hidden [d_ff]; of
    every zamba2 group's mixers' two sites [d_inner] each (the ghost mixers
    run too) and its shared block's q, k, v, attention output and MLP
    hidden.  Not the cost model's 2 x expand x d a layer (PERF.md §7)."""
    from repro_torch.core import offload as ofl

    cfg, B = cell.cfg, cell.b_loc
    if cfg.family == "ssm":
        per_row, n = cfg.d_model + cfg.d_ff, cfg.n_layers
    else:
        d_in = cfg.ssm.expand * cfg.d_model
        per_row = (cfg.shared_attn_every * 2 * d_in + 2 * cfg.n_heads * cfg.hd
                   + 2 * cfg.n_kv_heads * cfg.hd + cfg.d_ff)
        n = cell.mdef.n_slots
    return n * sum(ofl.split_rows(ln, a) * B * per_row
                   for ln, a in zip(cell.sched.lengths, cell.alphas))


def xattn_offload_elems(cell) -> int:
    """Elements of a step's off rows at pp = 1 by the tag shapes of a
    cross-attention model: per chunk and slot, split_rows of the chunk's
    rows (B of each) of every self layer's q, k, v, attention output and
    MLP hidden, and of the cross layer's q and output (the VLM's also its
    cross MLP's hidden).  Not the cost model's dense pricing, which leaves
    the cross layers out (PERF.md §7)."""
    from repro_torch.core import offload as ofl

    cfg = cell.cfg
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layer = 2 * H * hd + 2 * Hkv * hd + cfg.d_ff
    per_row = (cfg.cross_attn.every * layer + 2 * H * hd + cfg.d_ff if cfg.family == "vlm"
               else layer + 2 * H * hd)
    return cell.mdef.n_slots * sum(ofl.split_rows(ln, a) * cell.b_loc * per_row
                                   for ln, a in zip(cell.sched.lengths, cell.alphas))


def attention_layers(cfg) -> int:
    """The attention calls a chunk runs: every layer of a dense or MoE
    model, none of rwkv6's, the shared block once a zamba2 group, a VLM
    group's self layers and its cross layer, a whisper decoder layer's self
    and cross attention.  Whisper's encoder runs once a pass, outside the
    chunks (``cfg.encoder_layers``)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.shared_attn_every)
    if cfg.family == "vlm":
        return -(-cfg.n_layers // cfg.cross_attn.every) * (cfg.cross_attn.every + 1)
    if cfg.family == "audio":
        return 2 * cfg.n_layers
    return cfg.n_layers


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
               steps, label, extra=None, grads="keep", packed=None, profiled=True, batch=1):
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
    (``grad_accum``), and the untimed call is skipped.  ``profiled`` False:
    no step runs under the profiler (a cell whose profile another cell's
    holds; its row then has no device-time fields).  ``batch``: the rows of
    an unpacked cell.  A model with an encoder launches each kernel once an
    encoder layer more a step (``cfg.encoder_layers``: once a pass, no replay).
    Returns the launch counts, a summary and that call's gradients."""
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
        if not profiled or step != steps - 1:
            return contextlib.nullcontext()
        prof["p"] = profile(activities=[ProfilerActivity.CUDA])
        return padded(prof["p"])

    check(packed is None or grads == "none", "a packed run takes no untimed gradients call")
    batch = batch if packed is None else packed.tokens.shape[0]
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
    n_calls = attention_layers(cfg) * cell.sched.n * cell.plan.grad_accum
    fwd_want = n_calls * (1 if cell.plan.remat == "none" else 2)
    n_enc = cfg.encoder_layers * cell.plan.grad_accum
    fwd_want, n_calls = fwd_want + n_enc, n_calls + n_enc
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
    prof_wall = 1e3 * hist[-1]["dt"]
    profile_row = {}
    if profiled:
        timeline = copy_timeline(prof["p"], (mom_copies, mom_copies))
        if bytes_want:
            check(timeline["d2h_ms"] > 0 and timeline["h2d_ms"] > 0,
                  f"[{label}] the profiler saw no offload copy: {timeline}")
        busy_k, groups, _ = device_time(prof["p"])
        busy = timeline["device_busy_ms"]
        profile_row = {"profiled_wall_ms": prof_wall, "device_busy_ms": busy,
                       "device_kernel_ms_by_group": groups, "kernel_ms_sum": busy_k,
                       "idle_share": 1 - busy / prof_wall,
                       **{k: v for k, v in timeline.items() if k != "device_busy_ms"}}
    seconds["profile_reading"] = time.perf_counter() - t0
    # the warm steps: past step 0, and past the profiled last step where it
    # is not the only one
    warm = [1e3 * r["dt"] for r in hist[1:(-1 if profiled else None)]] or [prof_wall]
    warm_ms = sum(warm) / len(warm)
    if profiled:
        profile_row["idle_share_vs_unprofiled_wall"] = 1 - busy / warm_ms
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
           "profiled": profiled, **profile_row, "smoke_seconds": seconds}
    print_plan(row, hist, cell, card, label, steps)
    return totals, row, grad_tree


def print_plan(row, hist, cell, card, label, steps):
    gib = 2**30
    print(f"train [{label}] plan ({row['plan']}) {row['what']} ({card}): chunks "
          f"{cell.sched.lengths}, alpha deployed [{', '.join(f'{a:.4f}' for a in cell.alphas)}], "
          f"quantized [{', '.join(f'{a:.4f}' for a in row['quantized_alphas'])}]")
    for r in hist:
        print(f"  step {r['step']}: loss {r['loss']!r}, {r['dt']:.4f} s, {r['tgs']:.1f} tokens/s, "
              f"MFU {r['mfu']:.4f}"
              + (" [profiled]" if row["profiled"] and r["step"] == steps - 1 else ""))
    lg = row["grads_peak_over_weights_bytes"]
    last = steps - 2 if row["profiled"] else steps - 1
    print(f"  warm step {row['warm_step_ms']:.1f} ms (unprofiled mean of steps 1..{last}); "
          f"peak {row['peak_bytes'] / gib:.3f} GiB over the {steps} steps (weights and moments "
          f"on the device {row['base_bytes'] / gib:.3f} GiB, moments in host memory "
          f"{row['host_moment_bytes'] / gib:.3f} GiB); one untimed loss-and-gradients call peaks "
          + (f"{lg / gib:.3f} GiB above its weights" if lg is not None else "(not run)")
          + f"; the cost model's tagged-activation peak (peak_memory of chunk_act_bytes at the "
          f"quantized alphas) {row['tagged_peak_model_bytes'] / gib:.3f} GiB")
    print(f"  smoke seconds {json.dumps({k: round(v, 2) for k, v in row['smoke_seconds'].items()})}")
    if not row["profiled"]:
        print(f"  copies a step: D2H {row['d2h_bytes_per_step']} bytes, H2D "
              f"{row['h2d_bytes_per_step']} bytes; not profiled")
        return
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

    def run_cell(plans, seq, n_chunks, label, cfg_n=cfg4):
        rows, totals, ref = {}, {}, None
        for plan in plans:
            totals[plan], rows[plan], grads = train_plan(
                fa, hostmem, serve, runner, train_mod, cfg_n, card, plan, seq=seq,
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
    long_plans = ("d", "b", "e") + (("a",) if LONG_LAYERS == TRAIN_LAYERS
                                     and LONG_PLAN_A_PREDICTED_GIB < 75 else ())
    t0 = time.perf_counter()
    long_rows, long_totals, _ = run_cell(long_plans, LONG_SEQ, LONG_CHUNKS, f"S={LONG_SEQ}",
                                         dataclasses.replace(cfg, n_layers=LONG_LAYERS))
    seconds["plans_s32768"] = time.perf_counter() - t0
    print(f"train phase seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}")
    if "a" not in long_plans:
        print(f"train [S={LONG_SEQ}] plan (a) not run ({LONG_LAYERS} layers; at 4 its "
              f"predicted peak was {LONG_PLAN_A_PREDICTED_GIB} GiB, PERF.md)")
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
        pad_cell = key == "pad_d"
        totals[key], rows[key], _ = train_plan(
            fa, hostmem, serve, runner, train_mod, cfg4, card, plan, seq=PACKED_SEQ,
            n_chunks=PACKED_CHUNKS, steps=PAD_STEPS if pad_cell else PACKED_STEPS, label=key,
            extra=dict(grad_accum=len(pb.tokens)), grads="none", packed=pb,
            profiled=not pad_cell)
        r = rows[key]
        warm_s = r["warm_step_ms"] / 1e3
        r.update(real_tokens=real, real_tokens_per_s=real / warm_s,
                 mfu_real=6 * n_active * real / warm_s / BF16_FLOPS, doc_lens=lens)
        print(f"train [{key}] ({card}): chunks {r['chunks']}, alpha "
              f"{[round(a, 4) for a in r['alphas']]}; warm step {r['warm_step_ms']:.1f} ms, "
              f"{r['real_tokens_per_s']:.1f} real tokens/s, MFU over real tokens "
              f"{r['mfu_real']:.4f}; peak {r['peak_bytes'] / 2**30:.3f} GiB; rows' copies "
              f"{r['d2h_bytes_per_step']} bytes each way a step (the closed form); launches a "
              f"step {r['launches_per_step']}; idle share "
              + (f"{r['idle_share']:.3f}" if r["profiled"] else "not profiled"))
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


def _port_path():
    """The port's sources on the path of this process (a spawned rank too)."""
    src = str(Path(__file__).resolve().parent / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def pipe_offload_bytes(cell, stage: int, spp: int, *, itemsize_ratio: int = 1) -> int:
    """D2H bytes of one rank's step at pp > 1 by the closed form: Σ over the
    rank's events e of split_rows(chunk length, α of the event fed at its
    tick e + stage) x its rows x the tagged bytes of a token in each of its
    ``spp`` slots (bf16; ``itemsize_ratio`` 2 for fp32).  At pp = 1, the
    chunks with their own α."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import offload as ofl

    per_row = cell.b_loc * cm.tagged_bytes_per_token(cell.cfg) * spp * itemsize_ratio
    if cell.plan.pp == 1:
        return int(sum(ofl.split_rows(ln, a) * per_row
                       for ln, a in zip(cell.sched.lengths, cell.alphas)))
    from repro_torch.parallel import runner

    events = runner.pipeline_feed_events(cell.plan, cell.sched.n)
    clen, E = cell.shape.seq_len // cell.sched.n, len(events)
    return int(sum(ofl.split_rows(clen, cell.alphas[events[min(e + stage, E - 1)][0]]) * per_row
                   for e in range(E)))


def pipe_bcast_bytes(cfg, stage: int, pp: int) -> int:
    """Bytes of global gradients one rank sends a step by the closed form
    (``Ctx.psum_globals``, dp = 1, an untied model): stage 0 the embedding,
    the last stage the rest of the globals (final norm, head), each to the
    pp - 1 other stages; a middle stage nothing."""
    from repro_torch.core import tree
    from repro_torch.models.model_zoo import build_model

    glob = build_model(cfg).init_globals(torch.Generator(), torch.bfloat16, "meta")
    owned = [k for k in glob if (k == "embed") == (stage == 0)] if stage in (0, pp - 1) else []
    return (pp - 1) * sum(t.numel() * t.element_size() for k in owned
                          for t in tree.leaves(glob[k]))


def _fingerprint(t) -> int:
    """An order-sensitive checksum of a tensor's bits."""
    bits = t.detach().contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)
    w = torch.arange(bits.numel(), device=t.device) % 1021 + 1
    return int((bits.reshape(-1).long() * w).sum())


def pipe_rank(rank, device, fp32_layouts, params_np, tokens_np, labels_np):
    """One rank of the full-width pipeline cell (``pipeline_phase``).  Rank 0
    first runs pp = 1 with the same weights and equal chunks (one untimed
    loss-and-gradients call, then PIPE_STEPS steps through
    ``launch.train.train``) while the other rank waits, and sends each rank
    its stage's pp = 1 gradients.  Then, for the plain feed and MSP, each
    rank takes one untimed loss-and-gradients call on fresh weights (held
    against pp = 1: bitwise, or the worst leaf's relative L2) and
    PIPE_STEPS steps through ``launch.train.train``, counting each step's
    launches, row copies and hand-offs.  Last, the reduced fp32
    ``fp32_layouts`` of this many ranks (``_fp32_layout``)."""
    _port_path()
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_mod
    from repro_torch.models.model_zoo import build_model
    from repro_torch.parallel import runner
    from repro_torch.parallel.ctx import SINGLE, Ctx
    from repro_torch.runtime import hostmem

    t_up = time.time()
    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(name)s %(message)s")
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=PIPE_LAYERS)
    shape = ShapeConfig("pipeline", PIPE_SEQ, 1, "train")
    ctx = Ctx(dp=1, pp=PIPE_PP, device=device)
    stage, spp = ctx.stage_index(), PIPE_LAYERS // PIPE_PP
    tokens, labels = (torch.from_numpy(a).to(device) for a in
                      SyntheticLM(cfg.vocab_size, PIPE_SEQ, 1).sample_step(0))
    out = {"rank": rank, "stage": stage, "t_up": t_up}

    def peak_reset():
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        return torch.cuda.memory_allocated(device)

    # pp = 1: the same weights (seed 0), equal chunks, on rank 0 alone
    ref = {}
    if rank == 0:
        cell1 = runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, n_chunks=PIPE_CHUNKS,
                                                               partition="length"))
        params = serve.build_params(cell1, device, seed=0)
        base = peak_reset()
        loss1, grads1 = runner.loss_and_grads(cell1, params, tokens, labels)
        out["pp1_grads_call_peak_over_weights"] = torch.cuda.max_memory_allocated(device) - base
        ref = {path: g.cpu() for path, g in tree.items(grads1)}
        out["pp1_loss"] = float(loss1)
        del params, grads1
        torch.cuda.empty_cache()
        res = train_mod.train(cfg, steps=PIPE_STEPS, seq=PIPE_SEQ, batch=1,
                              n_chunks=PIPE_CHUNKS, log_every=PIPE_STEPS, device=device,
                              overrides=dict(partition="length"), ctx=SINGLE)
        out["pp1"] = {"losses": [r["loss"] for r in res["history"]],
                      "step_s": [r["dt"] for r in res["history"]],
                      "peak_bytes": res["peak_bytes"], "chunks": list(res["cell"].sched.lengths)}
        del res
        torch.cuda.empty_cache()
    # each rank's stage of the pp = 1 gradients, from rank 0
    shapes = dict(tree.items({"stages": build_model(cfg).init_stage_params(
        torch.Generator(), device="meta")}))
    for r in range(1, PIPE_PP):
        for path in sorted(shapes):
            layer = int(path.split("/")[1])
            if not r * spp <= layer < (r + 1) * spp:
                continue
            if rank == 0:
                dist.send(ref[path].contiguous(), dst=r)
            elif rank == r:
                buf = torch.empty(shapes[path].shape, dtype=torch.bfloat16
                                  if not path.endswith("gate") else torch.float32)
                dist.recv(buf, src=0)
                ref[path] = buf
    ctx.barrier()
    for label, msp in (("plain", False), ("msp", True)):
        ov = dict(pp=PIPE_PP, msp=msp, msp_split=PIPE_SPLIT)
        cell = runner.resolve_cell(cfg, shape, overrides=dict(ov, dp=1, n_chunks=PIPE_CHUNKS),
                                   data_size=PIPE_PP)
        # one untimed loss-and-gradients call on fresh weights
        params = serve.build_params(cell, device, seed=0, stage=stage)
        base = peak_reset()
        loss0, grads = runner.loss_and_grads(cell, params, tokens, labels, ctx=ctx)
        grads_peak = torch.cuda.max_memory_allocated(device) - base
        cmp, worst = {"bitwise": 0, "differ": []}, 0.0
        for path, g in tree.items(grads["stages"]):
            i, rest = path.split("/", 1)
            want = ref[f"stages/{stage * spp + int(i)}/{rest}"]
            got = g.cpu()
            rel = ((got.float() - want.float()).norm()
                   / want.float().norm().clamp_min(1e-30)).item()
            worst = max(worst, rel)
            if torch.equal(got, want):
                cmp["bitwise"] += 1
            else:
                cmp["differ"].append((f"stages/{stage * spp + int(i)}/{rest}", rel))
        glob = {path: g for path, g in tree.items(grads["globals"])}
        if rank == 0:
            for path, g in glob.items():
                got, want = g.cpu(), ref[f"globals/{path}"]
                rel = ((got.float() - want.float()).norm()
                       / want.float().norm().clamp_min(1e-30)).item()
                worst = max(worst, rel)
                if torch.equal(got, want):
                    cmp["bitwise"] += 1
                else:
                    cmp["differ"].append((f"globals/{path}", rel))
        prints = [None] * PIPE_PP
        dist.all_gather_object(prints, [_fingerprint(g) for g in glob.values()])
        cmp["differ"].sort(key=lambda d: -d[1])
        cmp.update(worst_rel_l2=worst, globals_same_on_every_rank=all(p == prints[0]
                                                                      for p in prints))
        del params, grads, glob
        torch.cuda.empty_cache()
        # the train entry point, each step's launches, copies and hand-offs counted
        after = []

        def on_step(step, rec):
            after.append({**fa.counts(), **{"copy_" + k: v for k, v in hostmem.counts().items()},
                          **{"ctx_" + k: v for k, v in ctx.counts().items()}})

        fa.reset_counts()
        hostmem.reset_counts()
        ctx.reset_counts()
        res = train_mod.train(cfg, steps=PIPE_STEPS, seq=PIPE_SEQ, batch=1,
                              n_chunks=PIPE_CHUNKS, log_every=PIPE_STEPS, device=device,
                              overrides=ov, on_step=on_step, ctx=ctx)
        per_step = [{k: a[k] - b.get(k, 0) for k in a} for a, b in zip(after, [{}] + after[:-1])]
        rcell = res["cell"]
        E = len(runner.pipeline_feed_events(rcell.plan, rcell.sched.n))
        out[label] = {
            "loss0_grads_call": float(loss0), "grads_vs_pp1": cmp,
            "grads_call_peak_over_weights": grads_peak,
            "losses": [r["loss"] for r in res["history"]],
            "step_s": [r["dt"] for r in res["history"]],
            "tokens_per_s_per_gpu": [r["tgs"] for r in res["history"]],
            "peak_bytes": res["peak_bytes"], "base_bytes": res["base_bytes"],
            "alphas": list(rcell.alphas), "events": E, "ticks": E + PIPE_PP - 1,
            "valid_ticks": E, "idle_ticks": PIPE_PP - 1,
            "closed_form_d2h_bytes": pipe_offload_bytes(rcell, stage, spp),
            "closed_form_bcast_bytes": pipe_bcast_bytes(cfg, stage, PIPE_PP),
            "launch_want": {"fwd_tc": 2 * E * spp, "bwd_dq_tc": E * spp, "bwd_dkv_tc": E * spp},
            "per_step": per_step, "launches": after[-1] if after else {}}
        del res
        torch.cuda.empty_cache()
    out["t_full_done"] = time.time()
    out["fp32"] = {name: _fp32_layout(rank, device, layout, params_np, tokens_np, labels_np)
                   for name, layout in fp32_layouts.items()}
    out["t_done"] = time.time()
    return out


def pipe_fp32_rank(rank, device, layouts, params_np, tokens, labels):
    """One rank of each reduced fp32 layout of ``layouts`` (name -> layout,
    all of this many ranks), in turn; with the wall-clock times at which
    the rank started and finished."""
    t_up = time.time()
    out = {name: _fp32_layout(rank, device, layout, params_np, tokens, labels)
           for name, layout in layouts.items()}
    return {"layouts": out, "t_up": t_up, "t_done": time.time()}


def _fp32_layout(rank, device, layout, params_np, tokens, labels):
    """One rank of a reduced fp32 layout: the loss and every gradient of the
    rank's parameters under the default plan, through the CUDA-core
    kernels, with its launches and copies and their closed forms."""
    _port_path()
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import runner
    from repro_torch.runtime import hostmem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2-7b").reduced()
    world = layout["dp"] * layout["pp"]
    cell = runner.resolve_cell(
        cfg, ShapeConfig("pipeline_fp32", PIPE_FP32_SEQ, PIPE_FP32_BATCH, "train"),
        overrides=dict(pp=layout["pp"], dp=layout["dp"], n_chunks=layout["n_chunks"],
                       msp=layout.get("msp", False), grad_accum=1),
        dtype=torch.float32, data_size=world)
    ctx = cell.ctx(device=device)
    stage, g = ctx.stage_index(), ctx.dp_index()
    params = params_from_numpy(params_np, dtype=torch.float32, device=device, stage=stage,
                               pp=layout["pp"], cfg=cfg)
    spp = len(params["stages"])
    rows = slice(g * cell.b_loc, (g + 1) * cell.b_loc)
    fa.reset_counts()
    hostmem.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, torch.from_numpy(tokens[rows]).to(device),
                                        torch.from_numpy(labels[rows]).to(device), ctx=ctx)
    launched, copied = fa.counts(), hostmem.counts()
    # the closed forms: per event (or chunk) and slot, the forward twice (its
    # replay) with a merge per call that splits its KV range, dq and dk/dv once
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    G = cfg.n_heads // cfg.n_kv_heads
    if cell.plan.pp > 1:
        clen = PIPE_FP32_SEQ // cell.sched.n
        seams = [(clen, (c + 1) * clen) for c, _, _ in
                 runner.pipeline_feed_events(cell.plan, cell.sched.n)]
    else:
        seams = [(ln, off + ln) for off, ln in zip(cell.sched.offsets, cell.sched.lengths)]
    splits = sum(fa._geometry(cell.b_loc, tq, kv, G, cfg.n_kv_heads, n_sm)[2] > 1
                 for tq, kv in seams)
    n = len(seams) * spp
    want = {**{k: 0 for k in launched}, "fwd": 2 * n, "merge": 2 * splits * spp,
            "bwd_dq": n, "bwd_dkv": n}
    return {"rank": rank, "stage": stage, "dp_index": g, "spp": spp, "loss": float(loss),
            "grads": {path: t.cpu().numpy() for path, t in tree.items(grads)},
            "launched": launched, "launch_want": want, "copied": copied,
            "closed_form_d2h_bytes": pipe_offload_bytes(cell, stage, spp, itemsize_ratio=2),
            "events": len(seams), "alphas": list(cell.alphas)}


def _stack_numpy(slots):
    """A list of per-slot trees -> one tree of numpy arrays with a leading
    slot dim (``convert.params_from_numpy``'s layout)."""
    if isinstance(slots[0], dict):
        return {k: _stack_numpy([s[k] for s in slots]) for k in slots[0]}
    return np.stack([s.numpy() for s in slots]).astype(np.float32)


def pipeline_phase(fa, mesh, runner, card):
    """SPPO's multi-rank sequence pipeline (DESIGN.md §2, §4) with its ranks
    as processes sharing the one card over gloo (``launch.mesh.spawn``; NCCL
    refuses two ranks on one device): the full-width cell (``pipe_rank``)
    and after it the reduced fp32 layouts of as many ranks, while a spawn
    of its own runs the fp32 layouts of four ranks (``pipe_fp32_rank``)
    beside them; every fp32 layout is held against the CPU.  Every time it
    prints is marked SHARED_CARD.  Returns (the counts of the
    kernels' launches by path, a summary)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model_zoo import build_model

    gib = 2**30
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    # the reduced fp32 model, its batch and the CPU's pp = 1 step
    cfg = get_config("qwen2-7b").reduced()
    mdef = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = {"stages": mdef.init_stage_params(gen, torch.float32, "cpu"),
              "globals": mdef.init_globals(gen, torch.float32, "cpu")}
    params_np = {"stages": _stack_numpy(params["stages"]),
                 "globals": tree_map(lambda t: t.numpy(), params["globals"])}
    tokens, labels = SyntheticLM(cfg.vocab_size, PIPE_FP32_SEQ, PIPE_FP32_BATCH).sample_step(0)
    cpu_cell = runner.resolve_cell(cfg, ShapeConfig("pipeline_fp32", PIPE_FP32_SEQ,
                                                    PIPE_FP32_BATCH, "train"),
                                   overrides=dict(pp=1, dp=1, grad_accum=1), dtype=torch.float32)
    cpu_loss, cpu_grads = runner.loss_and_grads(cpu_cell, params, torch.from_numpy(tokens),
                                                torch.from_numpy(labels))
    cpu_grads = dict(tree.items(cpu_grads))
    by_world = {}
    for name, layout in PIPE_FP32_LAYOUTS.items():
        by_world.setdefault(layout["dp"] * layout["pp"], {})[name] = layout
    check(set(by_world) <= {PIPE_PP, 4}, f"fp32 layouts of {sorted(by_world)} ranks")
    # the fp32 layouts of other rank counts in their own spawn, started
    # beside the full-width one: their ranks' start-up (each process reaches
    # the card in seconds) and their small steps overlap the full-width cell
    others = {}

    def spawn_others():
        try:
            for world, layouts in by_world.items():
                if world != PIPE_PP:
                    others[world] = mesh.spawn(pipe_fp32_rank, world, backend=PIPE_BACKEND,
                                               device="cuda",
                                               args=(layouts, params_np, tokens, labels),
                                               timeout_s=PIPE_DEADLINE_S)
        except BaseException as err:  # noqa: BLE001 -- raised again after the join
            others["error"] = err
        others["t_end"] = time.time()

    t_wall = time.time()
    side = threading.Thread(target=spawn_others, daemon=True)
    side.start()
    # the full-width cell, then the fp32 layouts of as many ranks
    ranks = mesh.spawn(pipe_rank, PIPE_PP, backend=PIPE_BACKEND, device="cuda",
                       args=(by_world.get(PIPE_PP, {}), params_np, tokens, labels),
                       timeout_s=PIPE_DEADLINE_S)
    t_full = time.perf_counter() - t0
    t_full_end = time.time()
    side.join()
    if "error" in others:
        raise others["error"]
    print(f"pipeline spawns (s after the {PIPE_PP}-rank spawn began; {SHARED_CARD}): its ranks "
          f"up at {[round(r['t_up'] - t_wall, 1) for r in ranks]}, full-width cell done at "
          f"{[round(r['t_full_done'] - t_wall, 1) for r in ranks]}, done at "
          f"{[round(r['t_done'] - t_wall, 1) for r in ranks]}, spawn returned at "
          f"{t_full_end - t_wall:.1f}; " + "; ".join(
              f"the {w}-rank spawn beside it: up at {[round(r['t_up'] - t_wall, 1) for r in got]}, "
              f"done at {[round(r['t_done'] - t_wall, 1) for r in got]}, returned at "
              f"{others['t_end'] - t_wall:.1f}" for w, got in others.items()
              if isinstance(w, int)))
    r0 = ranks[0]
    pp1 = r0["pp1"]
    print(f"pipeline [{card}] qwen2-7b {PIPE_LAYERS} layers at full width, B = 1, S = {PIPE_SEQ} "
          f"in {PIPE_CHUNKS} equal chunks, pp = {PIPE_PP} as {PIPE_PP} ranks on one card over "
          f"{PIPE_BACKEND} (hand-offs staged through pinned host memory), the default plan")
    print(f"pipeline pp = 1 (rank 0 alone, same weights, chunks {pp1['chunks']}): losses "
          f"{pp1['losses']}, step s {[round(x, 4) for x in pp1['step_s']]}, peak "
          f"{pp1['peak_bytes'] / gib:.2f} GiB; grads-call loss {r0['pp1_loss']!r}")
    counts, summary = {}, {"pp1": pp1, "full_width_seconds": t_full}
    for label in ("plain", "msp"):
        rows = [r[label] for r in ranks]
        tot = {k: sum(r["launches"].get(k, 0) for r in rows) for k in rows[0]["launches"]
               if not k.startswith(("copy_", "ctx_"))}
        counts[label] = tot
        for r, row in zip(ranks, rows):
            for step, c in enumerate(row["per_step"]):
                want = row["launch_want"]
                check(all(c[k] == v for k, v in want.items()) and c["merged_in_kernel"] == 0
                      and c["fwd"] == c["merge"] == c["bwd_dq"] == c["bwd_dkv"] == 0,
                      f"pipeline [{label}] rank {r['rank']} step {step} launched "
                      f"{ {k: v for k, v in c.items() if not k.startswith(('copy_', 'ctx_'))} }; "
                      f"expected {want} ({row['events']} events x {PIPE_LAYERS // PIPE_PP} "
                      "layers, the forward twice: its replay), no CUDA-core launch")
                check(c["copy_d2h_bytes"] == c["copy_h2d_bytes"] == row["closed_form_d2h_bytes"]
                      and c["copy_d2h_pinned"] == c["copy_d2h"] == c["copy_h2d"],
                      f"pipeline [{label}] rank {r['rank']} step {step} copied "
                      f"{c['copy_d2h_bytes']} / {c['copy_h2d_bytes']} bytes; closed form "
                      f"{row['closed_form_d2h_bytes']}, every host buffer pinned")
                check(c["ctx_bcast_bytes"] == row["closed_form_bcast_bytes"],
                      f"pipeline [{label}] rank {r['rank']} step {step} sent "
                      f"{c['ctx_bcast_bytes']} bytes of global gradients; closed form "
                      f"{row['closed_form_bcast_bytes']} (the globals its stage alone uses)")
            losses = row["losses"]
            check(len(losses) == PIPE_STEPS and all(np.isfinite(losses)),
                  f"pipeline [{label}] rank {r['rank']} losses {losses}")
            check(losses == rows[0]["losses"], f"pipeline [{label}] ranks disagree on the loss")
            cmp = row["grads_vs_pp1"]
            check(cmp["globals_same_on_every_rank"],
                  f"pipeline [{label}] the ranks' global gradients differ")
            check(cmp["worst_rel_l2"] <= GRAD_PLAN_TOL,
                  f"pipeline [{label}] rank {r['rank']} step-0 gradients differ from pp = 1's by "
                  f"{cmp['worst_rel_l2']:.3e} relative L2 at the worst leaf (tol {GRAD_PLAN_TOL})")
            ms = [1e3 * x for x in row["step_s"]]
            last = row["per_step"][-1]
            ticks = row["ticks"]
            print(f"pipeline [{label}] rank {r['rank']} (stage {r['stage']}): losses {losses}; "
                  f"step ms {[round(x, 1) for x in ms]} ({SHARED_CARD}); peak "
                  f"{row['peak_bytes'] / gib:.2f} GiB (base {row['base_bytes'] / gib:.2f}); "
                  f"ticks {ticks} = {row['valid_ticks']} valid + {row['idle_ticks']} idle; "
                  f"hand-offs a step {last['ctx_handoffs']} ({last['ctx_handoff_bytes']} bytes "
                  f"sent), {1e3 * last['ctx_handoff_s'] / ticks:.3f} ms a tick of which staging "
                  f"{1e3 * last['ctx_staging_s'] / ticks:.3f} ms ({SHARED_CARD}); reductions: "
                  f"{last['ctx_reduce_bytes']} bytes all-reduced and {last['ctx_bcast_bytes']} "
                  f"bytes of global gradients sent (closed form "
                  f"{row['closed_form_bcast_bytes']}), {1e3 * last['ctx_reduce_s']:.1f} ms "
                  f"({SHARED_CARD}); "
                  f"row copies {last['copy_d2h_bytes']} bytes each way (closed form "
                  f"{row['closed_form_d2h_bytes']}); launches a step "
                  f"{ {k: last[k] for k in row['launch_want']} }; step-0 gradients vs pp = 1: "
                  f"{cmp['bitwise']} leaves bitwise, {len(cmp['differ'])} differ, worst relative "
                  f"L2 {cmp['worst_rel_l2']:.3e} {cmp['differ'][:4]}")
        summary[label] = [{k: v for k, v in row.items() if k != "per_step"} for row in rows]
    plain0, msp0 = ranks[-1]["plain"]["losses"][0], ranks[-1]["msp"]["losses"][0]
    check(abs(msp0 - plain0) <= 1e-3 * abs(plain0),
          f"pipeline MSP's step-0 loss {msp0} vs plain's {plain0}")
    print(f"pipeline step-0 loss: pp = 1 {pp1['losses'][0]!r}, pp = {PIPE_PP} plain {plain0!r} "
          f"({'bitwise' if plain0 == pp1['losses'][0] else 'differs'}), MSP {msp0!r} "
          f"(vs plain {msp0 - plain0:+.3e}); losses by step pp = 1 {pp1['losses']}, plain "
          f"{ranks[-1]['plain']['losses']}, MSP {ranks[-1]['msp']['losses']}")
    check(abs(plain0 - pp1["losses"][0]) <= 1e-3 * abs(pp1["losses"][0]),
          f"pipeline step-0 loss {plain0} vs pp = 1's {pp1['losses'][0]}")

    # the reduced fp32 layouts, each against the CPU's pp = 1 step
    fp32 = {name: [r["fp32"][name] for r in ranks] for name in by_world.get(PIPE_PP, {})}
    for world, got in others.items():
        if isinstance(world, int):
            fp32.update({name: [r["layouts"][name] for r in got] for name in by_world[world]})
    summary["fp32"] = {"side_spawn_seconds": others["t_end"] - t_wall}
    for name, layout in PIPE_FP32_LAYOUTS.items():
        franks = fp32[name]
        worst, loss_rel = 0.0, 0.0
        for r in franks:
            loss_rel = max(loss_rel, abs(r["loss"] - float(cpu_loss)) / abs(float(cpu_loss)))
            for path, g in r["grads"].items():
                kind, rest = path.split("/", 1)
                if kind == "stages":
                    i, leaf = rest.split("/", 1)
                    j = r["stage"] * r["spp"] + int(i)
                    if j >= cfg.n_layers:                  # a ghost slot
                        check(not np.any(g), f"pipeline fp32 [{name}] ghost slot gradient")
                        continue
                    want = cpu_grads[f"stages/{j}/{leaf}"].numpy()
                else:
                    want = cpu_grads[path].numpy()
                norm = np.linalg.norm(want)
                if norm == 0:
                    check(not np.any(g), f"pipeline fp32 [{name}] {path}: expected zeros")
                    continue
                worst = max(worst, float(np.linalg.norm(g - want) / norm))
            check(r["launched"] == r["launch_want"],
                  f"pipeline fp32 [{name}] rank {r['rank']} launched {r['launched']}, expected "
                  f"{r['launch_want']}")
            c = r["copied"]
            check(c["d2h_bytes"] == c["h2d_bytes"] == r["closed_form_d2h_bytes"]
                  and c["d2h_pinned"] == c["d2h"],
                  f"pipeline fp32 [{name}] rank {r['rank']} copied {c}; closed form "
                  f"{r['closed_form_d2h_bytes']} bytes each way, pinned")
        check(loss_rel <= GRAD_REL_TOL and worst <= GRAD_REL_TOL,
              f"pipeline fp32 [{name}] vs the CPU's pp = 1 step: loss {loss_rel:.3e}, worst "
              f"gradient relative L2 {worst:.3e} (tol {GRAD_REL_TOL})")
        lc = {k: sum(r["launched"][k] for r in franks) for k in franks[0]["launched"]}
        counts[f"fp32_{name}"] = lc
        summary["fp32"][name] = {"loss_rel": loss_rel, "worst_grad_rel_l2": worst,
                                 "events": franks[0]["events"], "launches": lc,
                                 "d2h_bytes": [r["copied"]["d2h_bytes"] for r in franks]}
        print(f"pipeline fp32 [{name}] {layout} on one card over {PIPE_BACKEND}: loss "
              f"{franks[0]['loss']:.6f} vs CPU pp = 1 {float(cpu_loss):.6f} (relative "
              f"{loss_rel:.3e}), worst gradient relative L2 {worst:.3e} (every leaf of every "
              f"rank), launches by the closed form on every rank {lc}, row copies "
              f"{summary['fp32'][name]['d2h_bytes']} bytes (closed form)")
    summary["seconds"] = time.perf_counter() - t0
    print(f"pipeline phase took {summary['seconds']:.1f} s (to the end of the {PIPE_PP}-rank "
          f"spawn, the full-width cell and its fp32 layouts, {t_full:.1f} s; the fp32 layouts of "
          f"other rank counts in a spawn beside it)")
    return counts, summary


def shard_positions(offsets, lengths, sp: int, rank: int, upto: int):
    """The positions of model rank ``rank``'s cache slots through chunk
    ``upto``: chunk c's rows ``off + rank * ln / sp + arange(ln / sp)``, so
    the slots ascend with gaps."""
    return torch.cat([off + rank * (ln // sp) + torch.arange(ln // sp, dtype=torch.int32)
                      for off, ln in list(zip(offsets, lengths))[:upto + 1]])


def model_axis_inputs(gen, cell, c, mode, rank, dtype, kv_rank=None):
    """The kernels' inputs at chunk ``c`` of a model-axis cell (sp =
    ``cell.plan.sp``) as model rank ``rank`` passes them: under gather_q
    every query of the chunk (a head slice of the fused q|k projection,
    positions off + arange(ln)) over the rank's cache shard (a prefix view
    of its buffer, gapped positions); under gather_kv the rank's queries
    over every rank's shard concatenated rank by rank (positions that do
    not ascend); under the ring, one hop: the rank's queries over the
    block that started on ``kv_rank`` (its cache view, gapped positions).
    Returns (q, k, v, q_pos, kv_pos, do, dl, q_start None)."""
    cfg, sp = cell.cfg, cell.plan.sp
    B, dev = cell.b_loc, "cuda"
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    offs, lens = cell.sched.offsets, cell.sched.lengths
    off, ln = offs[c], lens[c]
    lloc, kv_view = ln // sp, (off + ln) // sp
    loc = cell.shape.seq_len // sp

    def shard(r):
        k = torch.randn(B, loc, Hkv, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, loc, Hkv, hd, generator=gen, device=dev).to(dtype)
        return k, v, shard_positions(offs, lens, sp, r, c).to(dev)

    if mode == "gather_q":
        k, v, kv_pos = shard(rank)
        k, v = k[:, :kv_view], v[:, :kv_view]
        q_pos = off + torch.arange(ln, dtype=torch.int32, device=dev)
        tq = ln
    elif mode == "ring":
        k, v, kv_pos = shard(kv_rank)
        k, v = k[:, :kv_view], v[:, :kv_view]
        q_pos = off + rank * lloc + torch.arange(lloc, dtype=torch.int32, device=dev)
        tq = lloc
    else:
        parts = [shard(r) for r in range(sp)]
        k = torch.cat([p[0][:, :kv_view] for p in parts], dim=1)
        v = torch.cat([p[1][:, :kv_view] for p in parts], dim=1)
        kv_pos = torch.cat([p[2] for p in parts])
        q_pos = off + rank * lloc + torch.arange(lloc, dtype=torch.int32, device=dev)
        tq = lloc
    qk = torch.randn(B, tq, H + Hkv, hd, generator=gen, device=dev).to(dtype)
    do = torch.randn(B, tq, H, hd, generator=gen, device=dev)
    dl = torch.randn(B, tq, H, generator=gen, device=dev)
    return qk[:, :, :H], k, v, q_pos, kv_pos, do, dl, None


def model_axis_cell(runner, cfg, seq, batch, n_chunks, dtype=torch.bfloat16, **ov):
    """The sp = SP cell of ``cfg`` at pp = 1, the default plan."""
    from repro_torch.configs.base import ShapeConfig

    return runner.resolve_cell(cfg, ShapeConfig("model_axis", seq, batch, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=n_chunks, sp=SP, **ov),
                               dtype=dtype, data_size=1, model_size=SP)


def model_axis_check_shapes(fa, ref, gen, runner, cfg):
    """The kernels at the model axis's shapes, untimed: the full-width
    cell's first chunk under gather_q on rank 1's shard (whose first half
    of the queries sees no slot: those rows must be exactly o = l = 0, m =
    -1e30, in bf16 and fp32), the ring's hop of its first chunk on rank 0
    over the block of rank 1 (wholly in the queries' future: every row
    exactly dead) and the fp32 layouts' chunk shapes (S = 256, the reduced
    width: the CUDA-core kernels; the ring's four hops of each chunk), each
    forward within 1e-5 and each backward pair within 1e-5 x max |plain|.
    Returns (forward's worst error, backward's worst relative error)."""
    fwd_err, bwd_rel = 0.0, 0.0
    cell = model_axis_cell(runner, dataclasses.replace(cfg, n_layers=SP_LAYERS), SP_SEQ, 1,
                           SP_CHUNKS)
    small = model_axis_cell(runner, get_config_reduced(), SP_FP32_SEQ, SP_FP32_BATCH, 2,
                            dtype=torch.float32)
    cases = [(cell, 0, mode, r, kv, dt) for mode, r, kv in (("gather_q", 1, None), ("ring", 0, 1))
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(small, c, mode, r, None, torch.float32) for c in (0, 1)
              for mode in ("gather_q", "gather_kv") for r in (0, 1)]
    cases += [(small, c, "ring", r, kv, torch.float32) for c in (0, 1) for r in (0, 1)
              for kv in (0, 1)]
    for cl, c, mode, r, kv, dt in cases:
        q, k, v, q_pos, kv_pos, do, dl, qs = model_axis_inputs(gen, cl, c, mode, r, dt,
                                                               kv_rank=kv)
        err, (o, m, l) = kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, qs)
        _, rel, _ = bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, qs, do, dl)
        dead = visible_mask(q.shape[0], q_pos, kv_pos, qs).any(dim=2).logical_not()
        dead = dead[..., None].expand_as(m)
        n_dead = int(dead.sum())
        if cl is cell:
            # gather_q: the first half of the chunk's queries precede rank
            # 1's slots; the ring's hop: all of rank 0's do
            n_dead = q.shape[0] * (cl.sched.lengths[c] // SP) * q.shape[2]
        if n_dead:
            check_dead_rows(o, m, l, dead, n_dead, f"{mode} chunk {c} on rank {r} ({dt})")
        fwd_err, bwd_rel = max(fwd_err, err), max(bwd_rel, *rel.values())
        mode = mode if kv is None else f"{mode} hop from rank {kv}"
        print(f"model-axis check shape [{mode} chunk {c} rank {r}] q {tuple(q.shape)} kv "
              f"{tuple(k.shape)} {dt}: forward err {err:.3e}, backward rel err "
              + ", ".join(f"{key} {val:.2e}" for key, val in rel.items())
              + f", {int(dead[..., 0].sum())} dead rows, exact")
    return fwd_err, bwd_rel


def get_config_reduced():
    from repro_torch.configs.base import get_config

    return get_config("qwen2-7b").reduced()


def model_axis_closed_form(cell, *, with_norm: bool) -> dict:
    """What one rank's step moves over the model group at pp = 1, by the
    closed form: {collective: (calls, bytes this rank puts in)} (a gather's
    input is the rank's shard, the others' the whole tensor), written down
    from the path before the first run on the card.  Per chunk (length ln,
    lloc = ln / sp rows a rank, its cache view kv = (off + ln) / sp slots):
    the embedding's reduce-scatter of [B, ln, d] and its backward's gather
    of [B, lloc, d]; per layer, in each forward pass of the stack (2 under
    remat "sppo" / "full": the seam's and its replay), the "ag" weights'
    shards gathered and, under gather_q, the queries [B, lloc, H, hd] and
    their int32 positions gathered, the fp32 max [B, ln, H] max-reduced,
    o [B, ln, H, hd] (fp32, bf16 under merge_bf16) and l [B, ln, H]
    reduce-scattered, under gather_kv the cache view's k and v [B, kv, Hkv,
    hd] and its positions gathered; per layer in the backward the weights'
    full gradients reduce-scattered (bf16 under grad_compress, else the
    weights' dtype) and, under gather_q, o's and l's cotangents [B, lloc,
    ...] gathered and the queries' [B, ln, H, hd] reduce-scattered, under
    gather_kv dk and dv [B, sp kv, Hkv, hd] fp32 reduce-scattered; under
    the ring (``model_ppermute``) sp - 1 hops of the cache view's k, v and
    int32 positions in each forward pass (``costmodel.ring_hop_bytes`` of
    kv slots, which prices bf16 rows: the cell's dtype scales them) and sp -
    1 hops of dk, dv (the rows without the positions) in the backward, no
    gather, max or reduce-scatter of the attention; the loss
    gathers x [B, lloc, d], max-reduces [B, ln] fp32, sums l and the picked
    logit [B, ln] fp32 twice, and reduce-scatters x's gradient [B, ln, d].
    Once a step the replicated leaves' gradients are summed over the model
    group (``model_reduce``), with the global norm's two fp32 partial sums
    where ``with_norm``."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import tree
    from repro_torch.models.model_zoo import build_model, marker_dim, param_markers

    cfg, plan = cell.cfg, cell.plan
    sp, B = plan.sp, cell.b_loc
    e = torch.tensor([], dtype=cell.dtype).element_size()
    d, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    mdef = build_model(cfg)
    shapes = {"stages": mdef.init_stage_params(torch.Generator(), cell.dtype, "meta")[:1],
              "globals": mdef.init_globals(torch.Generator(), cell.dtype, "meta")}
    marks = param_markers(mdef, shapes)
    ag = [t for t, m in zip(tree.leaves(shapes["stages"]), tree.leaves(marks["stages"]))
          if isinstance(m, int)]
    grad_e = 2 if plan.grad_compress else e

    def rep_bytes(part):
        return sum(t.numel() * e for (path, t), m in zip(tree.items(shapes[part]),
                                                         tree.leaves(marks[part]))
                   if marker_dim(m) is None and not path.endswith("gate"))

    rep = cfg.n_layers * rep_bytes("stages") + rep_bytes("globals")
    passes = 2 if plan.remat in ("sppo", "full") else 1
    o_e = 2 if plan.merge_bf16 else 4
    out = {k: [0, 0] for k in ("model_all_gather", "model_reduce_scatter", "model_psum",
                               "model_pmax", "model_ppermute")}

    def add(kind, calls, nbytes):
        out[kind][0] += calls
        out[kind][1] += int(calls * nbytes)

    gq, ring = plan.attn_mode == "gather_q", plan.attn_mode == "ring"
    for off, ln in zip(cell.sched.offsets, cell.sched.lengths):
        lloc, kv = ln // sp, (off + ln) // sp
        kv_rows = (cm.ring_hop_bytes(cfg, kv, B) - 4 * kv) * e // cm.ACT_ITEMSIZE
        add("model_reduce_scatter", 1, B * ln * d * e)
        add("model_all_gather", 1, B * lloc * d * e)
        for _ in range(cfg.n_layers):
            for _ in range(passes):
                for t in ag:
                    add("model_all_gather", 1, t.numel() * e / sp)
                if ring:
                    add("model_ppermute", sp - 1, kv_rows + 4 * kv)
                elif gq:
                    add("model_all_gather", 1, B * lloc * H * hd * e)
                    add("model_all_gather", 1, 4 * lloc)
                    if cell.varlen:
                        add("model_all_gather", 1, 4 * B * lloc)
                    add("model_pmax", 1, 4 * B * ln * H)
                    add("model_reduce_scatter", 1, o_e * B * ln * H * hd)
                    add("model_reduce_scatter", 1, 4 * B * ln * H)
                else:
                    add("model_all_gather", 2, B * kv * Hkv * hd * e)
                    add("model_all_gather", 1, 4 * kv)
            for t in ag:
                add("model_reduce_scatter", 1, t.numel() * grad_e)
            if ring:
                add("model_ppermute", sp - 1, kv_rows)
            elif gq:
                add("model_all_gather", 1, o_e * B * lloc * H * hd)
                add("model_all_gather", 1, 4 * B * lloc * H)
                add("model_reduce_scatter", 1, B * ln * H * hd * e)
            else:
                add("model_reduce_scatter", 2, 4 * B * sp * kv * Hkv * hd)
        add("model_all_gather", 1, B * lloc * d * e)
        add("model_pmax", 1, 4 * B * ln)
        add("model_psum", 2, 4 * B * ln)
        add("model_reduce_scatter", 1, B * ln * d * e)
    cf = {k: tuple(v) for k, v in out.items()}
    cf["model_reduce"] = (None, rep + (8 if with_norm else 0))
    return cf


def model_axis_d2h_bytes(cell) -> int:
    """A rank's row copies a step at pp = 1 by the closed form: Σ over
    chunks of split_rows(ln / sp, α) x its rows x the tagged elements of a
    token in every layer x their wire bytes (the cell's dtype, 1 byte under
    an fp8 / int8 codec)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import offload as ofl

    wire = (1 if cell.plan.offload_dtype != "none"
            else torch.tensor([], dtype=cell.dtype).element_size())
    per_row = (cell.b_loc * cm.tagged_bytes_per_token(cell.cfg) // cm.ACT_ITEMSIZE
               * cell.cfg.n_layers * wire)
    return int(sum(ofl.split_rows(ln // cell.plan.sp, a) * per_row
                   for ln, a in zip(cell.sched.lengths, cell.alphas)))


def model_axis_launches(fa, cell, seams, device) -> dict:
    """The kernels' launches of one rank's step by the closed form: per
    seam (chunk at pp = 1, event at pp > 1: (chunk length, offset)) and
    layer of the rank, the forward twice (its replay) with its KV splits
    merged (in the launch on the tensor cores, by the merge kernel on the
    CUDA cores) wherever the kernel's geometry splits the mode's shape
    (gather_q: the chunk's queries over the rank's cache view; gather_kv:
    its rows over every rank's; the ring: its rows over one rank's view, sp
    hops), dq and dk/dv once (the ring: once a hop)."""
    sp, B, cfg = cell.plan.sp, cell.b_loc, cell.cfg
    G, Hkv = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    tc = cell.dtype == torch.bfloat16
    geometry = fa._tc_geometry if tc else fa._geometry
    spp = -(-cfg.n_layers // cell.plan.pp)
    mode = cell.plan.attn_mode
    hops = sp if mode == "ring" else 1
    splits = 0
    for ln, off in seams:
        kv = (off + ln) // sp
        tq, s_kv = {"gather_q": (ln, kv), "ring": (ln // sp, kv)}.get(mode, (ln // sp, sp * kv))
        splits += geometry(B, tq, s_kv, G, Hkv, n_sm)[2] > 1
    n = len(seams) * spp * hops
    keys = (("fwd_tc", "merged_in_kernel", "bwd_dq_tc", "bwd_dkv_tc") if tc
            else ("fwd", "merge", "bwd_dq", "bwd_dkv"))
    return dict(zip(keys, (2 * n, 2 * splits * spp * hops, n, n)))


def sp_rank(rank, device, fp32_layouts, params_np, batches):
    """One rank of the full-width model-axis cell (``model_axis_phase``).
    Rank 0 first runs sp = 1 with the same weights (one untimed
    loss-and-gradients call) while the other builds its shards.  Under each
    of SP_GRADS_MODES each rank then takes one untimed
    loss-and-gradients call on fresh weights and sends rank 0 its gradient
    shards (rank 0 gathers them to full leaves and holds them against sp =
    1's).  Per mode, each rank trains SP_STEPS steps through
    ``launch.train.train``, counting each step's launches, row copies and
    collectives.  Last, the reduced fp32 ``fp32_layouts`` of
    this many ranks (``_sp_fp32_layout``)."""
    _port_path()
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.launch import train as train_mod
    from repro_torch.models.convert import gather_model_shards
    from repro_torch.parallel import runner
    from repro_torch.parallel.ctx import Ctx
    from repro_torch.runtime import hostmem

    t_up = time.time()
    logging.basicConfig(level=logging.WARNING, format="%(asctime)s %(name)s %(message)s")
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=SP_LAYERS)
    shape = ShapeConfig("model_axis", SP_SEQ, 1, "train")
    tokens, labels = (torch.from_numpy(a).to(device) for a in
                      SyntheticLM(cfg.vocab_size, SP_SEQ, 1).sample_step(0))
    out = {"rank": rank, "t_up": t_up}

    def peak_reset():
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        return torch.cuda.memory_allocated(device)

    ref = {}
    if rank == 0:
        cell1 = runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, n_chunks=SP_CHUNKS))
        params = serve.build_params(cell1, device, seed=0)
        t0 = time.perf_counter()
        loss1, grads1 = runner.loss_and_grads(cell1, params, tokens, labels)
        torch.cuda.synchronize(device)
        out["sp1"] = {"loss": float(loss1), "grads_call_s": time.perf_counter() - t0,
                      "chunks": list(cell1.sched.lengths)}
        ref = {path: g.cpu() for path, g in tree.items(grads1)}
        del params, grads1
        torch.cuda.empty_cache()
    for label, mode_ov in SP_MODES.items():
        ov = dict(mode_ov, sp=SP)
        cell = runner.resolve_cell(cfg, shape, overrides=dict(ov, pp=1, dp=1, n_chunks=SP_CHUNKS),
                                   data_size=1, model_size=SP)
        ctx = cell.ctx(device=device)
        cmp = grads_s = grads_counts = grads_peak = loss0 = None
        if label in SP_GRADS_MODES:
            # the mode's step-0 loss and gradients in one untimed call on
            # fresh weights (the first mode's built while rank 0 runs sp =
            # 1; the barrier then starts the ranks' calls together)
            params = serve.build_params(cell, device, seed=0, model_rank=ctx.model_index())
            dist.barrier()
            base = peak_reset()
            fa.reset_counts()
            ctx.reset_counts()
            t0 = time.perf_counter()
            loss0, grads = runner.loss_and_grads(cell, params, tokens, labels, ctx=ctx)
            torch.cuda.synchronize(device)
            grads_s = time.perf_counter() - t0
            grads_counts = {**fa.counts(), **{"ctx_" + k: v for k, v in ctx.counts().items()}}
            grads_peak = torch.cuda.max_memory_allocated(device) - base
            loss0 = float(loss0)
            mine = tree.map_(lambda t: t.cpu(), grads)
            del params, grads
            torch.cuda.empty_cache()
            if rank == 0:
                shards = [mine]
                for r in range(1, SP):
                    other = tree.map_(lambda t: torch.empty(t.shape, dtype=t.dtype), mine)
                    for t in tree.leaves(other):
                        dist.recv(t, src=r)
                    shards.append(other)
                full = gather_model_shards(shards, cfg)
                cmp = {"bitwise": 0, "differ": []}
                worst = 0.0
                for path, g in tree.items(full):
                    want = ref[path]
                    rel = ((g.float() - want.float()).norm()
                           / want.float().norm().clamp_min(1e-30)).item()
                    worst = max(worst, rel)
                    if torch.equal(g, want):
                        cmp["bitwise"] += 1
                    else:
                        cmp["differ"].append((path, rel))
                cmp["differ"].sort(key=lambda x: -x[1])
                cmp["worst_rel_l2"] = worst
                del full, shards
            else:
                for t in tree.leaves(mine):
                    dist.send(t.contiguous(), dst=0)
            del mine
        dist.barrier()
        # the train entry point, each step's launches, copies and collectives
        after = []

        def on_step(step, rec):
            after.append({**fa.counts(), **{"copy_" + k: v for k, v in hostmem.counts().items()},
                          **{"ctx_" + k: v for k, v in ctx.counts().items()}})

        fa.reset_counts()
        hostmem.reset_counts()
        ctx.reset_counts()
        res = train_mod.train(cfg, steps=SP_STEPS, seq=SP_SEQ, batch=1, n_chunks=SP_CHUNKS,
                              log_every=SP_STEPS, device=device, overrides=ov,
                              on_step=on_step, ctx=ctx)
        per_step = [{k: a[k] - b.get(k, 0) for k in a} for a, b in zip(after, [{}] + after[:-1])]
        rcell = res["cell"]
        seams = list(zip(rcell.sched.lengths, rcell.sched.offsets))
        out[label] = {
            "loss0_grads_call": loss0, "grads_vs_sp1": cmp, "grads_call_s": grads_s,
            "grads_call_peak_over_weights": grads_peak, "grads_call_counts": grads_counts,
            "losses": [r["loss"] for r in res["history"]],
            "step_s": [r["dt"] for r in res["history"]],
            "tokens_per_s_per_gpu": [r["tgs"] for r in res["history"]],
            "peak_bytes": res["peak_bytes"], "base_bytes": res["base_bytes"],
            "alphas": list(rcell.alphas), "chunks": list(rcell.sched.lengths),
            "closed_form": model_axis_closed_form(rcell, with_norm=True),
            "closed_form_grads_call": model_axis_closed_form(rcell, with_norm=False),
            "closed_form_d2h_bytes": model_axis_d2h_bytes(rcell),
            "launch_want": model_axis_launches(fa, rcell, seams, device),
            "per_step": per_step}
        del res
        torch.cuda.empty_cache()
    out["t_full_done"] = time.time()
    out["fp32"] = {name: _sp_fp32_layout(rank, device, layout, params_np, batches[name])
                   for name, layout in fp32_layouts.items()}
    out["t_done"] = time.time()
    return out


def sp_fp32_rank(rank, device, layouts, params_np, batches):
    """One rank of each reduced fp32 layout of ``layouts`` (all of this
    many ranks), in turn, with its start and end times."""
    t_up = time.time()
    out = {name: _sp_fp32_layout(rank, device, layout, params_np, batches[name])
           for name, layout in layouts.items()}
    return {"layouts": out, "t_up": t_up, "t_done": time.time()}


def _sp_fp32_layout(rank, device, layout, params_np, batch):
    """One rank of a reduced fp32 model-axis layout: the loss and its shard
    of every gradient under the default plan (with the layout's plan
    overrides and α), through the CUDA-core kernels, with its launches,
    copies and collectives and their closed forms; where the layout asks
    (``update``), one training step after it (ZeRO-1 at pods > 1): the
    rank's parameters, its moments' host bytes beside their closed form
    over its slices, and its pod gathers."""
    _port_path()
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.parallel import runner
    from repro_torch.runtime import hostmem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config_reduced()
    tokens, labels, doc_start, doc_lens = batch
    B, seq = tokens.shape
    sp, pp, dp, pods = layout["sp"], layout["pp"], layout["dp"], layout.get("pods", 1)
    cell = runner.resolve_cell(
        cfg, ShapeConfig("model_axis_fp32", seq, B, "train"),
        overrides=dict(pp=pp, dp=dp, sp=sp, n_chunks=layout["n_chunks"],
                       msp=layout.get("msp", False), grad_accum=1, **layout.get("plan", {})),
        dtype=torch.float32, data_size=dp * pp, model_size=sp, doc_lens=doc_lens, pods=pods)
    if "alphas" in layout:
        cell = dataclasses.replace(cell, alphas=tuple(layout["alphas"]))
    ctx = cell.ctx(device=device)
    stage, g, m = ctx.stage_index(), ctx.dp_index(), ctx.model_index()
    params = params_from_numpy(params_np, dtype=torch.float32, device=device, stage=stage,
                               pp=pp, cfg=cfg, sp=sp, model_rank=m)
    tok, lab, *ds = (torch.from_numpy(a).to(device) for a in cell.rows(
        ctx, tokens, labels, *(() if doc_start is None else (doc_start,))))
    ds = ds[0] if ds else None
    fa.reset_counts()
    hostmem.reset_counts()
    ctx.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, tok, lab, ds, ctx=ctx)
    launched, copied = fa.counts(), hostmem.counts()
    if pp > 1:
        from repro_torch.parallel.runner import pipeline_feed_events

        clen = seq // cell.sched.n
        seams = [(clen, c * clen) for c, _, _ in pipeline_feed_events(cell.plan, cell.sched.n)]
    else:
        seams = list(zip(cell.sched.lengths, cell.sched.offsets))
    want = {**{k: 0 for k in launched}, **model_axis_launches(fa, cell, seams, device)}
    out = {"rank": rank, "stage": stage, "dp_index": g, "model_index": m,
           "pod_index": ctx.pod_index(), "loss": float(loss),
           "grads": tree.map_(lambda t: t.cpu().numpy(), grads), "launched": launched,
           "launch_want": want, "copied": copied, "alphas": list(cell.alphas),
           "ctx_counts": ctx.counts(), "seams": len(seams)}
    if pp == 1:
        out["closed_form"] = model_axis_closed_form(cell, with_norm=False)
        out["closed_form_d2h_bytes"] = model_axis_d2h_bytes(cell)
    if layout.get("update"):
        from repro_torch.core import costmodel as cm

        del grads
        step = runner.make_train_step(cell, lr_kwargs=SP_FP32_LR, ctx=ctx)
        state = runner.init_opt_state(cell, params, ctx)
        slices = runner.pod_slices(cell, params, ctx)
        shapes = [tuple(slices.of(i, t).shape) for i, t in enumerate(tree.leaves(params))]
        ctx.reset_counts()
        params, state, _ = step(params, state, tok, lab, ds)
        gathers = (ctx.counts()["pod_all_gather_calls"], ctx.counts()["pod_all_gather_bytes"])
        # the same update without ZeRO-1 (whole moments on every pod)
        plain = dataclasses.replace(cell, plan=dataclasses.replace(cell.plan, zero1=False))
        p2 = params_from_numpy(params_np, dtype=torch.float32, device=device, stage=stage,
                               pp=pp, cfg=cfg, sp=sp, model_rank=m)
        s2 = runner.init_opt_state(plain, p2, ctx)
        p2, s2, _ = runner.make_train_step(plain, lr_kwargs=SP_FP32_LR, ctx=ctx)(
            p2, s2, tok, lab, ds)
        bitwise = all(torch.equal(a, b) for a, b in zip(tree.leaves(params), tree.leaves(p2)))
        for i, (a, b) in enumerate(zip(tree.leaves([state.m, state.v]),
                                       tree.leaves([s2.m, s2.v]))):
            bitwise &= torch.equal(a, slices.of(i % len(shapes), b))
        out["update"] = {
            "params": tree.map_(lambda t: t.cpu().numpy(), params),
            "bitwise_zero1_false": bitwise,
            "moments_in_pinned_host_memory": bool(
                state.host is not None and state.host.tensor.is_pinned()
                and all(t.device.type == "cpu" for t in tree.leaves([state.m, state.v]))),
            "moment_bytes": sum(t.numel() * t.element_size()
                                for t in tree.leaves([state.m, state.v])),
            "closed_form": cm.moment_bytes_from_shapes(shapes),
            "whole_moment_bytes": cm.moment_bytes_from_shapes(
                [tuple(t.shape) for t in tree.leaves(params)]),
            "pod_all_gather": gathers,
            "pod_all_gather_closed_form": (1, 4 * sum(
                math.prod(sh) for sh, d in zip(shapes, slices.dims) if d is not None))}
    return out


def _sp_fp32_batches(vocab):
    """Each fp32 layout's batch: (tokens, labels, doc_start, doc_lens) as
    numpy; the packed layout's rows are FP32_PACKED_CORPUS in 4 rows."""
    from repro_torch.data import pipeline as dpipe
    from repro_torch.data.pipeline import SyntheticLM

    tokens, labels = SyntheticLM(vocab, SP_FP32_SEQ, SP_FP32_BATCH).sample_step(0)
    docs = dpipe.sample_corpus(vocab_size=vocab, **FP32_PACKED_CORPUS)
    pb = dpipe.pack_documents(docs, SP_FP32_SEQ, rows=4)
    packed = (pb.tokens, pb.labels, pb.doc_start, doc_lengths(pb))
    return {name: packed if lay.get("packed") else (tokens, labels, None, None)
            for name, lay in SP_FP32_LAYOUTS.items()}


def model_axis_phase(fa, mesh, runner, card):
    """SPPO's model axis (DESIGN.md §4) with its ranks as processes sharing
    the one card over gloo: the full-width cell (``sp_rank``) and after it
    the reduced fp32 layouts of as many ranks, while a spawn of its own
    runs the four-rank fp32 layouts beside them; every fp32 layout is held
    against the CPU's sp = 1 step under the same plan (a codec layout's
    gradients by the codec law against its raw twin).  Every time it prints
    is marked SP_SHARED.  Returns (the counts of the kernels' launches by
    path, a summary)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.models.convert import gather_model_shards
    from repro_torch.models.model_zoo import build_model

    gib = 2**30
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = get_config_reduced()
    mdef = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = {"stages": mdef.init_stage_params(gen, torch.float32, "cpu"),
              "globals": mdef.init_globals(gen, torch.float32, "cpu")}
    params_np = {"stages": _stack_numpy(params["stages"]),
                 "globals": tree_map(lambda t: t.numpy(), params["globals"])}
    batches = _sp_fp32_batches(cfg.vocab_size)
    # the CPU's sp = 1 step of each layout's batch, under the layout's plan
    cpu = {}
    for name, lay in SP_FP32_LAYOUTS.items():
        tokens, labels, doc_start, doc_lens = batches[name]
        c1 = runner.resolve_cell(cfg, ShapeConfig("model_axis_fp32", SP_FP32_SEQ,
                                                  tokens.shape[0], "train"),
                                 overrides=dict(pp=1, dp=1, n_chunks=2, grad_accum=1,
                                                **lay.get("plan", {})),
                                 dtype=torch.float32, doc_lens=doc_lens)
        if "alphas" in lay:
            c1 = dataclasses.replace(c1, alphas=tuple(lay["alphas"]))
        l1, g1 = runner.loss_and_grads(c1, params, torch.from_numpy(tokens),
                                       torch.from_numpy(labels),
                                       None if doc_start is None else torch.from_numpy(doc_start))
        cpu[name] = (float(l1), {p: t.numpy() for p, t in tree.items(g1)})
        if lay.get("update"):
            # the CPU's sp = 1 update of the same plan, on a copy of the weights
            p1 = tree_map(lambda t: t.clone(), params)
            p1, _, _ = runner.make_train_step(c1, lr_kwargs=SP_FP32_LR)(
                p1, runner.init_opt_state(c1, p1), torch.from_numpy(tokens),
                torch.from_numpy(labels))
            cpu[name] += ({p: t.numpy() for p, t in tree.items(p1)},)
    by_world = {}
    for name, lay in SP_FP32_LAYOUTS.items():
        world = lay.get("pods", 1) * lay["dp"] * lay["pp"] * lay["sp"]
        by_world.setdefault(world, {})[name] = lay
    check(set(by_world) <= {SP, 4}, f"fp32 layouts of {sorted(by_world)} ranks")
    others = {}

    def spawn_others():
        try:
            for world, layouts in by_world.items():
                if world != SP:
                    others[world] = mesh.spawn(sp_fp32_rank, world, backend=PIPE_BACKEND,
                                               device="cuda",
                                               args=(layouts, params_np, batches),
                                               timeout_s=PIPE_DEADLINE_S)
        except BaseException as err:  # noqa: BLE001 -- raised again after the join
            others["error"] = err
        others["t_end"] = time.time()

    t_wall = time.time()
    side = threading.Thread(target=spawn_others, daemon=True)
    side.start()
    ranks = mesh.spawn(sp_rank, SP, backend=PIPE_BACKEND, device="cuda",
                       args=(by_world.get(SP, {}), params_np, batches),
                       timeout_s=PIPE_DEADLINE_S)
    t_full = time.perf_counter() - t0
    t_full_end = time.time()
    side.join()
    if "error" in others:
        raise others["error"]
    print(f"model-axis spawns (s after the {SP}-rank spawn began; {SP_SHARED}): its ranks up at "
          f"{[round(r['t_up'] - t_wall, 1) for r in ranks]}, full-width cell done at "
          f"{[round(r['t_full_done'] - t_wall, 1) for r in ranks]}, done at "
          f"{[round(r['t_done'] - t_wall, 1) for r in ranks]}, spawn returned at "
          f"{t_full_end - t_wall:.1f}; " + "; ".join(
              f"the {w}-rank spawn beside it: up at {[round(r['t_up'] - t_wall, 1) for r in got]}, "
              f"done at {[round(r['t_done'] - t_wall, 1) for r in got]}, returned at "
              f"{others['t_end'] - t_wall:.1f}" for w, got in others.items() if isinstance(w, int)))
    sp1 = ranks[0]["sp1"]
    print(f"model axis [{card}] qwen2-7b {SP_LAYERS} layers at full width, B = 1, S = {SP_SEQ} in "
          f"chunks {sp1['chunks']}, sp = {SP} as {SP} ranks on one card over {PIPE_BACKEND} (every "
          f"collective staged through pinned host memory), the default plan; sp = 1 (rank 0 "
          f"alone, same weights): grads-call loss {sp1['loss']!r} in {sp1['grads_call_s']:.2f} s")
    counts, summary = {}, {"sp1": sp1, "full_width_seconds": t_full}
    kinds = ("model_all_gather", "model_reduce_scatter", "model_psum", "model_pmax",
             "model_ppermute")
    for label in SP_MODES:
        rows = [r[label] for r in ranks]
        tot = {k: sum(r["per_step"][-1].get(k, 0) for r in rows) for k in rows[0]["per_step"][-1]
               if not k.startswith(("copy_", "ctx_"))}
        counts[label] = {k: sum(sum(s.get(k, 0) for s in r["per_step"]) for r in rows)
                         for k in tot}
        cmp = rows[0]["grads_vs_sp1"]
        loss0 = rows[0]["loss0_grads_call"]
        if cmp is not None:
            check(abs(loss0 - sp1["loss"]) <= SP_LOSS_TOL * abs(sp1["loss"]),
                  f"model axis [{label}] step-0 loss {loss0} vs sp = 1's {sp1['loss']} (tol "
                  f"{SP_LOSS_TOL} relative)")
            check(cmp["worst_rel_l2"] <= GRAD_PLAN_TOL,
                  f"model axis [{label}] step-0 gradients differ from sp = 1's by "
                  f"{cmp['worst_rel_l2']:.3e} relative L2 at the worst leaf (tol {GRAD_PLAN_TOL})")
        for r, row in zip(ranks, rows):
            cf = row["closed_form"]
            gc = row["grads_call_counts"]
            for kind in kinds if gc is not None else ():
                calls, nbytes = row["closed_form_grads_call"][kind]
                check(gc[f"ctx_{kind}_calls"] == calls and gc[f"ctx_{kind}_bytes"] == nbytes,
                      f"model axis [{label}] rank {r['rank']} grads call: {kind} "
                      f"{gc[f'ctx_{kind}_calls']} calls, {gc[f'ctx_{kind}_bytes']} bytes; closed "
                      f"form {calls}, {nbytes}")
            for step, c in enumerate(row["per_step"]):
                want = row["launch_want"]
                check(all(c[k] == v for k, v in want.items())
                      and c["fwd"] == c["merge"] == c["bwd_dq"] == c["bwd_dkv"] == 0,
                      f"model axis [{label}] rank {r['rank']} step {step} launched "
                      f"{ {k: v for k, v in c.items() if not k.startswith(('copy_', 'ctx_'))} }; "
                      f"expected {want}, no CUDA-core launch")
                check(c["copy_d2h_bytes"] == c["copy_h2d_bytes"] == row["closed_form_d2h_bytes"]
                      and c["copy_d2h_pinned"] == c["copy_d2h"] == c["copy_h2d"],
                      f"model axis [{label}] rank {r['rank']} step {step} copied "
                      f"{c['copy_d2h_bytes']} / {c['copy_h2d_bytes']} bytes; closed form "
                      f"{row['closed_form_d2h_bytes']}, every host buffer pinned")
                for kind in kinds:
                    calls, nbytes = cf[kind]
                    check(c[f"ctx_{kind}_calls"] == calls and c[f"ctx_{kind}_bytes"] == nbytes,
                          f"model axis [{label}] rank {r['rank']} step {step}: {kind} "
                          f"{c[f'ctx_{kind}_calls']} calls, {c[f'ctx_{kind}_bytes']} bytes; "
                          f"closed form {calls}, {nbytes}")
                check(c["ctx_model_reduce_bytes"] == cf["model_reduce"][1],
                      f"model axis [{label}] rank {r['rank']} step {step}: replicated leaves' "
                      f"gradients {c['ctx_model_reduce_bytes']} bytes; closed form "
                      f"{cf['model_reduce'][1]}")
            losses = row["losses"]
            check(len(losses) == SP_STEPS and all(np.isfinite(losses)) and losses == rows[0]["losses"],
                  f"model axis [{label}] rank {r['rank']} losses {losses} (rank 0 "
                  f"{rows[0]['losses']})")
            check(abs(losses[0] - sp1["loss"]) <= SP_LOSS_TOL * abs(sp1["loss"]),
                  f"model axis [{label}] train step-0 loss {losses[0]} vs sp = 1's {sp1['loss']}")
            last = row["per_step"][-1]
            ms = [1e3 * x for x in row["step_s"]]
            print(f"model axis [{label}] rank {r['rank']}: losses {losses}; step ms "
                  f"{[round(x, 1) for x in ms]} ({SP_SHARED}); peak "
                  f"{row['peak_bytes'] / gib:.2f} GiB (base {row['base_bytes'] / gib:.2f}); "
                  + ("" if row["grads_call_s"] is None else
                     f"grads call {row['grads_call_s']:.2f} s, peak "
                     f"{row['grads_call_peak_over_weights'] / gib:.2f} GiB over the weights; ")
                  + "; ".join(f"{kind[6:]} {last[f'ctx_{kind}_calls']} calls {last[f'ctx_{kind}_bytes']} "
                              f"bytes (closed form {cf[kind][1]}) {1e3 * last[f'ctx_{kind}_s']:.1f} ms"
                              for kind in kinds)
                  + f"; replicated grads {last['ctx_model_reduce_bytes']} bytes "
                  f"{1e3 * last['ctx_model_reduce_s']:.1f} ms ({SP_SHARED}); row copies "
                  f"{last['copy_d2h_bytes']} bytes each way (closed form "
                  f"{row['closed_form_d2h_bytes']}, α {[round(a, 4) for a in row['alphas']]}); "
                  f"launches a step { {k: last[k] for k in row['launch_want']} }")
        train0 = rows[0]["losses"][0]
        print(f"model axis [{label}] step-0 loss: sp = 1 {sp1['loss']!r}, sp = {SP} train step 0 "
              f"{train0!r} ({(train0 - sp1['loss']) / sp1['loss']:+.3e} relative)"
              + ("" if cmp is None else
                 f", grads call {loss0!r}; gradients gathered to full vs sp = 1: "
                 f"{cmp['bitwise']} leaves bitwise, {len(cmp['differ'])} differ, worst relative "
                 f"L2 {cmp['worst_rel_l2']:.3e} {cmp['differ'][:4]}"))
        summary[label] = [{k: v for k, v in row.items() if k != "per_step"} for row in rows]
    # the reduced fp32 layouts, each against the CPU's sp = 1 step
    fp32 = {name: [r["fp32"][name] for r in ranks] for name in by_world.get(SP, {})}
    for world, got in others.items():
        if isinstance(world, int):
            fp32.update({name: [r["layouts"][name] for r in got] for name in by_world[world]})
    summary["fp32"] = {"side_spawn_seconds": others["t_end"] - t_wall}
    for name, lay in SP_FP32_LAYOUTS.items():
        franks = fp32[name]
        cpu_loss, cpu_grads = cpu[name][:2]
        worst, loss_rel = 0.0, 0.0
        spp = -(-cfg.n_layers // lay["pp"])
        by = {}
        for r in franks:
            loss_rel = max(loss_rel, abs(r["loss"] - cpu_loss) / abs(cpu_loss))
            by.setdefault((r["pod_index"], r["dp_index"], r["stage"]), []).append(r)
            check(r["launched"] == r["launch_want"],
                  f"model-axis fp32 [{name}] rank {r['rank']} launched {r['launched']}, expected "
                  f"{r['launch_want']}")
            c = r["copied"]
            check(c["d2h_bytes"] == c["h2d_bytes"] and c["d2h_pinned"] == c["d2h"]
                  and ("closed_form_d2h_bytes" not in r
                       or c["d2h_bytes"] == r["closed_form_d2h_bytes"]),
                  f"model-axis fp32 [{name}] rank {r['rank']} copied {c}; closed form "
                  f"{r.get('closed_form_d2h_bytes')} bytes each way, pinned")
            for kind, (calls, nbytes) in r.get("closed_form", {}).items():
                if calls is not None:
                    check(r["ctx_counts"][f"{kind}_calls"] == calls
                          and r["ctx_counts"][f"{kind}_bytes"] == nbytes,
                          f"model-axis fp32 [{name}] rank {r['rank']}: {kind} "
                          f"{r['ctx_counts'][f'{kind}_calls']} calls "
                          f"{r['ctx_counts'][f'{kind}_bytes']} bytes; closed form {calls}, {nbytes}")
        for (_, g, stage), rs in by.items():
            full = gather_model_shards([r["grads"] for r in sorted(rs, key=lambda x: x["model_index"])],
                                       cfg)
            for path, got in tree.items(full):
                kind, rest = path.split("/", 1)
                if kind == "stages":
                    i, leaf = rest.split("/", 1)
                    j = stage * spp + int(i)
                    if j >= cfg.n_layers:
                        check(not np.any(got), f"model-axis fp32 [{name}] ghost slot gradient")
                        continue
                    want = cpu_grads[f"stages/{j}/{leaf}"]
                else:
                    want = cpu_grads[path]
                norm = np.linalg.norm(want)
                if norm == 0:
                    check(not np.any(got), f"model-axis fp32 [{name}] {path}: expected zeros")
                    continue
                worst = max(worst, float(np.linalg.norm(got - want) / norm))
        drift = None
        if "drift_of" in lay:
            codec = lay["plan"]["offload_dtype"]

            def flat(rs):
                return (rs[0]["loss"], np.concatenate([
                    np.asarray(a, np.float64).ravel()
                    for r in sorted(rs, key=lambda x: x["rank"]) for a in tree.leaves(r["grads"])]))

            (lc, gc), (lr, gr) = flat(franks), flat(fp32[lay["drift_of"]])
            drift = (abs(lc - lr) / abs(lr), float(np.linalg.norm(gc - gr) / np.linalg.norm(gr)))
            check(loss_rel <= GRAD_REL_TOL and drift[0] <= CODEC_LOSS_TOL
                  and 1e-7 < drift[1] <= CODEC_GRAD_TOL[codec],
                  f"model-axis fp32 [{name}]: loss {loss_rel:.3e} from the CPU's (tol "
                  f"{GRAD_REL_TOL}); against [{lay['drift_of']}] loss drift {drift[0]:.3e} (tol "
                  f"{CODEC_LOSS_TOL}), gradient drift {drift[1]:.3e} (in (1e-7, "
                  f"{CODEC_GRAD_TOL[codec]}], the reference's codec law)")
        else:
            check(loss_rel <= GRAD_REL_TOL and worst <= GRAD_REL_TOL,
                  f"model-axis fp32 [{name}] vs the CPU's sp = 1 step: loss {loss_rel:.3e}, "
                  f"worst gradient relative L2 {worst:.3e} (tol {GRAD_REL_TOL})")
        update = None
        if lay.get("update"):
            # one update (ZeRO-1 over the pods): bitwise the same layout's
            # update without ZeRO-1 on every rank, and every pod's
            # parameters, gathered over its model ranks, against the CPU's
            # sp = 1 update.  The key bias is left out of that comparison: a
            # key bias shifts every score of a query alike, so its exact
            # gradient is zero, and AdamW's first step, g / (|g| + eps),
            # turns the rounding noise there into an update of any sign
            worst_p, worst_leaf = 0.0, None
            for pod in range(lay.get("pods", 1)):
                rs = sorted((r for r in franks if r["pod_index"] == pod),
                            key=lambda x: x["model_index"])
                full = gather_model_shards([r["update"]["params"] for r in rs], cfg)
                for path, got in tree.items(full):
                    if path.endswith("attn/bk"):
                        continue
                    want = cpu[name][2][path]
                    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
                    if rel > worst_p:
                        worst_p, worst_leaf = rel, path
            for r in franks:
                u = r["update"]
                check(u["bitwise_zero1_false"],
                      f"model-axis fp32 [{name}] rank {r['rank']}: the ZeRO-1 update's "
                      "parameters and moments are not the bits of the update without it")
                check(u["moments_in_pinned_host_memory"]
                      and u["moment_bytes"] == u["closed_form"] < u["whole_moment_bytes"]
                      and tuple(u["pod_all_gather"]) == u["pod_all_gather_closed_form"],
                      f"model-axis fp32 [{name}] rank {r['rank']} update: moments pinned on the "
                      f"host {u['moments_in_pinned_host_memory']}, {u['moment_bytes']} bytes "
                      f"(closed form over its ZeRO-1 slices {u['closed_form']}, whole "
                      f"{u['whole_moment_bytes']}); pod gathers {u['pod_all_gather']} (closed "
                      f"form {u['pod_all_gather_closed_form']})")
            check(worst_p <= GRAD_REL_TOL,
                  f"model-axis fp32 [{name}] parameters after one update differ from the CPU's "
                  f"sp = 1 update by {worst_p:.3e} relative L2 at {worst_leaf} (tol "
                  f"{GRAD_REL_TOL})")
            update = {"worst_param_rel_l2": worst_p,
                      "moment_bytes": [r["update"]["moment_bytes"] for r in franks],
                      "whole_moment_bytes": franks[0]["update"]["whole_moment_bytes"],
                      "pod_all_gather": [r["update"]["pod_all_gather"] for r in franks]}
            print(f"model-axis fp32 [{name}] one update with ZeRO-1 over {lay['pods']} pods, "
                  f"moments in pinned host memory: bitwise the update without ZeRO-1 on every "
                  f"rank; parameters {worst_p:.3e} from the CPU's sp = 1 update (relative L2, "
                  f"worst leaf {worst_leaf}, the key bias aside); host moment bytes a rank "
                  f"{update['moment_bytes']} (the closed form over its slices; whole moments "
                  f"{update['whole_moment_bytes']}); pod gathers (calls, bytes) "
                  f"{update['pod_all_gather']}")
        lc = {k: sum(r["launched"][k] for r in franks) for k in franks[0]["launched"]}
        counts[f"fp32_{name}"] = lc
        summary["fp32"][name] = {"loss_rel": loss_rel, "worst_grad_rel_l2": worst, "launches": lc,
                                 "drift": drift, "update": update,
                                 "alphas": franks[0]["alphas"],
                                 "d2h_bytes": [r["copied"]["d2h_bytes"] for r in franks]}
        print(f"model-axis fp32 [{name}] {lay} on one card over {PIPE_BACKEND}: loss "
              f"{franks[0]['loss']:.6f} vs the CPU's sp = 1 step {cpu_loss:.6f} (relative "
              f"{loss_rel:.3e}), "
              + ("" if drift is None else
                 f"against [{lay['drift_of']}] loss drift {drift[0]:.3e}, gradient drift "
                 f"{drift[1]:.3e}; ")
              + f"worst gradient relative L2 {worst:.3e} (every leaf, gathered over the model "
              f"ranks), launches by the closed form on every rank {lc}, row copies "
              f"{summary['fp32'][name]['d2h_bytes']} bytes, α {franks[0]['alphas']}")
    summary["seconds"] = time.perf_counter() - t0
    print(f"model-axis phase took {summary['seconds']:.1f} s (to the end of the {SP}-rank spawn, "
          f"the full-width cell and its fp32 layout, {t_full:.1f} s; the four-rank fp32 layouts "
          f"in a spawn beside it)")
    return counts, summary


# ---------------------------------------------------------------------------
# Paged continuous-batching serving (DESIGN.md §16): the engine at full
# width on the card, and serving at sp = 2 / pp = 2 with ranks sharing it
# ---------------------------------------------------------------------------


def paged_trace(vocab: int, seed: int = 0):
    """PAGED_TRACE's requests from ``numpy.random.default_rng(seed)``:
    (rid, prompt, max_new, arrival) dicts."""
    rng = np.random.default_rng(seed)
    t = PAGED_TRACE
    reqs = []
    for i in range(t["n"]):
        plen = int(rng.integers(t["prompt"][0], t["prompt"][1] + 1))
        reqs.append(dict(rid=i, prompt=rng.integers(2, vocab, size=plen).astype(np.int32),
                         max_new=int(rng.integers(t["max_new"][0], t["max_new"][1] + 1)),
                         arrival=int(rng.integers(t["arrival"][0], t["arrival"][1] + 1))))
    return reqs


def paged_step_shape(gen, geo, K: int):
    """The kernel's inputs at the paged step's shape: K rows at their own
    positions ([K, 1] q_pos, a request at each decode depth up to the
    budget), each over its gathered [K, l_loc, Hkv, hd] logical slots, the
    rank's shared position map."""
    from repro_torch.runtime import kvpool

    dev, bf16 = "cuda", torch.bfloat16
    H, Hkv, hd = 28, 4, 128
    sched = dataclasses.make_dataclass("Sched", ["offsets", "lengths"])(
        (0,), (geo.s_bucket,))
    pos_map = torch.from_numpy(kvpool.pos_map(geo, sched)[0]).to(dev)
    q = torch.randn(K, 1, H, hd, generator=gen, device=dev).to(bf16)
    k = torch.randn(K, geo.l_loc, Hkv, hd, generator=gen, device=dev).to(bf16)
    v = torch.randn(K, geo.l_loc, Hkv, hd, generator=gen, device=dev).to(bf16)
    depth = torch.linspace(0, geo.max_new - 1, K, device=dev).round().to(torch.int32)
    q_pos = (geo.s_bucket + depth)[:, None]
    return q, k, v, q_pos, pos_map, None


def serve_fp32_shapes(fa, ref, gen, runner, cfg):
    """Untimed fp32 checks of the forward (the CUDA cores, with their
    split-KV merge) at the multi-rank serving phase's call shapes (full
    width, fp32): a decode step over one rank's sp = 2 cache shard (the
    prefill's shard, then the striped decode slots, PAD beyond), a pp = 2
    stage's microbatch over its cache, and the 1 x 2 engine's paged step
    (per-row q_pos over the gathered slots of rank 1's position map).
    Returns the worst normalized error."""
    from repro_torch.runtime import kvpool

    dev, f32 = "cuda", torch.float32
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    worst = 0.0

    def run(B, Tq, kv_pos, q_pos):
        nonlocal worst
        S = kv_pos.shape[0]
        q = torch.randn(B, Tq, H, hd, generator=gen, device=dev, dtype=f32)
        k = torch.randn(B, S, Hkv, hd, generator=gen, device=dev, dtype=f32)
        v = torch.randn(B, S, Hkv, hd, generator=gen, device=dev, dtype=f32)
        worst = max(worst, kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, None)[0])

    # sp = 2, rank 1 at decode step 3: its prefill shard's 128 slots
    # (positions 64..127 and 192..255 of two 128-token chunks), decode
    # tokens 1 and 3 at slots 128, 129 (positions 257, 259), PAD beyond
    S, steps = SERVE_SP_SEQ, 3
    loc = S // 2 + runner.DECODE_BUDGET
    pos = torch.full((loc,), PAD, dtype=torch.int32, device=dev)
    half = S // 4
    pos[:half] = torch.arange(half, 2 * half, dtype=torch.int32, device=dev)
    pos[half:2 * half] = torch.arange(3 * half, 4 * half, dtype=torch.int32, device=dev)
    for i in range(1, steps + 1, 2):
        pos[S // 2 + i // 2] = S + i
    run(SERVE_SP_BATCH, 1, pos, torch.full((1,), S + steps, dtype=torch.int32, device=dev))
    # pp = 2: a microbatch's rows over the stage's whole cache at step 2
    S = SERVE_PP_SEQ
    pos = torch.full((S + runner.DECODE_BUDGET,), PAD, dtype=torch.int32, device=dev)
    pos[:S + 3] = torch.arange(S + 3, dtype=torch.int32, device=dev)
    run(SERVE_PP_BATCH // SERVE_PP_MICRO, 1, pos,
        torch.full((1,), S + 2, dtype=torch.int32, device=dev))
    # the 1 x 2 engine's paged step on rank 1
    e = SERVE_ENGINE
    geo = kvpool.PoolGeometry(s_bucket=e["s_bucket"], sp=2, max_new=e["max_new"],
                              block_tokens=e["block_tokens"], n_blocks=8, n_slots=e["slots"])
    sched = dataclasses.make_dataclass("Sched", ["offsets", "lengths"])((0,), (e["s_bucket"],))
    pos_map = torch.from_numpy(kvpool.pos_map(geo, sched)[1]).to(dev)
    run(e["slots"], 1, pos_map,
        torch.tensor([[e["s_bucket"] + 1], [e["s_bucket"] + 3]], dtype=torch.int32, device=dev))
    print(f"fp32 serving shapes (sp = 2 decode shard, pp = 2 microbatch, 1 x 2 paged step): "
          f"the CUDA-core forward within {KERNEL_TOL} (worst {worst:.3e})")
    return worst


@contextlib.contextmanager
def recorded_gaps(model_def_cls, gaps: list):
    """Within the block, every ``head_logits`` call appends the top-2 gap of
    each row's logits ([rows] fp32 numpy) to ``gaps``: the CPU oracle's
    record of how near a greedy choice was to a tie."""
    orig = model_def_cls.head_logits

    def recording(self, g, x, ctx=None):
        logits = orig(self, g, x) if ctx is None else orig(self, g, x, ctx)
        top = logits.topk(2, dim=-1).values
        gaps.append((top[..., 0] - top[..., 1]).reshape(-1).numpy())
        return logits

    model_def_cls.head_logits = recording
    try:
        yield
    finally:
        model_def_cls.head_logits = orig


def static_decode(runner, cell_pre, cell_dec, params, prompts, steps, dev, ctx=None,
                  context=None):
    """Prefill ``prompts`` [B, S] (and a cross-attention model's ``context``,
    [B, N_ctx, d] numpy) and decode ``steps`` greedy tokens on one device
    (tokens [B, steps])."""
    kw = {} if ctx is None else {"ctx": ctx}
    S = prompts.shape[1]
    cx = None if context is None else torch.from_numpy(context).to(dev)
    state, _ = runner.make_prefill_step(cell_pre, **kw)(params, torch.from_numpy(prompts).to(dev),
                                                         cx)
    step = runner.make_serve_step(cell_dec, decode_steps=steps, **kw)
    cur, toks = torch.from_numpy(np.ascontiguousarray(prompts[:, -1:])).to(dev), []
    for i in range(steps):
        state, cur = step(params, state, cur, S + i)
        toks.append(cur[:, 0].cpu().numpy())
    return np.stack(toks, axis=1)


def held_against_cpu(got, want, gaps, what):
    """Tokens [rows, steps] of the card against the CPU's, with the CPU's
    top-2 gap of each (row, step): a token may differ only where that gap
    is under TIE_GAP (a tie the two devices may break apart), and the row is
    not compared past it.  Returns the ties allowed."""
    ties = []
    for b in range(want.shape[0]):
        for i in range(want.shape[1]):
            if got[b, i] == want[b, i]:
                continue
            check(gaps[b, i] < TIE_GAP, f"{what}: row {b} step {i} decoded {got[b, i]}, the CPU "
                  f"{want[b, i]}, with a top-2 gap of {gaps[b, i]:.3e} >= {TIE_GAP}")
            ties.append((b, i, float(gaps[b, i])))
            print(f"  tie allowed [{what}]: row {b} step {i}: card {got[b, i]}, CPU "
                  f"{want[b, i]}, the CPU's top-2 gap {gaps[b, i]:.3e}")
            break
    return ties


def decode_collectives(cfg, B: int, steps: int) -> dict:
    """The model collectives of ``steps`` sp = 2 decode steps of B rows on
    one rank by the closed form: (calls, bytes this rank put in) of each.
    A step embeds (a sum of [B, 1, d]), gathers each layer's 7 "ag" weight
    leaves (its shard of each), merges each layer's attention (a max of m
    [B, 1, H], sums of o [B, 1, H, hd] and l) and gathers its vocab shard's
    logits ([B, 1, Vp / 2], fp32)."""
    from repro_torch.models import layers as L

    d, H, Hkv, hd, ff, n = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.n_layers
    it = 4
    ag = (d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * ff) // 2 * it
    vp = L.pad_vocab(cfg.vocab_size, 2048)
    return {"model_all_gather": (steps * (7 * n + 1), steps * (n * ag + B * vp // 2 * it)),
            "model_psum": (steps * (2 * n + 1),
                           steps * (B * d * it + n * B * H * (hd + 1) * it)),
            "model_pmax": (steps * n, steps * n * B * H * it),
            "model_reduce_scatter": (0, 0)}


def prefill_collectives(cfg, B: int, lengths) -> dict:
    """The calls of an sp = 2 gather_q prefill's model collectives by the
    closed form: each chunk's embedding reduce-scatter, and each layer's 7
    weight gathers, its query and position gathers, the merge's max and
    its two reduce-scatters."""
    n, c = cfg.n_layers, len(lengths)
    return {"model_all_gather": c * n * 9, "model_pmax": c * n,
            "model_reduce_scatter": c * (2 * n + 1), "model_psum": 0}


def serve_fp32_rank(rank, device, jobs):
    """One rank of the multi-rank serving layouts (fp32, full width cut to
    SERVE_FP32_LAYERS layers, weights drawn on the card from seed 0 and
    sliced to the rank's stage and model shard): static sp = 2 and pp = 2
    decode, and the engine at 1 x 2.  Returns each job's tokens, the
    context's counts (decode steps alone for the static jobs) and the
    forward's launches."""
    _port_path()
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.parallel import runner

    torch.backends.cuda.matmul.allow_tf32 = False
    t_up = time.time()
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=SERVE_FP32_LAYERS)
    out = {"t_up": t_up, "rank": rank}
    for job in jobs:
        fa.reset_counts()
        t0 = time.perf_counter()
        if job["kind"] == "static":
            prompts, lay = job["prompts"], job["layout"]
            B, S = prompts.shape
            pp, sp = lay.get("pp", 1), lay.get("sp", 1)
            sizes = dict(data_size=pp, model_size=sp, dtype=torch.float32)
            pre = runner.resolve_cell(cfg, ShapeConfig("serve_fp32", S, B, "prefill"),
                                      overrides=dict(pp=pp, dp=1, n_chunks=max(1, S // 64),
                                                     offload=False, remat="none"), **sizes)
            dec = runner.resolve_cell(cfg, ShapeConfig("serve_fp32", S, B, "decode"),
                                      overrides=dict(pp=pp, dp=1, **lay.get("dec_plan", {})),
                                      **sizes)
            ctx = dec.ctx(device=device)
            params = serve.build_params(pre, device, seed=0, stage=ctx.stage_index(),
                                        model_rank=ctx.model_index())
            prefill = runner.make_prefill_step(pre, ctx)
            state, _ = prefill(params, torch.from_numpy(prompts).to(device))
            pre_counts = ctx.counts()
            ctx.reset_counts()
            step = runner.make_serve_step(dec, decode_steps=job["steps"], ctx=ctx)
            cur, toks = torch.from_numpy(np.ascontiguousarray(prompts[:, -1:])).to(device), []
            for i in range(job["steps"]):
                state, cur = step(params, state, cur, S + i)
                toks.append(cur[:, 0].cpu().numpy())
            res = dict(tokens=np.stack(toks, axis=1), counts=ctx.counts(),
                       prefill_counts=pre_counts, chunks=pre.sched.lengths,
                       microbatch=dec.plan.decode_microbatch, stage=ctx.stage_index(),
                       model=ctx.model_index())
            del state, params
        else:
            eng = serve.ServeEngine(cfg, (1, 2), device=device, dtype=torch.float32,
                                    **SERVE_ENGINE)
            eng.ctx.reset_counts()
            fa.reset_counts()
            reqs = [serve.Request(**r) for r in job["trace"]]
            toks, stats = eng.run(reqs, mode="continuous")
            res = dict(tokens=toks, stats=stats, counts=eng.ctx.counts(),
                       chunks=eng.pre_cell.sched.lengths,
                       pool_closed_form=eng.predicted_pool_bytes())
            del eng
        torch.cuda.synchronize()
        res.update(launches=fa.counts(), seconds=time.perf_counter() - t0)
        out[job["name"]] = res
        torch.cuda.empty_cache()
    out["t_done"] = time.time()
    return out


def serve_ranks_phase(fa, mesh, runner, serve, card):
    """Serving over ranks that share the one card over gloo (every transfer
    staged through pinned host memory), qwen2-7b at full width cut to
    SERVE_FP32_LAYERS layers in fp32 (the CUDA-core kernels), the CPU's one
    device (same weights, plain path) the oracle: static sp = 2 (prefill
    SERVE_SP_SEQ, SERVE_SP_STEPS decode steps), static pp = 2
    (SERVE_PP_BATCH rows in SERVE_PP_MICRO microbatches) and the engine at
    mesh 1 x 2 on a short trace.  Tokens as the CPU's but where the CPU's
    top-2 gap is under TIE_GAP; each rank's collectives and hand-offs by
    their closed forms.  Returns (launches by path, a summary)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.models.model_zoo import ModelDef

    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-7b"), n_layers=SERVE_FP32_LAYERS)
    rng = np.random.default_rng(5)
    sp_prompts = rng.integers(2, cfg.vocab_size, size=(SERVE_SP_BATCH, SERVE_SP_SEQ)).astype(
        np.int32)
    pp_prompts = rng.integers(2, cfg.vocab_size, size=(SERVE_PP_BATCH, SERVE_PP_SEQ)).astype(
        np.int32)
    e = SERVE_ENGINE
    trace = [dict(rid=i, prompt=rng.integers(2, cfg.vocab_size, size=int(n)).astype(np.int32),
                  max_new=int(m), arrival=int(a))
             for i, (n, m, a) in enumerate(zip(rng.integers(16, e["s_bucket"] + 1, size=3),
                                               rng.integers(1, e["max_new"] + 1, size=3),
                                               (0, 0, 1)))]
    jobs = [dict(kind="static", name="sp2", prompts=sp_prompts, steps=SERVE_SP_STEPS,
                 layout=dict(sp=2)),
            dict(kind="static", name="pp2", prompts=pp_prompts, steps=SERVE_PP_STEPS,
                 layout=dict(pp=2, dec_plan=dict(decode_microbatch=SERVE_PP_MICRO))),
            dict(kind="engine", name="engine_1x2", trace=trace)]
    # the CPU oracle: the same seed-built weights (drawn on the card, as
    # every rank draws them), fp32, one device, each step's top-2 gaps
    t_cpu = time.perf_counter()
    cell = runner.resolve_cell(cfg, ShapeConfig("serve_fp32", SERVE_SP_SEQ, 1, "prefill"),
                               overrides=dict(pp=1, dp=1, offload=False, remat="none"),
                               dtype=torch.float32)
    params = tree_map(lambda t: t.cpu(), serve.build_params(cell, "cuda", seed=0))
    torch.cuda.empty_cache()

    def cells(S, B):
        pre = runner.resolve_cell(cfg, ShapeConfig("serve_fp32", S, B, "prefill"),
                                  overrides=dict(pp=1, dp=1, n_chunks=max(1, S // 64),
                                                 offload=False, remat="none"),
                                  dtype=torch.float32)
        dec = runner.resolve_cell(cfg, ShapeConfig("serve_fp32", S, B, "decode"),
                                  overrides=dict(pp=1, dp=1), dtype=torch.float32)
        return pre, dec

    cpu = {}
    for name, prompts, steps in (("sp2", sp_prompts, SERVE_SP_STEPS),
                                 ("pp2", pp_prompts, SERVE_PP_STEPS)):
        gaps = []
        with recorded_gaps(ModelDef, gaps):
            toks = static_decode(runner, *cells(*prompts.shape[::-1]), params, prompts, steps,
                                 "cpu")
        cpu[name] = (toks, np.stack(gaps, axis=1))
    # each request alone, right-aligned in the bucket: the engine's tokens
    for r in trace:
        row = np.zeros((1, e["s_bucket"]), np.int32)
        row[0, e["s_bucket"] - len(r["prompt"]):] = r["prompt"]
        gaps = []
        with recorded_gaps(ModelDef, gaps):
            toks = static_decode(runner, *cells(e["s_bucket"], 1), params, row, r["max_new"],
                                 "cpu")
        cpu[("engine", r["rid"])] = (toks, np.stack(gaps, axis=1))
    del params
    t_cpu = time.perf_counter() - t_cpu
    # the ranks after the oracle: beside it (a thread) they ran slower on
    # the H100 machine's 8 shared cores, the phase 87 s against 70
    t_spawn = time.perf_counter()
    ranks = mesh.spawn(serve_fp32_rank, 2, backend=PIPE_BACKEND, device="cuda", args=(jobs,),
                       timeout_s=PIPE_DEADLINE_S)
    t_spawn = time.perf_counter() - t_spawn
    counts, ties, summary = {}, {}, {}
    for name in ("sp2", "pp2", "engine_1x2"):
        rows = [r[name] for r in ranks]
        counts[f"serve_{name}_fp32"] = {k: sum(r["launches"][k] for r in rows)
                                        for k in rows[0]["launches"]}
        check(all(r["launches"]["fwd"] > 0 for r in rows)
              and all(r["launches"][k] == 0 for r in rows
                      for k in ("fwd_tc", "merged_in_kernel", "bwd_dq", "bwd_dkv", "bwd_dq_tc",
                                "bwd_dkv_tc")),
              f"serving [{name}] launched {[r['launches'] for r in rows]}: the fp32 path runs "
              "the CUDA-core forward alone")
        summary[name] = {"seconds": [r["seconds"] for r in rows],
                         "launches": [r["launches"] for r in rows]}
    # static sp = 2: tokens, and each rank's collectives
    for r in ranks:
        got = r["sp2"]
        ties.setdefault("sp2", []).extend(held_against_cpu(got["tokens"], *cpu["sp2"],
                                                           f"sp2 rank {r["rank"]}"))
        want = decode_collectives(cfg, SERVE_SP_BATCH, SERVE_SP_STEPS)
        for kind, (calls, nbytes) in want.items():
            c = got["counts"]
            check(c[f"{kind}_calls"] == calls and c[f"{kind}_bytes"] == nbytes,
                  f"sp2 decode {kind}: {c[f'{kind}_calls']} calls, {c[f'{kind}_bytes']} bytes; "
                  f"closed form {calls}, {nbytes}")
        for kind, calls in prefill_collectives(cfg, SERVE_SP_BATCH, got["chunks"]).items():
            check(got["prefill_counts"][f"{kind}_calls"] == calls,
                  f"sp2 prefill {kind}: {got['prefill_counts'][f'{kind}_calls']} calls, closed "
                  f"form {calls}")
    # static pp = 2: tokens on both stages, the hand-offs and the stage sum
    for r in ranks:
        got = r["pp2"]
        check(got["microbatch"] == SERVE_PP_MICRO, f"pp2 ran {got['microbatch']} microbatches")
        ties.setdefault("pp2", []).extend(held_against_cpu(got["tokens"], *cpu["pp2"],
                                                           f"pp2 stage {got['stage']}"))
        c, M = got["counts"], SERVE_PP_MICRO
        sent = (SERVE_PP_STEPS * M * (SERVE_PP_BATCH // M) * cfg.d_model * 4
                if got["stage"] == 0 else 0)
        check(c["handoffs"] == SERVE_PP_STEPS * M and c["handoff_bytes"] == sent
              and c["reduce_bytes"] == SERVE_PP_STEPS * SERVE_PP_BATCH * 4,
              f"pp2 stage {got['stage']}: {c['handoffs']} hand-offs, {c['handoff_bytes']} bytes "
              f"sent, {c['reduce_bytes']} bytes summed; closed form {SERVE_PP_STEPS * M}, {sent}, "
              f"{SERVE_PP_STEPS * SERVE_PP_BATCH * 4}")
    # the engine at 1 x 2
    for r in ranks:
        got = r["engine_1x2"]
        st = got["stats"]
        for q in trace:
            want_toks, want_gaps = cpu[("engine", q["rid"])]
            ties.setdefault("engine_1x2", []).extend(held_against_cpu(
                got["tokens"][q["rid"]][None], want_toks, want_gaps,
                f"engine 1 x 2 rank {r["rank"]} request {q['rid']}"))
        check(st.pool_bytes == got["pool_closed_form"],
              f"engine 1 x 2 pool {st.pool_bytes} bytes, closed form {got['pool_closed_form']}")
        dec = decode_collectives(cfg, e["slots"], st.steps)
        pre = prefill_collectives(cfg, e["slots"], got["chunks"])
        c = got["counts"]
        for kind in ("model_all_gather", "model_psum", "model_pmax", "model_reduce_scatter"):
            calls = dec[kind][0] + st.waves * pre[kind]
            check(c[f"{kind}_calls"] == calls,
                  f"engine 1 x 2 {kind}: {c[f'{kind}_calls']} calls, closed form {calls} "
                  f"({st.steps} steps, {st.waves} waves)")
        summary["engine_1x2"].update(steps=st.steps, waves=st.waves, wall_s=st.wall_s)
    print(f"serving over ranks [{card}] qwen2-7b {SERVE_FP32_LAYERS} layers at full width, "
          f"fp32, 2 ranks on one card over {PIPE_BACKEND} ({SP_SHARED}): sp = 2 static "
          f"(prefill {SERVE_SP_SEQ} in chunks {ranks[0]['sp2']['chunks']}, {SERVE_SP_STEPS} "
          f"steps), pp = 2 static ({SERVE_PP_BATCH} rows in {SERVE_PP_MICRO} microbatches, "
          f"{SERVE_PP_STEPS} steps), the engine at 1 x 2 ({ranks[0]['engine_1x2']['stats'].steps} "
          f"steps, {ranks[0]['engine_1x2']['stats'].waves} waves): tokens as the CPU's "
          f"({sum(len(v) for v in ties.values())} ties allowed), collectives and hand-offs at "
          f"their closed forms; job seconds {json.dumps({k: v['seconds'] for k, v in summary.items()})}, "
          f"CPU oracle {t_cpu:.1f} s, spawn {t_spawn:.1f} s")
    summary.update(ties=ties, cpu_oracle_s=t_cpu, spawn_s=t_spawn,
                   seconds=time.perf_counter() - t0)
    print(f"serving-over-ranks phase took {summary['seconds']:.1f} s")
    return counts, summary


def paged_profile(eng, runner, serve, card):
    """Where a paged step's time goes: all slots admitted in one wave, two
    warm steps, then PAGED_PROFILE_STEPS steps under torch.profiler, each
    pushing its host state as the engine's loop does (one pinned buffer a
    step).  Device busy time over the profiled wall gives the idle share."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime import kvpool

    geo, K, dev = eng.geo, eng.slots, eng.device
    rng = np.random.default_rng(1)
    prompts = rng.integers(2, eng.cfg.vocab_size, size=(K, geo.s_bucket)).astype(np.int32)
    btab = np.stack([kvpool.block_table_row(geo, range(i * geo.max_blocks,
                                                       (i + 1) * geo.max_blocks))
                     for i in range(K)])
    pool = runner.make_pool_state(eng.dec_cell, geo, dev)
    state, _ = eng._prefill(eng.params, torch.from_numpy(prompts).to(dev))
    mb = geo.max_blocks

    def host_state(i, admit):
        arr = np.concatenate([btab, np.full((K, 1), geo.s_bucket + i, np.int32),
                              np.full((K, 1), int(admit), np.int32), prompts[:, -1:]], axis=1)
        h = serve._push(arr, dev)
        return h[:, :mb], h[:, mb], h[:, mb + 1].bool(), h[:, mb + 2:]

    bt, qp, adm, atok = host_state(0, True)
    pool = eng._ingest(state, pool, bt, adm)
    del state
    tokens = torch.zeros((K, 1), dtype=torch.int32, device=dev)
    pool, tokens = eng._step(eng.params, pool, tokens, qp, bt, adm, atok)
    for i in (1, 2):
        bt, qp, adm, atok = host_state(i, False)
        pool, tokens = eng._step(eng.params, pool, tokens, qp, bt, adm, atok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3, 3 + PAGED_PROFILE_STEPS):
            bt, qp, adm, atok = host_state(i, False)
            pool, tokens = eng._step(eng.params, pool, tokens, qp, bt, adm, atok)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / PAGED_PROFILE_STEPS
    busy, groups, top = device_time(prof)
    busy, groups = busy / PAGED_PROFILE_STEPS, {k: v / PAGED_PROFILE_STEPS for k, v in groups.items()}
    print(f"paged step profile ({card}): {K} rows, device busy {busy:.3f} ms of {wall:.3f} ms "
          f"wall a step (idle {1 - busy / wall:.1%}), {json.dumps(groups)}")
    for name, ms in top:
        print(f"  paged step top kernel: {ms / PAGED_PROFILE_STEPS:9.3f} ms  {name}")
    check(busy > 0, "profiler captured no device time of the paged step")
    return {"paged_step_device_ms": busy, "paged_step_profiled_wall_ms": wall,
            "paged_step_idle_share": 1 - busy / wall, "paged_step_device_ms_by_group": groups}


def paged_serve_phase(fa, runner, serve, cfg, card):
    """The paged engine at full width on the card (DESIGN.md §16): qwen2-7b,
    all layers, bf16, random weights from seed 0; PAGED's geometry with the
    default block count; PAGED_TRACE's requests continuous (the main path,
    its loop under ``set_sync_debug_mode("error")``), then static, then
    PAGED_SOLO of them alone.  Tokens bitwise alike across the three, the
    blocks recycled within the concurrency bound, the pool's bytes at the
    closed form, the tensor-core forward launched 28 x (steps + prefill
    chunks x waves) times.  Returns (launches by path, a summary)."""
    from repro_torch.runtime import kvpool

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    eng = serve.ServeEngine(cfg, **PAGED)
    geo = eng.geo
    check(geo.n_blocks == PAGED["slots"] * geo.max_blocks == 1056,
          f"default pool {geo.n_blocks} blocks of {geo.max_blocks} a request")
    reqs = [serve.Request(**r) for r in paged_trace(cfg.vocab_size)]
    counts, runs = {}, {}
    for mode in ("continuous", "static"):
        fa.reset_counts()
        torch.cuda.synchronize()
        toks, stats = eng.run(reqs, mode=mode, sync_debug="error")
        counts[f"serve_paged_{mode}"] = fa.counts()
        runs[mode] = (toks, stats)
        n = counts[f"serve_paged_{mode}"]["fwd_tc"]
        want = cfg.n_layers * (stats.steps + eng.pre_cell.sched.n * stats.waves)
        dec_tokens = sum(r.max_new for r in reqs)
        print(f"paged engine [{mode}] ({card}) {cfg.name} {cfg.n_layers} layers, {len(reqs)} "
              f"requests: {stats.steps} steps, {stats.waves} waves ({eng.pre_cell.sched.n} "
              f"prefill chunks each), {stats.wall_s:.3f} s wall, {dec_tokens / stats.wall_s:.1f} "
              f"decoded tokens/s, {1e3 * stats.wall_s / stats.steps:.3f} ms a step (prefill "
              f"waves included); blocks peak {stats.peak_blocks[0]} / total "
              f"{stats.total_blocks[0]} of {geo.n_blocks}; tensor-core forward launches {n} "
              f"(closed form {want}); all {counts[f'serve_paged_{mode}']}")
        check(n == want, f"paged {mode}: the tensor-core forward launched {n} times, expected {want}")
        check(all(v == 0 for k, v in counts[f"serve_paged_{mode}"].items()
                  if k not in ("fwd_tc", "merged_in_kernel")),
              f"paged {mode} launched other kernels: {counts[f'serve_paged_{mode}']}")
    cont, stats = runs["continuous"]
    stat, _ = runs["static"]
    for r in reqs:
        check(len(cont[r.rid]) == r.max_new and np.array_equal(cont[r.rid], stat[r.rid]),
              f"request {r.rid}: continuous {cont[r.rid][:8]} != static {stat[r.rid][:8]}")
        check(bool(((cont[r.rid] >= 0) & (cont[r.rid] < cfg.vocab_size)).all()),
              f"request {r.rid}: token ids out of range")
    solo_ids = [r.rid for r in reqs[:PAGED_SOLO]]
    fa.reset_counts()
    for r in reqs[:PAGED_SOLO]:
        solo, _ = eng.run([serve.Request(rid=r.rid, prompt=r.prompt, max_new=r.max_new)],
                          mode="static", sync_debug="error")
        check(np.array_equal(solo[r.rid], cont[r.rid]),
              f"request {r.rid}: solo {solo[r.rid][:8]} != continuous {cont[r.rid][:8]}")
    counts["serve_paged_solo"] = fa.counts()
    bound = kvpool.concurrent_peak([(s, e, geo.blocks_for(r.max_new))
                                    for r in reqs for (s, e) in [stats.spans[r.rid]]])
    check(stats.peak_blocks[0] <= bound <= geo.n_blocks < stats.total_blocks[0],
          f"blocks: peak {stats.peak_blocks[0]}, bound {bound}, pool {geo.n_blocks}, total "
          f"{stats.total_blocks[0]}: not recycled within the bound")
    closed = eng.predicted_pool_bytes()
    check(stats.pool_bytes == closed == kvpool.device_pool_bytes(geo, cfg, cfg.n_layers, 2),
          f"pool {stats.pool_bytes} bytes, closed form {closed}")
    print(f"paged engine ({card}): continuous == static == solo ({solo_ids}) bitwise for every "
          f"request; peak {stats.peak_blocks[0]} <= bound {bound} <= {geo.n_blocks} blocks < "
          f"{stats.total_blocks[0]} allocated; pool {stats.pool_bytes} bytes = kv_pool_bytes "
          f"{geo.pool_bytes(cfg, cfg.n_layers, 2)} + sink "
          f"{kvpool.sink_bytes(cfg, cfg.n_layers, 2)}; no host sync in the loop "
          f"(set_sync_debug_mode error)")
    prof = paged_profile(eng, runner, serve, card)
    s_cont, s_stat = runs["continuous"][1], runs["static"][1]
    summary = {"continuous": {"steps": s_cont.steps, "waves": s_cont.waves,
                              "wall_s": s_cont.wall_s,
                              "decode_tokens_per_s": sum(r.max_new for r in reqs) / s_cont.wall_s,
                              "ms_per_step": 1e3 * s_cont.wall_s / s_cont.steps,
                              "peak_blocks": s_cont.peak_blocks[0],
                              "total_blocks": s_cont.total_blocks[0]},
               "static": {"steps": s_stat.steps, "waves": s_stat.waves, "wall_s": s_stat.wall_s,
                          "decode_tokens_per_s": sum(r.max_new for r in reqs) / s_stat.wall_s,
                          "ms_per_step": 1e3 * s_stat.wall_s / s_stat.steps},
               "pool_bytes": stats.pool_bytes, "concurrent_peak": bound,
               "n_blocks": geo.n_blocks, "prefill_chunks": eng.pre_cell.sched.n, **prof}
    del eng
    torch.cuda.empty_cache()
    summary["seconds"] = time.perf_counter() - t0
    print(f"paged engine phase took {summary['seconds']:.1f} s")
    return counts, summary


# ---------------------------------------------------------------------------
# the MoE family: granite-moe-1b-a400m
# ---------------------------------------------------------------------------


def moe_all_to_all(cell, *, replay: bool) -> tuple:
    """(calls, bytes this rank put in) of one rank's all-to-alls in one
    loss-and-gradients call at sp > 1, pp = 1, by the closed form: each MoE
    block's forward sends its copies' rows (sp x C rows of d), their expert
    ids (sp x C int32) and the experts' outputs back (sp x C x d); its
    backward sends the two row cotangents; the sppo / full seam runs the
    forward again in its replay.  C from the rank's b_loc x ln / sp tokens
    of each chunk (``models/moe.py::capacities``)."""
    from repro_torch.models.moe import capacities

    cfg, sp = cell.cfg, cell.plan.sp
    item = torch.tensor([], dtype=cell.dtype).element_size()
    n_fwd = 2 if replay else 1
    calls = nbytes = 0
    for ln in cell.sched.lengths:
        c, _ = capacities(cfg, cell.b_loc * (ln // sp), sp)
        rows = sp * c
        calls += cfg.n_layers * (3 * n_fwd + 2)
        nbytes += cfg.n_layers * (n_fwd * (2 * rows * cfg.d_model * item + 4 * rows)
                                  + 2 * rows * cfg.d_model * item)
    return calls, nbytes


def moe_serve(fa, hostmem, serve, runner, card):
    """(a) Static serving at all 24 layers, bf16, through the CLI entry
    point: MOE_REPEATS runs of B 4, prompt 2048 in 16 chunks, 32 decode
    steps.  The tensor-core forward launched 24 x (16 + 32) times a run
    (the calls whose KV range its geometry splits merging in the launch),
    nothing else, no host copy; then the same seed's model cut to 2 layers
    serves in fp32 on the card and on the CPU: the decoded tokens alike (a
    tie under TIE_GAP excepted)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.models.model_zoo import ModelDef

    cfg = get_config(MOE_ARCH)
    fa.reset_counts()
    hostmem.reset_counts()
    out = serve.main(["--arch", MOE_ARCH, "--prompt-len", str(PREFILL_LEN),
                      "--batch", str(BATCH), "--decode-steps", str(DECODE_STEPS),
                      "--repeats", str(MOE_REPEATS)])
    counts = fa.counts()
    check(not any(hostmem.counts().values()),
          f"[{MOE_ARCH}] serving copied to or from host memory: {hostmem.counts()}")
    n_chunks = out["n_chunks"]
    check(n_chunks == 16, f"[{MOE_ARCH}] prefill ran {n_chunks} chunks, expected 16")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    G, Hkv = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads
    clen = PREFILL_LEN // n_chunks
    cache = PREFILL_LEN + runner.DECODE_BUDGET
    splits = (sum(fa._tc_geometry(BATCH, clen, (c + 1) * clen, G, Hkv, n_sm)[2] > 1
                  for c in range(n_chunks))
              + DECODE_STEPS * (fa._tc_geometry(BATCH, 1, cache, G, Hkv, n_sm)[2] > 1))
    want = {**{k: 0 for k in counts},
            "fwd_tc": MOE_REPEATS * cfg.n_layers * (n_chunks + DECODE_STEPS),
            "merged_in_kernel": MOE_REPEATS * cfg.n_layers * splits}
    check(counts == want, f"[{MOE_ARCH}] serving launched {counts}, expected {want}")
    toks = out["tokens"]
    check(toks.shape == (BATCH, DECODE_STEPS)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"[{MOE_ARCH}] decoded tokens {toks.shape} out of range")
    check(bool(torch.isfinite(out["last_hidden"]).all()), f"[{MOE_ARCH}] hidden not finite")
    runs = []
    for run, (p_s, d_s) in enumerate(zip(out["prefill_s_runs"], out["decode_s_runs"])):
        runs.append({"prefill_s": p_s, "prefill_tokens_per_s": BATCH * PREFILL_LEN / p_s,
                     "decode_ms_per_step": 1e3 * d_s / DECODE_STEPS,
                     "decode_tokens_per_s": BATCH * DECODE_STEPS / d_s})
        print(f"serve [{MOE_ARCH}] run {run} ({card}): {cfg.n_layers} layers, prefill "
              f"{p_s:.4f} s, {runs[-1]['prefill_tokens_per_s']:.1f} tokens/s; decode "
              f"{runs[-1]['decode_ms_per_step']:.3f} ms/step, "
              f"{runs[-1]['decode_tokens_per_s']:.1f} tokens/s")
    print(f"serve [{MOE_ARCH}] launches {counts} (expected {want}); peak "
          f"{out['peak_bytes'] / 2**30:.3f} GiB ({card})")
    # the 2-layer fp32 run, card against CPU
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    S, steps = MOE_CHECK_SEQ, MOE_CHECK_STEPS
    pre = runner.resolve_cell(cfg2, ShapeConfig("moe_fp32", S, BATCH, "prefill"),
                              overrides=dict(pp=1, dp=1, n_chunks=S // 64, offload=False,
                                             remat="none"), dtype=torch.float32)
    dec = runner.resolve_cell(cfg2, ShapeConfig("moe_fp32", S, BATCH, "decode"),
                              overrides=dict(pp=1, dp=1), dtype=torch.float32)
    params = serve.build_params(pre, "cuda", seed=0)
    prompts = np.random.default_rng(1).integers(2, cfg.vocab_size,
                                                size=(BATCH, S)).astype(np.int32)
    got = static_decode(runner, pre, dec, params, prompts, steps, "cuda")
    params = tree_map(lambda t: t.cpu(), params)
    torch.cuda.empty_cache()
    gaps = []
    with recorded_gaps(ModelDef, gaps):
        want_toks = static_decode(runner, pre, dec, params, prompts, steps, "cpu")
    ties = held_against_cpu(got, want_toks, np.stack(gaps, axis=1), f"{MOE_ARCH} fp32 serve")
    print(f"serve [{MOE_ARCH}] 2 layers fp32 ({card}): {BATCH} rows, prefill {S}, {steps} "
          f"decode steps: tokens as the CPU's ({len(ties)} ties)")
    del params
    return counts, {"runs": runs, "peak_bytes": out["peak_bytes"], "fp32_ties": ties}


def moe_train_check(fa, hostmem, serve, runner, cfg, card):
    """(c) The seed-built model cut to 2 layers: one step's loss and
    gradients at S = 256 (2 chunks), fp32, under the default plan (chunk 0
    offloads every tagged row), on the card (kernels, no TF32) and on the
    CPU: the CUDA-core kernels' launches and the row copies by their closed
    forms, the loss and the gradients of layer 0's attention and expert
    leaves, its router and the tied table within GRAD_REL_TOL relative
    L2."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM

    S = MOE_CHECK_SEQ
    cell = runner.resolve_cell(dataclasses.replace(cfg, n_layers=2),
                               ShapeConfig("moe_train_check", S, 1, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=2), dtype=torch.float32)
    check(cell.plan.offload and cell.plan.remat == "sppo",
          f"[{MOE_ARCH}] check plan {cell.plan}, expected the default plan")
    # chunk 0 offloads every tagged row, whatever α the cost model deploys
    cell = dataclasses.replace(cell, alphas=(1.0, 0.0))
    tokens, labels = (torch.from_numpy(a) for a in SyntheticLM(cfg.vocab_size, S, 1)
                      .sample_step(0))
    params = serve.build_params(cell, "cuda", seed=0)

    def pick(loss, g):
        layer = g["stages"][0]
        return {"loss": loss, **{k: layer["attn"][k] for k in ("wq", "wk", "wv", "wo")},
                **{k: layer["moe"][k] for k in ("router", "w1", "w3", "w2")},
                "table": g["globals"]["embed"]["table"]}

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    G, Hkv = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads
    splits = sum(fa._geometry(1, ln, off + ln, G, Hkv, n_sm)[2] > 1
                 for off, ln in zip(cell.sched.offsets, cell.sched.lengths))
    fa.reset_counts()
    hostmem.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, tokens.cuda(), labels.cuda())
    on_card = {k: v.cpu() for k, v in pick(loss, grads).items()}
    launched, copied = fa.counts(), hostmem.counts()
    want = {**{k: 0 for k in launched}, "fwd": 8, "merge": 4 * splits, "bwd_dq": 4,
            "bwd_dkv": 4}
    check(launched == want, f"[{MOE_ARCH}] the fp32 step launched {launched}, expected {want}")
    n_bytes = 4 * moe_offload_elems(cell)
    check(copied["d2h_bytes"] == copied["h2d_bytes"] == n_bytes and copied["d2h"] == 10
          and copied["d2h_pinned"] == 10,
          f"[{MOE_ARCH}] the fp32 step copied {copied}, expected 10 pinned D2H of {n_bytes} "
          "bytes (q, k, v, the attention output and the experts' hidden of 2 layers) and "
          "the same back")
    del grads
    params = tree_map(lambda t: t.cpu(), params)
    torch.cuda.empty_cache()
    loss, grads = runner.loss_and_grads(cell, params, tokens, labels)
    on_cpu = pick(loss, grads)
    rel = {k: ((on_card[k] - on_cpu[k]).norm() / on_cpu[k].norm()).item() for k in on_cpu}
    print(f"train [{MOE_ARCH}] 2-layer fp32 check ({card}), default plan: loss card "
          f"{float(on_card['loss']):.6f} vs CPU {float(on_cpu['loss']):.6f}; launches {launched}; "
          f"copies {copied}; relative L2 " + ", ".join(f"{k} {v:.3e}" for k, v in rel.items()))
    check(all(bool(torch.isfinite(v).all()) for v in on_card.values())
          and all(v <= GRAD_REL_TOL for v in rel.values()),
          f"[{MOE_ARCH}] card and CPU steps disagree: {rel} (tol {GRAD_REL_TOL})")
    return rel, launched


def moe_ep_rank(rank, device):
    """(d) One rank of expert parallelism at sp = 2: granite at full width
    cut to MOE_EP_LAYERS layers, fp32, B 1, S = MOE_EP_SEQ in MOE_EP_CHUNKS
    chunks, the default plan; the rank's shard of the seed-0 weights (drawn
    on the card), one loss-and-gradients call on the card (the CUDA-core
    kernels), then the same call on the CPU at the same layout (a context
    of CPU tensors over the same process group).  Returns the card's
    counts beside their closed forms and each leaf's relative L2 against
    the CPU."""
    _port_path()
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.parallel import runner
    from repro_torch.runtime import hostmem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_EP_LAYERS)
    cell = runner.resolve_cell(cfg, ShapeConfig("moe_ep", MOE_EP_SEQ, 1, "train"),
                               overrides=dict(pp=1, dp=1, sp=2, n_chunks=MOE_EP_CHUNKS),
                               dtype=torch.float32, model_size=2)
    ctx = cell.ctx(device=device)
    m = ctx.model_index()
    params = serve.build_params(cell, device, seed=0, model_rank=m)
    tokens, labels = (torch.from_numpy(a) for a in
                      SyntheticLM(cfg.vocab_size, MOE_EP_SEQ, 1).sample_step(0))
    fa.reset_counts()
    hostmem.reset_counts()
    ctx.reset_counts()
    t0 = time.perf_counter()
    loss, grads = runner.loss_and_grads(cell, params, tokens.to(device), labels.to(device),
                                        ctx=ctx)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launched, copied, counts = fa.counts(), hostmem.counts(), ctx.counts()
    card = {p: g.cpu() for p, g in tree.items(grads)}
    card_loss = float(loss)
    del grads
    params = tree_map(lambda t: t.cpu(), params)
    torch.cuda.empty_cache()
    cpu_ctx = cell.ctx(device="cpu")
    t0 = time.perf_counter()
    loss, grads = runner.loss_and_grads(cell, params, tokens, labels, ctx=cpu_ctx)
    cpu_s = time.perf_counter() - t0
    rel = {p: ((card[p] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for p, g in tree.items(grads) if not p.endswith("gate")}
    return {"rank": rank, "model_index": m, "loss": card_loss, "cpu_loss": float(loss),
            "cpu_all_to_all": (cpu_ctx.counts()["model_all_to_all_calls"],
                               cpu_ctx.counts()["model_all_to_all_bytes"]),
            "rel": rel, "launched": launched, "copied": copied,
            "all_to_all": (counts["model_all_to_all_calls"], counts["model_all_to_all_bytes"]),
            "all_to_all_s": counts["model_all_to_all_s"],
            "want_all_to_all": moe_all_to_all(cell, replay=True),
            "want_launches": {**{k: 0 for k in launched}, **model_axis_launches(
                fa, cell, list(zip(cell.sched.lengths, cell.sched.offsets)), device)},
            "want_d2h_bytes": 4 * moe_offload_elems(cell), "card_s": card_s, "cpu_s": cpu_s}


def moe_phase(fa, hostmem, mesh, serve, runner, train_mod, card):
    """The MoE family (ROADMAP Queue 1 item 7): granite-moe-1b-a400m served
    and trained at full width and all 24 layers on the card, its 2-layer
    fp32 steps against the CPU, and expert parallelism at sp = 2 over two
    ranks sharing the card.  Returns (launch counts by path, a summary)."""
    from repro_torch.configs.base import get_config

    t_phase = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    paths, summary = {}, {}
    # (a) serving
    t0 = time.perf_counter()
    paths["serve_moe"], summary["serve"] = moe_serve(fa, hostmem, serve, runner, card)
    summary["serve_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    # (b) training at all 24 layers under the default plan and offload off
    t0 = time.perf_counter()
    rows = {}
    for plan in ("d", "b"):
        paths[f"train_moe_plan_{plan}"], rows[plan], _ = train_plan(
            fa, hostmem, serve, runner, train_mod, cfg, card, plan, seq=MOE_SEQ,
            n_chunks=MOE_CHUNKS, steps=MOE_STEPS, label=MOE_ARCH, grads="none")
        torch.cuda.empty_cache()
    check(rows["d"]["losses"] == rows["b"]["losses"],
          f"[{MOE_ARCH}] plans (d) and (b) losses differ: {rows['d']['losses']} vs "
          f"{rows['b']['losses']}, expected bitwise equal at every step")
    print(f"train [{MOE_ARCH}] plans (d) and (b): losses bitwise equal at every step "
          f"{rows['d']['losses']}")
    summary["train"] = rows
    summary["train_s"] = time.perf_counter() - t0
    # (c) the 2-layer fp32 step against the CPU
    summary["fp32_check_rel_l2"], paths["train_moe_fp32"] = moe_train_check(
        fa, hostmem, serve, runner, cfg, card)
    # (d) expert parallelism, sp = 2, two ranks sharing the card
    t0 = time.perf_counter()
    ranks = mesh.spawn(moe_ep_rank, 2, backend="gloo", device="cuda", timeout_s=600.0)
    for r in ranks:
        what = f"[{MOE_ARCH}] sp = 2 rank {r['rank']}"
        rel_loss = abs(r["loss"] - r["cpu_loss"]) / abs(r["cpu_loss"])
        worst = max(r["rel"].items(), key=lambda kv: kv[1])
        print(f"train {what} ({card}; {SP_SHARED}): loss {r['loss']!r} vs CPU "
              f"{r['cpu_loss']!r} (relative {rel_loss:.3e}); worst leaf {worst[0]} "
              f"{worst[1]:.3e}; all-to-alls {r['all_to_all']} (closed form "
              f"{r['want_all_to_all']}, {r['all_to_all_s']:.3f} s); launches {r['launched']}; "
              f"D2H {r['copied']['d2h_bytes']} bytes; card {r['card_s']:.2f} s, CPU "
              f"{r['cpu_s']:.2f} s")
        check(rel_loss <= GRAD_REL_TOL and worst[1] <= GRAD_REL_TOL,
              f"{what}: card and CPU disagree: loss {rel_loss}, worst leaf {worst}")
        check(tuple(r["all_to_all"]) == tuple(r["want_all_to_all"])
              == tuple(r["cpu_all_to_all"]),
              f"{what}: all-to-alls {r['all_to_all']} (CPU {r['cpu_all_to_all']}), closed "
              f"form {r['want_all_to_all']}")
        check(r["launched"] == r["want_launches"],
              f"{what}: launched {r['launched']}, expected {r['want_launches']}")
        check(r["copied"]["d2h_bytes"] == r["copied"]["h2d_bytes"] == r["want_d2h_bytes"]
              and r["copied"]["d2h_pinned"] == r["copied"]["d2h"],
              f"{what}: copied {r['copied']}, expected {r['want_d2h_bytes']} bytes each way")
    check(abs(ranks[0]["loss"] - ranks[1]["loss"]) == 0.0,
          f"[{MOE_ARCH}] sp = 2 ranks hold different losses")
    paths["train_moe_ep_sp2"] = {k: sum(r["launched"][k] for r in ranks)
                                 for k in ranks[0]["launched"]}
    summary["ep_sp2"] = [{k: r[k] for k in ("rank", "loss", "cpu_loss", "rel", "all_to_all",
                                            "all_to_all_s", "card_s", "cpu_s")}
                         for r in ranks]
    summary["ep_s"] = time.perf_counter() - t0
    summary["seconds"] = time.perf_counter() - t_phase
    print(f"moe phase took {summary['seconds']:.1f} s (serve {summary['serve_s']:.1f}, train "
          f"{summary['train_s']:.1f}, sp = 2 {summary['ep_s']:.1f})")
    return paths, summary


# ---------------------------------------------------------------------------
# MLA: deepseek-v3-671b (hd_k 576, hd_v 512, G = 128, v a view of the latent)
# ---------------------------------------------------------------------------


def mla_edge_grid(fa, ref, gen, scale):
    """MLA's widths on the wide tensor-core kernels: forward within 1e-5,
    backward within 1e-5 x max |plain|.  v the latent's first 512 columns (a
    view of k) or a tensor of its own, G = 128 and 16, ragged Tq and S, PAD
    slots, Tq = 1 over a KV range split and merged in the launch, a q_start
    window with dead rows (exactly o = l = 0, m = -1e30; NaN cotangents
    there, their dq exactly 0) and a split decode with a dead batch row.
    Returns (worst forward error, worst backward relative error, cases)."""
    dev, bf16 = "cuda", torch.bfloat16

    def rand(*shape, dtype=bf16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    fwd, bwd, n = 0.0, 0.0, 0
    for B, Tq, S, H, Hkv, view in ((2, 5, 77, 128, 1, True), (1, 37, 150, 128, 1, True),
                                   (2, 9, 100, 32, 2, False), (1, 1, 300, 128, 1, True)):
        q, k = rand(B, Tq, H, 576), rand(B, S, Hkv, 576)
        v = k[..., :512] if view else rand(B, S, Hkv, 512)
        q_pos = (torch.arange(Tq, dtype=torch.int32, device=dev) + S - Tq)[None].repeat(B, 1)
        kv_pos = torch.arange(S, dtype=torch.int32, device=dev)
        kv_pos[S - S // 10:] = PAD
        err, _ = kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, None, scale=scale)
        _, rel, _ = bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, None, rand(B, Tq, H, 512,
                                 dtype=torch.float32), rand(B, Tq, H, dtype=torch.float32),
                                 scale=scale)
        fwd, bwd, n = max(fwd, err), max(bwd, *rel.values()), n + 1
    # a q_start window with dead rows, NaN cotangents on them
    B, Tq, S, H = 2, 8, 200, 128
    q, k = rand(B, Tq, H, 576), rand(B, S, 1, 576)
    q_pos = torch.tensor([[16 + i for i in range(Tq)], [1] + [9 + i for i in range(Tq - 1)]],
                         dtype=torch.int32, device=dev)
    q_start = torch.tensor([[0, 0, 4, 4, 4, 20, 20, PAD], [0, 3, 3, 3, 9, 9, PAD, PAD]],
                           dtype=torch.int32, device=dev)
    kv_pos = torch.arange(S, dtype=torch.int32, device=dev) + 2
    kv_pos[-3:] = PAD
    err, (o, m, l) = kernel_vs_plain(fa, ref, q, k, k[..., :512], q_pos, kv_pos, q_start,
                                     scale=scale)
    dead = ~visible_mask(B, q_pos, kv_pos, q_start).any(dim=-1)
    check_dead_rows(o, m, l, dead, 4, "MLA window case")
    do, dl = rand(B, Tq, H, 512, dtype=torch.float32), rand(B, Tq, H, dtype=torch.float32)
    do[dead], dl[dead] = float("nan"), float("nan")
    _, rel, (dq, _, _) = bwd_vs_plain(fa, ref, q, k, k[..., :512], q_pos, kv_pos, q_start, do, dl,
                                      scale=scale)
    check(bool((dq[dead] == 0).all()), "MLA window case: fully masked rows' dq is not exactly 0")
    fwd, bwd, n = max(fwd, err), max(bwd, *rel.values()), n + 1
    # a split decode over the serving cache with batch row 1 fully masked
    B, S = BATCH, PREFILL_LEN + 128
    q, k = rand(B, 1, 128, 576), rand(B, S, 1, 576)
    pos = torch.arange(S, dtype=torch.int32, device=dev)
    kv_pos = torch.where(pos <= PREFILL_LEN, pos, PAD).to(torch.int32)
    q_pos = torch.full((B, 1), PREFILL_LEN, dtype=torch.int32, device=dev)
    q_start = torch.zeros(B, 1, dtype=torch.int32, device=dev)
    q_start[1] = PAD
    check(fwd_nsplit(fa, "tensor_cores", q, k, k[..., :512]) > 1,
          "the MLA decode edge case does not split")
    err, (o, m, l) = kernel_vs_plain(fa, ref, q, k, k[..., :512], q_pos, kv_pos, q_start,
                                     scale=scale)
    dead = ~visible_mask(B, q_pos, kv_pos, q_start).any(dim=-1)
    check_dead_rows(o, m, l, dead[..., None].expand(B, 1, 128), 128, "MLA split decode")
    return max(fwd, err), bwd, n + 1


def measure_mla_shape(name, fa, ref, q, k, q_pos, kv_pos, scale, do=None, dl=None):
    """One MLA main-path shape on the wide tensor-core kernels, v the
    latent's first hd_v columns (a view of k, as the model passes it): the
    forward (and with ``do``, ``dl`` the backward pair) held against the
    plain version on the same inputs, then timed with cold L2 in two turns,
    beside the plain version and SDPA at the same mask (its backend named:
    none but the math one takes hd 576) and the bound: the q.k and p.v
    products (the backward's three and four) of each visible (query, slot)
    pair and head at the bf16 peak, or the bytes of the query rows that see
    some slot, the latent rows some query sees (once: v is its view) and
    the outputs, the larger.  Returns {"fwd": row[, "dq": row, "dkv": row]}."""
    hdv = 512
    v = k[..., :hdv]
    B, Tq, H, hdk = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    fwd_err, _ = kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, None, scale=scale)
    vis = visible_mask(B, q_pos, kv_pos, None)
    n_vis = int(vis.sum())
    live_rows, kv_rows = int(vis.any(dim=2).sum()), int(vis.any(dim=1).sum())
    esz, pos_bytes = q.element_size(), 4 * (q_pos.numel() + S)

    def bound(ops, n_bytes):
        t_b, t_o = n_bytes / HBM_BYTES_PER_S, ops / BF16_FLOPS
        return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    ops = 2 * (hdk + hdv) * H * n_vis
    n_bytes = (esz * (live_rows * H * hdk + kv_rows * Hkv * hdk) + pos_bytes
               + 4 * B * Tq * H * (hdv + 2))
    copies = cold_copies((q, k, q_pos, kv_pos), sum(t.numel() * t.element_size() for t in (q, k)))
    turns = [time_ms(lambda q_, k_, qp, kp: fa.flash_attention_partial(
        q_, k_, k_[..., :hdv], qp, kp, scale=scale), copies, label=f"the MLA forward [{name}]")
        for _ in range(2)]
    plain_ms = time_ms(lambda q_, k_, qp, kp: ref.attention_partial_ref(
        q_, k_, k_[..., :hdv], qp, kp, scale=scale), copies, reps=len(copies),
        label=f"the plain MLA forward [{name}]")
    mask = vis[:, None]
    backend = sdpa_backend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask)

    def sdpa(q_, k_, *_):
        return F.scaled_dot_product_attention(q_.transpose(1, 2), k_.transpose(1, 2),
                                              k_[..., :hdv].transpose(1, 2), attn_mask=mask,
                                              scale=scale, enable_gqa=True)

    try:
        lib_ms = time_ms(sdpa, copies, label=f"sdpa [{name}]")
    except RuntimeError as err:
        print(f"  note: sdpa takes no MLA shape [{name}]: {str(err)[:200]}")
        lib_ms, backend = None, "none"
    b_ms, b_by = bound(ops, n_bytes)
    rows = {"fwd": {"shape": f"MLA {name}", "q": list(q.shape), "kv": list(k.shape),
                    "v": "k[..., :512]", "dtype": str(q.dtype), "kernels": "tensor_cores (wide)",
                    "nsplit": fwd_nsplit(fa, "tensor_cores", q, k, v), "max_abs_err": fwd_err,
                    "ms": sum(turns) / len(turns), "ms_turns": turns, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                    "library": f"sdpa ({backend})", "ops": ops, "bytes": n_bytes}}
    f = rows["fwd"]
    print(f"MLA fwd [{name}] q {tuple(q.shape)} kv {tuple(k.shape)} v k[..., :512]: tensor cores "
          f"{f['ms']:.4f} ms (turns {', '.join(f'{t:.4f}' for t in turns)}; err {fwd_err:.3e}; "
          f"{f['nsplit']} KV splits), plain {plain_ms:.4f} ms, sdpa ({backend}) "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound {b_ms:.4f} ms ({b_by}, "
          f"{ops:.3e} ops, {n_bytes:.3e} bytes)")
    if do is None:
        return rows
    err, rel, _ = bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, None, do, dl, scale=scale)
    _, m, _ = ref.attention_partial_ref(q, k, v, q_pos, kv_pos, scale=scale)
    copies = cold_copies((q, k, q_pos, kv_pos, do, m, dl),
                         sum(t.numel() * t.element_size() for t in (q, k, do)))

    def call(q_, k_, qp, kp, do_, m_, dl_):
        return fa.flash_attention_partial_bwd(q_, k_, k_[..., :hdv], qp, kp, do_, m_, dl_,
                                              scale=scale)

    for args in copies:
        call(*args)
    torch.cuda.synchronize()
    parts = {"dq": BWD_GROUPS["dq_tc"], "dkv": BWD_GROUPS["dkv_tc"]}
    bturns = {part: [] for part in parts}
    for _ in range(2):
        _, by_group = profiled_ms(call, copies, reps=3, want=list(parts.values()))
        for part, group in parts.items():
            bturns[part].append(by_group[group])
    check(all(t > 0 for ts in bturns.values() for t in ts),
          f"the profiler missed an MLA backward kernel at [{name}]: {bturns}")
    plain_bwd = time_ms(lambda q_, k_, qp, kp, do_, m_, dl_: ref.attention_partial_bwd_ref(
        q_, k_, k_[..., :hdv], qp, kp, None, do_, m_, dl_, scale=scale), copies,
        reps=len(copies), label=f"the plain MLA backward [{name}]")
    graphs = []
    for cq, ck, *_rest in copies:
        lq, lk = cq.detach().requires_grad_(), ck.detach().requires_grad_()
        out = sdpa(lq, lk)
        graphs.append((out, [lq, lk], torch.randn_like(out)))
    lib_bwd = time_ms(lambda out, leaves, g: torch.autograd.grad(out, leaves, g, retain_graph=True),
                      graphs, reps=3, label=f"the sdpa MLA backward [{name}]")
    del graphs
    rows_in = live_rows * H * (esz * hdk + 4 * (hdv + 2)) + kv_rows * Hkv * esz * hdk + pos_bytes
    for part, n_ops, out_bytes in (
            ("dq", 2 * H * n_vis * (hdk + hdv + hdk), 4 * B * Tq * H * hdk),
            ("dkv", 2 * H * n_vis * (hdk + hdv + hdk + hdv), 4 * B * S * Hkv * (hdk + hdv))):
        b_ms, b_by = bound(n_ops, rows_in + out_bytes)
        rows[part] = {"shape": f"MLA {name}", "q": list(q.shape), "kv": list(k.shape),
                      "dtype": str(q.dtype), "kernels": "tensor_cores (wide)",
                      "ms": sum(bturns[part]) / len(bturns[part]), "ms_turns": bturns[part],
                      "plain_ms": plain_bwd, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_bwd, "library": f"sdpa backward ({backend})",
                      "ops": n_ops,
                      "max_abs_err": err["dq"] if part == "dq" else max(err["dk"], err["dv"]),
                      "rel_err": rel["dq"] if part == "dq" else max(rel["dk"], rel["dv"])}
    a, b = rows["dq"], rows["dkv"]
    print(f"MLA bwd [{name}]: dq {a['ms']:.3f} ms (turns "
          f"{', '.join(f'{t:.3f}' for t in a['ms_turns'])}; rel err {a['rel_err']:.2e}), dk/dv "
          f"{b['ms']:.3f} ms (turns {', '.join(f'{t:.3f}' for t in b['ms_turns'])}; rel err "
          f"{b['rel_err']:.2e}); plain {plain_bwd:.3f} ms, sdpa backward ({backend}) "
          f"{lib_bwd:.3f} ms; bounds {a['bound_ms']:.4f} / {b['bound_ms']:.4f} ms "
          f"({a['bound_by']}, {b['bound_by']})")
    return rows


def mla_kernel_shapes(fa, ref, gen, runner, cfg, scale):
    """(a) The wide kernels at deepseek-v3's main-path shapes: a serving
    prefill chunk (Tq 128 over a 2048-slot prefix view of the latent cache,
    B 4), a decode step (Tq 1 over the whole cache buffer, its PAD tail),
    and the train cell's first and last chunks (S 8192 in 4 FLOPs-balanced
    chunks, B 1), forward and backward.  Returns the rows by shape."""
    from repro_torch.configs.base import ShapeConfig

    dev, bf16, H, w = "cuda", torch.bfloat16, cfg.n_heads, cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim
    pre = runner.resolve_cell(dataclasses.replace(cfg, n_layers=MLA_SERVE_LAYERS),
                              ShapeConfig("mla_prefill", PREFILL_LEN, BATCH, "prefill"),
                              overrides=dict(pp=1, dp=1, n_chunks=PREFILL_LEN // 64,
                                             offload=False, remat="none"))
    cache = pre.cache_loc
    kbuf = torch.randn(BATCH, cache, 1, w, generator=gen, device=dev).to(bf16)
    pos = torch.arange(cache, dtype=torch.int32, device=dev)
    rows = {}
    q = torch.randn(BATCH, 128, H, w, generator=gen, device=dev).to(bf16)
    rows["prefill chunk"] = measure_mla_shape(
        "prefill chunk", fa, ref, q, kbuf[:, :PREFILL_LEN],
        PREFILL_LEN - 128 + torch.arange(128, dtype=torch.int32, device=dev), pos[:PREFILL_LEN],
        scale)
    q = torch.randn(BATCH, 1, H, w, generator=gen, device=dev).to(bf16)
    rows["decode step"] = measure_mla_shape(
        "decode step", fa, ref, q, kbuf, torch.full((1,), PREFILL_LEN, dtype=torch.int32, device=dev),
        torch.where(pos <= PREFILL_LEN, pos, PAD).to(torch.int32), scale)
    del kbuf
    cell = runner.resolve_cell(dataclasses.replace(cfg, n_layers=MLA_TRAIN_LAYERS),
                               ShapeConfig("mla_train", MLA_SEQ, 1, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=MLA_CHUNKS, offload=False,
                                              remat="none"), dtype=bf16)
    kbuf = torch.randn(1, MLA_SEQ, 1, w, generator=gen, device=dev).to(bf16)
    pos = torch.arange(MLA_SEQ, dtype=torch.int32, device=dev)
    for name, c in (("train first chunk", 0), ("train last chunk", cell.sched.n - 1)):
        off, ln = cell.sched.offsets[c], cell.sched.lengths[c]
        q = torch.randn(1, ln, H, w, generator=gen, device=dev).to(bf16)
        do = torch.randn(1, ln, H, 512, generator=gen, device=dev)
        dl = torch.randn(1, ln, H, generator=gen, device=dev)
        rows[name] = measure_mla_shape(name, fa, ref, q, kbuf[:, :off + ln], pos[off:off + ln],
                                       pos[:off + ln], scale, do, dl)
        del q, do, dl
        torch.cuda.empty_cache()
    return rows, list(cell.sched.lengths)


def mla_serve(fa, hostmem, serve, cfg, card):
    """(b) deepseek-v3-671b served at full width, MLA_SERVE_LAYERS layers,
    bf16, through the serve CLI's entry point: random weights from seed 0,
    B 4, a 2048-token prompt in 16 chunks of 128, 32 decode steps, twice.
    The tensor-core forward launches layers x (16 + 32) times a run (the
    decode calls splitting their KV range and merging it in the launch),
    nothing else, no host copy."""
    fa.reset_counts()
    hostmem.reset_counts()
    out = serve.main(["--arch", MLA_ARCH, "--layers", str(MLA_SERVE_LAYERS),
                      "--prompt-len", str(PREFILL_LEN), "--batch", str(BATCH),
                      "--decode-steps", str(DECODE_STEPS), "--repeats", str(MLA_REPEATS)])
    counts = fa.counts()
    check(not any(hostmem.counts().values()),
          f"[{MLA_ARCH}] serving copied to or from host memory: {hostmem.counts()}")
    n_chunks = out["n_chunks"]
    check(n_chunks == 16, f"[{MLA_ARCH}] prefill ran {n_chunks} chunks, expected 16")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    clen, cache = PREFILL_LEN // n_chunks, PREFILL_LEN + 128
    splits = (sum(fa._tc_wide_geometry(BATCH, clen, (c + 1) * clen, cfg.n_heads, 1, n_sm)[0] > 1
                  for c in range(n_chunks))
              + DECODE_STEPS * (fa._tc_wide_geometry(BATCH, 1, cache, cfg.n_heads, 1, n_sm)[0] > 1))
    want = {**{k: 0 for k in counts},
            "fwd_tc": MLA_REPEATS * MLA_SERVE_LAYERS * (n_chunks + DECODE_STEPS),
            "merged_in_kernel": MLA_REPEATS * MLA_SERVE_LAYERS * splits}
    check(counts == want, f"[{MLA_ARCH}] serving launched {counts}, expected {want}")
    toks = out["tokens"]
    check(toks.shape == (BATCH, DECODE_STEPS)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"[{MLA_ARCH}] decoded tokens {toks.shape} out of range")
    check(bool(torch.isfinite(out["last_hidden"]).all()), f"[{MLA_ARCH}] hidden not finite")
    runs = []
    for run, (p_s, d_s) in enumerate(zip(out["prefill_s_runs"], out["decode_s_runs"])):
        runs.append({"prefill_s": p_s, "prefill_tokens_per_s": BATCH * PREFILL_LEN / p_s,
                     "decode_ms_per_step": 1e3 * d_s / DECODE_STEPS,
                     "decode_tokens_per_s": BATCH * DECODE_STEPS / d_s})
        print(f"serve [{MLA_ARCH}] run {run} ({card}): {MLA_SERVE_LAYERS} of {cfg.n_layers} "
              f"layers at full width, bf16: prefill {p_s:.4f} s, "
              f"{runs[-1]['prefill_tokens_per_s']:.1f} tokens/s; decode "
              f"{runs[-1]['decode_ms_per_step']:.3f} ms/step, "
              f"{runs[-1]['decode_tokens_per_s']:.1f} tokens/s")
    print(f"serve [{MLA_ARCH}] launches {counts} (expected {want}); peak "
          f"{out['peak_bytes'] / 2**30:.3f} GiB ({card})")
    return counts, {"runs": runs, "peak_bytes": out["peak_bytes"]}


def _bits_sum(t) -> int:
    """A checksum of a tensor's bits, summed a slice at a time (a 7.5 GB
    expert gradient is never widened whole)."""
    bits = t.detach().reshape(-1).view(torch.int16 if t.element_size() == 2 else torch.int32)
    return int(sum(int(part.sum(dtype=torch.int64)) for part in bits.split(1 << 26)))


def mla_grads(fa, hostmem, serve, runner, cfg, card):
    """(c) deepseek-v3-671b's loss and gradients at full width,
    MLA_TRAIN_LAYERS layer, S 8192 in 4 chunks, bf16, under plans (d) (the
    default: offload on, remat "sppo", prefetch "ahead") and (b) (offload
    off, remat "sppo"), MLA_GRAD_CALLS calls each on the same seed-0
    weights and step-0 tokens: the losses bitwise equal across plans and
    calls, the tensor-core forward launched 8 times a call (each chunk and
    its replay), dq and dk/dv 4 times each, nothing else, D2H = H2D at the
    closed form of MLA's and the MoE block's tag shapes under (d) and no
    copy under (b); each call's peak over its weights beside
    MLA_GRAD_PEAK_PREDICTED_GIB."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM

    cfg1 = dataclasses.replace(cfg, n_layers=MLA_TRAIN_LAYERS)
    shape = ShapeConfig("mla_train", MLA_SEQ, 1, "train")
    cells = {"d": runner.resolve_cell(cfg1, shape, overrides=dict(pp=1, dp=1, n_chunks=MLA_CHUNKS),
                                      dtype=torch.bfloat16),
             "b": runner.resolve_cell(cfg1, shape, overrides=dict(
                 pp=1, dp=1, n_chunks=MLA_CHUNKS, **PLANS["b"][1]), dtype=torch.bfloat16)}
    for plan, cell in cells.items():
        check((cell.plan.offload, cell.plan.remat, cell.plan.prefetch if cell.plan.offload
               else None) == PLAN_FORM[plan], f"[{MLA_ARCH}] plan ({plan}) resolved to {cell.plan}")
    t0 = time.perf_counter()
    params = serve.build_params(cells["d"], "cuda", seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    tokens, labels = (torch.from_numpy(a).cuda()
                      for a in SyntheticLM(cfg.vocab_size, MLA_SEQ, 1).sample_step(0))
    weights = torch.cuda.memory_allocated()
    paths, calls = {}, []
    for plan in ("d", "b") * MLA_GRAD_CALLS:
        cell = cells[plan]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fa.reset_counts()
        hostmem.reset_counts()
        t0 = time.perf_counter()
        loss, grads = runner.loss_and_grads(cell, params, tokens, labels)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts, copied = fa.counts(), hostmem.counts()
        peak = torch.cuda.max_memory_allocated() - base
        leaves = tree.leaves(grads)
        finite = all(bool(torch.isfinite(g).all()) for g in leaves if g.numel() < 2**28)
        sums = [_bits_sum(g) for g in leaves]
        calls.append({"plan": plan, "loss": float(loss), "seconds": secs, "peak_bytes": peak,
                      "grad_bits": sums})
        del grads, leaves
        want = {**{k: 0 for k in counts}, "fwd_tc": 2 * MLA_CHUNKS * MLA_TRAIN_LAYERS,
                "bwd_dq_tc": MLA_CHUNKS * MLA_TRAIN_LAYERS, "bwd_dkv_tc": MLA_CHUNKS * MLA_TRAIN_LAYERS}
        check(counts == want, f"[{MLA_ARCH}] plan ({plan}) launched {counts}, expected {want}")
        n_bytes = offload_bytes(cell) if cell.plan.offload else 0
        check(copied["d2h_bytes"] == copied["h2d_bytes"] == n_bytes
              and copied["d2h_pinned"] == copied["d2h"],
              f"[{MLA_ARCH}] plan ({plan}) copied {copied}, expected {n_bytes} pinned bytes each way")
        check(finite and math.isfinite(calls[-1]["loss"]),
              f"[{MLA_ARCH}] plan ({plan}): loss {calls[-1]['loss']} or gradients not finite")
        print(f"train [{MLA_ARCH}] plan ({plan}) loss and gradients ({card}): {MLA_TRAIN_LAYERS} "
              f"layer at full width, S {MLA_SEQ} in chunks {cell.sched.lengths}, alpha "
              f"{[round(a, 4) for a in cell.alphas]}: loss {float(loss)!r}, {secs:.3f} s; launches "
              f"{ {k: v for k, v in counts.items() if v} }; D2H {copied['d2h_bytes']} = H2D "
              f"{copied['h2d_bytes']} bytes (closed form {n_bytes}); peak over the weights "
              f"{peak / 2**30:.3f} GiB (predicted {MLA_GRAD_PEAK_PREDICTED_GIB} GiB; weights "
              f"{weights / 2**30:.3f} GiB)")
        paths[f"train_mla_plan_{plan}"] = counts
    losses = [c["loss"] for c in calls]
    check(len(set(losses)) == 1, f"[{MLA_ARCH}] losses differ across plans and calls: {losses}")
    same_grads = all(c["grad_bits"] == calls[0]["grad_bits"] for c in calls)
    print(f"train [{MLA_ARCH}] plans (d) and (b), {MLA_GRAD_CALLS} calls each: losses bitwise "
          f"equal ({losses[0]!r}); gradient bit sums {'equal' if same_grads else 'differ'} "
          f"across the calls; weights built in {build_s:.1f} s")
    del params
    torch.cuda.empty_cache()
    return paths, {"calls": [{k: v for k, v in c.items() if k != "grad_bits"} for c in calls],
                   "grad_bits_equal": same_grads, "weights_bytes": weights,
                   "chunks": list(cells["d"].sched.lengths), "alphas": list(cells["d"].alphas)}


def mla_cpu_check(fa, hostmem, serve, runner, cfg, card):
    """(d) The reduced deepseek-v3 (hd_k 24, hd_v 16, G 4: the CUDA-core
    kernels) in fp32 on the card and on the CPU from the same weights: one
    2-layer train step at S = 256 in 2 chunks under the default plan (chunk
    0 offloads every tagged row) with AdamW's bf16 moments in host memory:
    the loss, the gradient norm and every parameter's update within
    GRAD_REL_TOL (relative); the launches by their closed forms; then a
    prefill and CHECK_DECODE decode steps: the card's tokens the CPU's
    (a tie under TIE_GAP excepted)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model_zoo import ModelDef

    rcfg = cfg.reduced()
    S = CHECK_SEQ
    cell = runner.resolve_cell(rcfg, ShapeConfig("mla_check", S, 1, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=2), dtype=torch.float32)
    check(cell.plan.opt_dtype == "bfloat16" and cell.plan.offload_moments,
          f"[{MLA_ARCH}] reduced plan {cell.plan}: expected bf16 moments in host memory")
    cell = dataclasses.replace(cell, alphas=(1.0, 0.0))
    tokens, labels = (torch.from_numpy(a) for a in SyntheticLM(rcfg.vocab_size, S, 1).sample_step(0))
    start = serve.build_params(cell, "cpu", seed=0)
    step = runner.make_train_step(cell, lr_kwargs=dict(peak=1e-3, warmup=1, total=10))
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.clone().to(dev), start)
        opt = runner.init_opt_state(cell, params)
        fa.reset_counts()
        hostmem.reset_counts()
        params, opt, met = step(params, opt, tokens.to(dev), labels.to(dev))
        out[dev] = {"loss": float(met["loss"]), "gnorm": float(met["grad_norm"]),
                    "params": {p: t.cpu() for p, t in tree.items(params)},
                    "m": [t.float().cpu() for t in tree.leaves(opt.m)],
                    "counts": fa.counts(), "copied": hostmem.counts()}
        del params, opt
    card_o, cpu_o = out["cuda"], out["cpu"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    G = rcfg.n_heads
    splits = sum(fa._geometry(1, ln, off + ln, G, 1, n_sm)[2] > 1
                 for off, ln in zip(cell.sched.offsets, cell.sched.lengths))
    want = {**{k: 0 for k in card_o["counts"]}, "fwd": 4 * rcfg.n_layers, "merge": 2 * rcfg.n_layers * splits,
            "bwd_dq": 2 * rcfg.n_layers, "bwd_dkv": 2 * rcfg.n_layers}
    check(card_o["counts"] == want,
          f"[{MLA_ARCH}] the reduced fp32 step launched {card_o['counts']}, expected {want}")
    check(card_o["copied"]["d2h_pinned"] == card_o["copied"]["d2h"] > 0
          and card_o["copied"]["moment_d2h_pinned"] == card_o["copied"]["moment_d2h"] > 0,
          f"[{MLA_ARCH}] the reduced step's copies {card_o['copied']}: expected pinned row and "
          "moment copies")
    rel = {"loss": abs(card_o["loss"] - cpu_o["loss"]) / abs(cpu_o["loss"]),
           "grad_norm": abs(card_o["gnorm"] - cpu_o["gnorm"]) / abs(cpu_o["gnorm"])}
    worst_upd, start = 0.0, dict(tree.items(start))
    for p, t in card_o["params"].items():
        d_card, d_cpu = t - start[p], cpu_o["params"][p] - start[p]
        if d_cpu.norm() > 0:
            worst_upd = max(worst_upd, ((d_card - d_cpu).norm() / d_cpu.norm()).item())
    rel["update"] = worst_upd
    m_rel = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                for a, b in zip(card_o["m"], cpu_o["m"]))
    print(f"train [{MLA_ARCH}] reduced 2-layer fp32 step ({card}), default plan, bf16 moments in "
          f"host memory: loss card {card_o['loss']:.6f} vs CPU {cpu_o['loss']:.6f}; relative "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f" (worst parameter's update); first moments (bf16) relative L2 {m_rel:.3e}; "
          f"launches {card_o['counts']}")
    check(all(v <= GRAD_REL_TOL for v in rel.values()),
          f"[{MLA_ARCH}] the reduced step disagrees card vs CPU: {rel} (tol {GRAD_REL_TOL})")
    # serving: a prefill and decode steps, card against CPU
    pre = runner.resolve_cell(rcfg, ShapeConfig("mla_fp32", S, BATCH, "prefill"),
                              overrides=dict(pp=1, dp=1, n_chunks=S // 64, offload=False,
                                             remat="none"), dtype=torch.float32)
    dec = runner.resolve_cell(rcfg, ShapeConfig("mla_fp32", S, BATCH, "decode"),
                              overrides=dict(pp=1, dp=1), dtype=torch.float32)
    params = serve.build_params(pre, "cpu", seed=0)
    prompts = np.random.default_rng(1).integers(2, rcfg.vocab_size, size=(BATCH, S)).astype(np.int32)
    got = static_decode(runner, pre, dec, tree_map(lambda t: t.cuda(), params), prompts,
                        CHECK_DECODE, "cuda")
    gaps = []
    with recorded_gaps(ModelDef, gaps):
        want_toks = static_decode(runner, pre, dec, params, prompts, CHECK_DECODE, "cpu")
    ties = held_against_cpu(got, want_toks, np.stack(gaps, axis=1), f"{MLA_ARCH} reduced fp32 serve")
    print(f"serve [{MLA_ARCH}] reduced fp32 ({card}): {BATCH} rows, prefill {S}, "
          f"{CHECK_DECODE} decode steps: tokens as the CPU's ({len(ties)} ties)")
    return rel, card_o["counts"], {"step_rel": rel, "moment_rel_l2": m_rel, "serve_ties": ties}


def mla_phase(fa, hostmem, serve, runner, ref, card):
    """MLA, deepseek-v3-671b: (a) the three wide tensor-core kernels at its
    shapes, its edge grid; (b) serving at full width, 2 layers; (c) loss and
    gradients at full width, 1 layer, plans (d) and (b); (d) the reduced
    model in fp32 against the CPU.  Returns (launch counts by path, rows for
    the kernels line, summary)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.attention import mla_scale

    t0 = time.perf_counter()
    cfg = get_config(MLA_ARCH)
    scale = mla_scale(cfg)
    gen = torch.Generator(device="cuda").manual_seed(25)
    fwd_err, bwd_rel, n_cases = mla_edge_grid(fa, ref, gen, scale)
    print(f"MLA edge grid: {n_cases} cases (bf16, the wide tensor-core kernels) forward within "
          f"{KERNEL_TOL} (worst {fwd_err:.3e}), backward within {KERNEL_TOL} x max |plain| (worst "
          f"relative {bwd_rel:.3e}), dead rows exact")
    rows, chunks = mla_kernel_shapes(fa, ref, gen, runner, cfg, scale)
    torch.cuda.empty_cache()
    t_a = time.perf_counter()
    serve_counts, serve_summary = mla_serve(fa, hostmem, serve, cfg, card)
    torch.cuda.empty_cache()
    t_b = time.perf_counter()
    grad_counts, grad_summary = mla_grads(fa, hostmem, serve, runner, cfg, card)
    t_c = time.perf_counter()
    check_rel, check_counts, check_summary = mla_cpu_check(fa, hostmem, serve, runner, cfg, card)
    t_d = time.perf_counter()
    seconds = {"kernels": t_a - t0, "serve": t_b - t_a, "grads": t_c - t_b, "cpu_check": t_d - t_c,
               "total": t_d - t0}
    print(f"MLA phase took {t_d - t0:.1f} s ({json.dumps({k: round(v, 1) for k, v in seconds.items()})})")
    counts = {"serve_mla": serve_counts, **grad_counts, "train_mla_fp32": check_counts}
    summary = {"edge_grid": {"fwd_max_abs_err": fwd_err, "bwd_max_rel_err": bwd_rel,
                             "cases": n_cases},
               "train_chunks": chunks, "serve": serve_summary, "grads": grad_summary,
               "cpu_check": check_summary, "seconds": seconds}
    return counts, rows, summary


# ---------------------------------------------------------------------------
# The SSM family: rwkv6-3b (RWKV6, no attention) and zamba2-7b (Mamba2
# mixers and the weight-shared attention block at hd 112, G 1)
# ---------------------------------------------------------------------------


def ssm_serve(fa, hostmem, serve, arch, card):
    """(a) ``arch`` served at full width and full depth through the serve
    CLI's entry point, bf16, SSM_REPEATS runs of B 4, a 2048-token prompt in
    16 chunks and 32 decode steps, the decode loop under sync-debug "error"
    (a call that makes the host wait raises).  rwkv6-3b launches no kernel;
    zamba2-7b the tensor-core forward 14 x (16 + 32) times a run, the calls
    whose KV range the geometry splits merging in the launch; no host copy."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model_zoo import build_model

    cfg = get_config(arch)
    n_attn = attention_layers(cfg)
    fa.reset_counts()
    hostmem.reset_counts()
    out = serve.main(["--arch", arch, "--prompt-len", str(PREFILL_LEN), "--batch", str(BATCH),
                      "--decode-steps", str(DECODE_STEPS), "--repeats", str(SSM_REPEATS),
                      "--sync-debug", "error"])
    counts = fa.counts()
    check(not any(hostmem.counts().values()),
          f"[{arch}] serving copied to or from host memory: {hostmem.counts()}")
    n_chunks = out["n_chunks"]
    check(n_chunks == 16, f"[{arch}] prefill ran {n_chunks} chunks, expected 16")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    G, Hkv = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads
    clen, cache = PREFILL_LEN // n_chunks, PREFILL_LEN + 128
    splits = (sum(fa._tc_geometry(BATCH, clen, (c + 1) * clen, G, Hkv, n_sm)[2] > 1
                  for c in range(n_chunks))
              + DECODE_STEPS * (fa._tc_geometry(BATCH, 1, cache, G, Hkv, n_sm)[2] > 1))
    want = {**{k: 0 for k in counts},
            "fwd_tc": SSM_REPEATS * n_attn * (n_chunks + DECODE_STEPS),
            "merged_in_kernel": SSM_REPEATS * n_attn * splits}
    check(counts == want, f"[{arch}] serving launched {counts}, expected {want}")
    check(build_model(cfg).n_slots == {"rwkv6-3b": 32, "zamba2-7b": 14}[arch],
          f"[{arch}] built {build_model(cfg).n_slots} slots")
    toks = out["tokens"]
    check(toks.shape == (BATCH, DECODE_STEPS)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"[{arch}] decoded tokens {toks.shape} out of range")
    check(bool(torch.isfinite(out["last_hidden"]).all()), f"[{arch}] hidden not finite")
    runs = []
    for run, (p_s, d_s) in enumerate(zip(out["prefill_s_runs"], out["decode_s_runs"])):
        runs.append({"prefill_s": p_s, "prefill_tokens_per_s": BATCH * PREFILL_LEN / p_s,
                     "decode_ms_per_step": 1e3 * d_s / DECODE_STEPS,
                     "decode_tokens_per_s": BATCH * DECODE_STEPS / d_s})
        print(f"serve [{arch}] run {run} ({card}): {cfg.n_layers} layers at full width, bf16: "
              f"prefill {p_s:.4f} s, {runs[-1]['prefill_tokens_per_s']:.1f} tokens/s; decode "
              f"{runs[-1]['decode_ms_per_step']:.3f} ms/step, "
              f"{runs[-1]['decode_tokens_per_s']:.1f} tokens/s")
    print(f"serve [{arch}] launches {counts} (expected {want}), no host sync in the decode "
          f"loop; peak {out['peak_bytes'] / 2**30:.3f} GiB ({card})")
    return counts, {"runs": runs, "peak_bytes": out["peak_bytes"]}


def ssm_cpu_check(fa, hostmem, serve, runner, arch, card):
    """(c) The reduced config in fp32 (2 RWKV6 layers, or 2 zamba2 groups:
    hd 16, G 2, the CUDA-core kernels), the same weights on the card and on
    the CPU: one train step at S 256 in 2 chunks under the default plan
    (chunk 0 offloads every tagged row): the loss, the gradient norm, every
    gradient leaf (``loss_and_grads``, relative L2) and every parameter's
    update within GRAD_REL_TOL (relative), the launches by their closed
    forms, pinned copies; then a prefill and CHECK_DECODE decode steps:
    the card's tokens the CPU's (a tie under TIE_GAP excepted).  AdamW's
    first update is g / (|g| + eps) an element, the sign of g wherever |g|
    >> eps, so the update is held over the elements whose CPU gradient is
    over 1e-3 x its leaf's max |g| (ten times GRAD_REL_TOL); below that the
    sign is set by rounding, and the update over every element is printed
    beside it."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model_zoo import ModelDef

    rcfg = get_config(arch).reduced(n_layers=SSM_CHECK_LAYERS[arch])
    S = CHECK_SEQ
    cell = runner.resolve_cell(rcfg, ShapeConfig("ssm_check", S, 1, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=2), dtype=torch.float32)
    check(cell.plan.offload and cell.plan.remat == "sppo",
          f"[{arch}] reduced plan {cell.plan}: expected the default plan")
    cell = dataclasses.replace(cell, alphas=(1.0, 0.0))
    tokens, labels = (torch.from_numpy(a) for a in SyntheticLM(rcfg.vocab_size, S, 1).sample_step(0))
    start = serve.build_params(cell, "cpu", seed=0)
    step = runner.make_train_step(cell, lr_kwargs=dict(peak=1e-3, warmup=1, total=10))
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.clone().to(dev), start)
        _, grads = runner.loss_and_grads(cell, params, tokens.to(dev), labels.to(dev))
        grads = {p: g.cpu() for p, g in tree.items(grads)}
        opt = runner.init_opt_state(cell, params)
        fa.reset_counts()
        hostmem.reset_counts()
        params, opt, met = step(params, opt, tokens.to(dev), labels.to(dev))
        out[dev] = {"loss": float(met["loss"]), "gnorm": float(met["grad_norm"]),
                    "params": {p: t.cpu() for p, t in tree.items(params)}, "grads": grads,
                    "counts": fa.counts(), "copied": hostmem.counts()}
        del params, opt
    card_o, cpu_o = out["cuda"], out["cpu"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_attn = attention_layers(rcfg)
    G, Hkv = rcfg.n_heads // rcfg.n_kv_heads, rcfg.n_kv_heads
    splits = sum(fa._geometry(1, ln, off + ln, G, Hkv, n_sm)[2] > 1
                 for off, ln in zip(cell.sched.offsets, cell.sched.lengths))
    want = {**{k: 0 for k in card_o["counts"]}, "fwd": 4 * n_attn, "merge": 2 * n_attn * splits,
            "bwd_dq": 2 * n_attn, "bwd_dkv": 2 * n_attn}
    check(card_o["counts"] == want,
          f"[{arch}] the reduced fp32 step launched {card_o['counts']}, expected {want}")
    n_bytes = 4 * ssm_offload_elems(cell)
    check(card_o["copied"]["d2h_bytes"] == card_o["copied"]["h2d_bytes"] == n_bytes
          and card_o["copied"]["d2h_pinned"] == card_o["copied"]["d2h"] > 0,
          f"[{arch}] the reduced step copied {card_o['copied']}, expected {n_bytes} pinned "
          "bytes each way")
    rel = {"loss": abs(card_o["loss"] - cpu_o["loss"]) / abs(cpu_o["loss"]),
           "grad_norm": abs(card_o["gnorm"] - cpu_o["gnorm"]) / abs(cpu_o["gnorm"])}
    worst = {"grad": (0.0, None), "update": (0.0, None), "update_all": (0.0, None)}
    start = dict(tree.items(start))
    for p, t in card_o["params"].items():
        g_card, g_cpu = card_o["grads"][p], cpu_o["grads"][p]
        d_card, d_cpu = t - start[p], cpu_o["params"][p] - start[p]
        sure = g_cpu.abs() > 1e-3 * g_cpu.abs().max()
        for key, a, b in (("grad", g_card, g_cpu), ("update", d_card[sure], d_cpu[sure]),
                          ("update_all", d_card, d_cpu)):
            if b.norm() > 0:
                worst[key] = max(worst[key], (((a - b).norm() / b.norm()).item(), p),
                                 key=lambda v: v[0])
    rel.update({k: v[0] for k, v in worst.items() if k != "update_all"})
    print(f"train [{arch}] reduced fp32 step ({card}), {rcfg.n_layers} layers, default plan: "
          f"loss card {card_o['loss']:.6f} vs CPU {cpu_o['loss']:.6f}; relative "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f" (worst leaves: gradient {worst['grad'][1]}, update {worst['update'][1]}); the "
          f"update over every element {worst['update_all'][0]:.3e} ({worst['update_all'][1]}); "
          f"launches {card_o['counts']}; D2H {n_bytes} bytes")
    check(all(v <= GRAD_REL_TOL for v in rel.values()),
          f"[{arch}] the reduced step disagrees card vs CPU: {rel} (tol {GRAD_REL_TOL})")
    pre = runner.resolve_cell(rcfg, ShapeConfig("ssm_fp32", S, BATCH, "prefill"),
                              overrides=dict(pp=1, dp=1, n_chunks=S // 64, offload=False,
                                             remat="none"), dtype=torch.float32)
    dec = runner.resolve_cell(rcfg, ShapeConfig("ssm_fp32", S, BATCH, "decode"),
                              overrides=dict(pp=1, dp=1), dtype=torch.float32)
    params = serve.build_params(pre, "cpu", seed=0)
    prompts = np.random.default_rng(1).integers(2, rcfg.vocab_size, size=(BATCH, S)).astype(np.int32)
    fa.reset_counts()
    got = static_decode(runner, pre, dec, tree_map(lambda t: t.cuda(), params), prompts,
                        CHECK_DECODE, "cuda")
    serve_counts = fa.counts()
    gaps = []
    with recorded_gaps(ModelDef, gaps):
        want_toks = static_decode(runner, pre, dec, params, prompts, CHECK_DECODE, "cpu")
    ties = held_against_cpu(got, want_toks, np.stack(gaps, axis=1), f"{arch} reduced fp32 serve")
    print(f"serve [{arch}] reduced fp32 ({card}): {BATCH} rows, prefill {S}, "
          f"{CHECK_DECODE} decode steps: tokens as the CPU's ({len(ties)} ties); launches "
          f"{serve_counts}")
    return card_o["counts"], {"step_rel": rel, "update_all_rel": worst["update_all"][0],
                              "serve_ties": ties}


def ssm_phase(fa, hostmem, serve, runner, train_mod, card):
    """The SSM family (ROADMAP Queue 1 item 7(e)): (a) rwkv6-3b and
    zamba2-7b served at full width and depth; (b) trained at full width cut
    in depth, plans (d) and (b), the losses bitwise equal at every step and
    D2H = H2D at the closed form of the SSM tag shapes (``train_plan``:
    launches, copies; the idle share from (d)'s profiled last step); (c) the reduced
    configs in fp32 against the CPU.  Returns (launch counts by path, a
    summary)."""
    from repro_torch.configs.base import get_config

    t_phase = time.perf_counter()
    paths, summary = {}, {"seconds": {}}
    for arch in SSM_ARCHS:
        key = arch.split("-")[0]
        t0 = time.perf_counter()
        paths[f"serve_{key}"], serve_sum = ssm_serve(fa, hostmem, serve, arch, card)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=SSM_TRAIN_LAYERS[arch])
        rows = {}
        for plan in ("d", "b"):
            paths[f"train_{key}_plan_{plan}"], rows[plan], _ = train_plan(
                fa, hostmem, serve, runner, train_mod, cfg, card, plan, seq=SSM_SEQ,
                n_chunks=SSM_CHUNKS, steps=SSM_STEPS, label=f"{arch} {cfg.n_layers} layers",
                grads="none", profiled=plan == "d")
            torch.cuda.empty_cache()
        check(rows["d"]["losses"] == rows["b"]["losses"],
              f"[{arch}] plans (d) and (b) losses differ: {rows['d']['losses']} vs "
              f"{rows['b']['losses']}, expected bitwise equal at every step")
        print(f"train [{arch}] plans (d) and (b): losses bitwise equal at every step "
              f"{rows['d']['losses']}")
        t2 = time.perf_counter()
        paths[f"train_{key}_fp32"], check_sum = ssm_cpu_check(fa, hostmem, serve, runner, arch,
                                                              card)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        summary[arch] = {"serve": serve_sum, "train": rows, "fp32_check": check_sum}
        summary["seconds"][arch] = {"serve": t1 - t0, "train": t2 - t1, "fp32_check": t3 - t2}
    summary["seconds"]["total"] = time.perf_counter() - t_phase
    print(f"SSM phase took {summary['seconds']['total']:.1f} s "
          f"({json.dumps({a: {k: round(v, 1) for k, v in d.items()} for a, d in summary['seconds'].items() if a != 'total'})})")
    return paths, summary


# ---------------------------------------------------------------------------
# The cross-attention families: llama-3.2-vision-11b (gated cross layers
# over stub patches) and whisper-tiny (a bidirectional encoder, cross
# attention in every decoder layer): the kernels' non-causal mode
# ---------------------------------------------------------------------------


def cross_inputs(gen, B, Tq, n_ctx, H, Hkv, hd, *, backward=False, self_kv=False):
    """The kernels' inputs at a cross-attention call as the path passes
    them: q [B, Tq, H, hd] bf16, the context's K/V [B, n_ctx, Hkv, hd],
    q_pos zeros (unread: causal=False), each context slot at its index, no
    window; ``self_kv``: an encoder layer's, q_pos the frames' positions;
    ``backward``: fp32 do and dl beside."""
    dev, bf16 = "cuda", torch.bfloat16
    q = torch.randn(B, Tq, H, hd, generator=gen, device=dev).to(bf16)
    k = torch.randn(B, n_ctx, Hkv, hd, generator=gen, device=dev).to(bf16)
    v = torch.randn(B, n_ctx, Hkv, hd, generator=gen, device=dev).to(bf16)
    kv_pos = torch.arange(n_ctx, dtype=torch.int32, device=dev)
    q_pos = kv_pos[:Tq] if self_kv else torch.zeros(Tq, dtype=torch.int32, device=dev)
    if not backward:
        return q, k, v, q_pos, kv_pos, None
    do = torch.randn(B, Tq, H, hd, generator=gen, device=dev)
    dl = torch.randn(B, Tq, H, generator=gen, device=dev)
    return q, k, v, q_pos, kv_pos, do, dl


def xattn_edge_checks(fa, ref, gen):
    """Untimed, causal=False, at 1e-5 (backward 1e-5 x max |plain|): the
    VLM's cross decode step (B 4, G 4, hd 128) over 1600 patches and a
    64-slot PAD tail (the context padded to a model-axis multiple), batch
    row 1 with a PAD window (a dead row: o = l = 0, m = -1e30 exactly), both
    forwards; whisper's encoder shape (B 2, 1500 frames, 10 of them PAD past
    n_valid, G 1, hd 64) and a cross chunk with a dead row given NaN
    cotangents, both backward pairs (the dead row's dq exactly 0).  Returns
    (forward's worst error, backward's worst relative error)."""
    dev = "cuda"
    q, k, v, q_pos, _, _ = cross_inputs(gen, BATCH, 1, 1664, 32, 8, 128)
    kv_pos = torch.arange(1664, dtype=torch.int32, device=dev)
    kv_pos[1600:] = PAD
    q_start = torch.zeros(BATCH, 1, dtype=torch.int32, device=dev)
    q_start[1] = PAD
    fwd_err = 0.0
    for kind in FWD_KERNELS:
        err, (o, m, l) = kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, causal=False,
                                         kernels=kind)
        dead = ~visible_mask(BATCH, q_pos, kv_pos, q_start, causal=False).any(dim=-1)
        check_dead_rows(o, m, l, dead[..., None].expand(BATCH, 1, 32), 32,
                        f"cross decode with a dead row ({kind})")
        fwd_err = max(fwd_err, err)
    bwd_rel = 0.0
    for n_valid, Tq, self_kv in ((1490, 1500, True), (1500, 96, False)):
        q, k, v, q_pos, kv_pos, do, dl = cross_inputs(gen, 2, Tq, 1500, 6, 6, 64, backward=True,
                                                      self_kv=self_kv)
        kv_pos = torch.where(kv_pos < n_valid, kv_pos, PAD).to(torch.int32)
        if self_kv:
            q_pos = kv_pos
        q_start = torch.zeros(2, Tq, dtype=torch.int32, device=dev)
        q_start[1, -3:] = PAD
        dead = ~visible_mask(2, q_pos, kv_pos, q_start, causal=False).any(dim=-1)
        do[dead], dl[dead] = float("nan"), float("nan")
        for kernels in BWD_PAIRS:
            _, rel, (dq, _, _) = bwd_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, do, dl,
                                              causal=False, kernels=kernels)
            check(bool((dq[dead] == 0).all()), f"non-causal dead rows' dq is not exactly 0 "
                                               f"({kernels})")
            bwd_rel = max(bwd_rel, *rel.values())
    print(f"cross-attention edge checks (causal=False): PAD context tails, dead rows exact; "
          f"forward worst {fwd_err:.3e}, backward worst relative {bwd_rel:.3e}")
    return fwd_err, bwd_rel


def xattn_kernel_shapes(fa, ref, gen, runner):
    """The three kernels, non-causal, at the shapes the cross-attention
    families' main paths give them, held and timed (``measure_shape``,
    ``measure_bwd_shape``) beside their bounds and SDPA at the same mask:
    the VLM's cross layer (32 heads over 8, hd 128) at the serving prefill
    chunk (B 4, Tq 128 over 1600 patches), the decode step and the train
    cell's first chunk (B 1, S 8192 in 4 chunks, forward and backward);
    whisper's encoder (B 4, 1500 x 1500 frames, 6 heads, hd 64, G 1,
    forward and backward) and its cross attention at the serving prefill
    chunk, the decode step and the train cell's first chunk (B 4, forward
    and backward).  Then ``xattn_edge_checks``.  Returns (forward rows,
    backward rows, edge errors)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.models.model_zoo import build_model

    fwd, bwd = [], []
    for arch in XATTN_ARCHS:
        cfg = get_config(arch)
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        n_ctx = build_model(cfg).n_context()
        tag = arch.split("-")[0]
        fwd.append(measure_shape(f"{tag} cross prefill chunk", fa, ref,
                                 *cross_inputs(gen, BATCH, PREFILL_LEN // 16, n_ctx, H, Hkv, hd),
                                 causal=False))
        fwd.append(measure_shape(f"{tag} cross decode step", fa, ref,
                                 *cross_inputs(gen, BATCH, 1, n_ctx, H, Hkv, hd), causal=False))
        cell = runner.resolve_cell(
            dataclasses.replace(cfg, n_layers=XATTN_TRAIN_LAYERS[arch]),
            ShapeConfig("train", XATTN_SEQ, XATTN_TRAIN_BATCH[arch], "train"),
            overrides=dict(pp=1, dp=1, n_chunks=XATTN_CHUNKS))
        Tq, B = cell.sched.lengths[0], XATTN_TRAIN_BATCH[arch]
        q, k, v, q_pos, kv_pos, do, dl = cross_inputs(gen, B, Tq, n_ctx, H, Hkv, hd, backward=True)
        f, b = measure_bwd_shape(f"{tag} cross first chunk", fa, ref, q, k, v, q_pos, kv_pos,
                                 do, dl, causal=False)
        fwd.append(f)
        bwd.append(b)
        if cfg.encoder_layers:
            q, k, v, q_pos, kv_pos, do, dl = cross_inputs(gen, BATCH, n_ctx, n_ctx, H, Hkv, hd,
                                                          backward=True, self_kv=True)
            f, b = measure_bwd_shape(f"{tag} encoder", fa, ref, q, k, v, q_pos, kv_pos, do, dl,
                                     causal=False)
            fwd.append(f)
            bwd.append(b)
        del q, k, v, do, dl
        torch.cuda.empty_cache()
    edge = xattn_edge_checks(fa, ref, gen)
    torch.cuda.empty_cache()
    return fwd, bwd, edge


@contextlib.contextmanager
def gated(*modules):
    """Within the block, the ``build_params`` of each module (``launch.serve``
    and ``launch.train``, whose entry points draw their weights through
    ``serve.build_params``) sets every VLM slot's cross gates to
    XATTN_GATES after the seeded draw: at their init of 0 the cross layers
    add nothing and their leaves get no gradient."""
    origs = [m.build_params for m in modules]

    def build(*args, **kw):
        params = origs[0](*args, **kw)
        for slot in params["stages"]:
            for name, val in XATTN_GATES.items():
                if name in slot:
                    slot[name].fill_(val)
        return params

    for m in modules:
        m.build_params = build
    try:
        yield
    finally:
        for m, orig in zip(modules, origs):
            m.build_params = orig


def xattn_fwd_calls(cfg, B, chunks, cache, decode_steps):
    """The forward calls of one pass as (B, Tq, S) a call: {"chunked": each
    chunk (offset, length) of every self layer over its prefix and of every
    cross layer over the context; "encoder": the encoder's layers once over
    the frames; "decode": each decode step's self calls over the whole
    cache and cross calls over the context}."""
    from repro_torch.models.model_zoo import build_model

    n_ctx = build_model(cfg).n_context()
    if cfg.family == "vlm":
        groups = -(-cfg.n_layers // cfg.cross_attn.every)
        n_self, n_cross = groups * cfg.cross_attn.every, groups
    else:
        n_self = n_cross = cfg.n_layers
    chunked = []
    for off, ln in chunks:
        chunked += [(B, ln, off + ln)] * n_self + [(B, ln, n_ctx)] * n_cross
    return {"chunked": chunked, "encoder": [(B, n_ctx, n_ctx)] * cfg.encoder_layers,
            "decode": ([(B, 1, cache)] * n_self + [(B, 1, n_ctx)] * n_cross) * decode_steps}


def xattn_serve(fa, hostmem, serve, arch, card):
    """(a) ``arch`` served at full width and full depth through the serve
    CLI's entry point, bf16, the VLM's gates set (``gated``), XATTN_REPEATS
    runs of B 4, a 2048-token prompt in 16 chunks and 32 decode steps, the
    decode loop under sync-debug "error".  The tensor-core forward launched
    at its closed form (``xattn_fwd_calls``: the VLM 8 x (5 + 1) x (16 +
    32) = 2304 a run; whisper 4 x 2 x (16 + 32) + 4 encoder calls = 388),
    the calls whose KV range the geometry splits merging in the launch; no
    other kernel, no host copy."""
    from repro_torch.configs.base import get_config

    cfg = get_config(arch)
    fa.reset_counts()
    hostmem.reset_counts()
    with gated(serve):
        out = serve.main(["--arch", arch, "--prompt-len", str(PREFILL_LEN), "--batch", str(BATCH),
                          "--decode-steps", str(DECODE_STEPS), "--repeats", str(XATTN_REPEATS),
                          "--sync-debug", "error"])
    counts = fa.counts()
    check(not any(hostmem.counts().values()),
          f"[{arch}] serving copied to or from host memory: {hostmem.counts()}")
    n_chunks = out["n_chunks"]
    check(n_chunks == 16, f"[{arch}] prefill ran {n_chunks} chunks, expected 16")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    G, Hkv = cfg.n_heads // cfg.n_kv_heads, cfg.n_kv_heads
    clen = PREFILL_LEN // n_chunks
    calls = [c for kind in xattn_fwd_calls(cfg, BATCH, [(c * clen, clen) for c in range(n_chunks)],
                                           PREFILL_LEN + 128, DECODE_STEPS).values() for c in kind]
    splits = sum(fa._tc_geometry(b, tq, sl, G, Hkv, n_sm)[2] > 1 for b, tq, sl in calls)
    want = {**{k: 0 for k in counts}, "fwd_tc": XATTN_REPEATS * len(calls),
            "merged_in_kernel": XATTN_REPEATS * splits}
    check(counts == want, f"[{arch}] serving launched {counts}, expected {want}")
    toks = out["tokens"]
    check(toks.shape == (BATCH, DECODE_STEPS)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          f"[{arch}] decoded tokens {toks.shape} out of range")
    check(bool(torch.isfinite(out["last_hidden"]).all()), f"[{arch}] hidden not finite")
    runs = []
    for run, (p_s, d_s) in enumerate(zip(out["prefill_s_runs"], out["decode_s_runs"])):
        runs.append({"prefill_s": p_s, "prefill_tokens_per_s": BATCH * PREFILL_LEN / p_s,
                     "decode_ms_per_step": 1e3 * d_s / DECODE_STEPS,
                     "decode_tokens_per_s": BATCH * DECODE_STEPS / d_s})
        print(f"serve [{arch}] run {run} ({card}): full width and depth, bf16: prefill "
              f"{p_s:.4f} s, {runs[-1]['prefill_tokens_per_s']:.1f} tokens/s; decode "
              f"{runs[-1]['decode_ms_per_step']:.3f} ms/step, "
              f"{runs[-1]['decode_tokens_per_s']:.1f} tokens/s")
    print(f"serve [{arch}] launches {counts} (expected {want}: {len(calls)} a run), no host "
          f"sync in the decode loop; peak {out['peak_bytes'] / 2**30:.3f} GiB ({card})")
    return counts, {"runs": runs, "peak_bytes": out["peak_bytes"], "calls_per_run": len(calls)}


def xattn_mfu(row, cell, card):
    """MFU with the encoder and the cross K/V projections counted where
    they run: 6 x (N less the encoder's and the xattn K/V leaves') x B x S
    for the chunks, 6 x N_enc x B x n_frames for the encoder and 6 x N_xkv x
    B x N_ctx for the K/V projections, over each step's seconds and the bf16
    peak (the meter's MFU counts every parameter at 6 x N x B x S)."""
    from repro_torch.core import costmodel as cm
    from repro_torch.core import tree

    cfg, mdef = cell.cfg, cell.mdef
    gen = torch.Generator()
    stage = mdef.init_stage_params(gen, device="meta")
    glob = mdef.init_globals(gen, device="meta")
    n_all = cm.count_active_params(mdef, 1)
    n_enc = sum(t.numel() for t in tree.leaves(glob.get("encoder", {})))
    n_xkv = sum(s["xattn"][w].numel() for s in stage for w in ("wk", "wv"))
    n_ctx = mdef.n_context()
    B, S = cell.shape.global_batch, cell.shape.seq_len
    flops = 6 * ((n_all - n_enc - n_xkv) * B * S + n_enc * B * n_ctx + n_xkv * B * n_ctx)
    mfu = [flops / s / BF16_FLOPS for s in row["step_s"]]
    print(f"  MFU with the encoder ({n_enc} parameters x {n_ctx} frames) and the cross K/V "
          f"({n_xkv} parameters x {n_ctx} context rows) counted where they run: "
          + ", ".join(f"{m:.4f}" for m in mfu) + f" (the meter's {row['mfu']}) ({card})")
    return mfu


def xattn_cpu_check(fa, hostmem, serve, runner, arch, card):
    """(c) The reduced config in fp32 (one VLM group, or 2 whisper decoder
    and 2 encoder layers: hd 16, G 2, the CUDA-core kernels), gates set, the
    same weights and stub context on the card and the CPU: one train step at
    S 256 in 2 chunks under the default plan (chunk 0 offloads every tagged
    row): the loss, the gradient norm, every gradient leaf and every
    parameter's update within GRAD_REL_TOL (relative L2; the update over
    the elements whose CPU gradient is over 1e-3 x its leaf's max, as in
    ``ssm_cpu_check``), the launches by their closed forms, D2H = H2D at the
    closed form into pinned buffers; a k bias's gradient, zero up to
    rounding, is measured against its layer's q bias's, and its update
    where that is over 1e-3 x the q bias's max; then a prefill and
    CHECK_DECODE decode steps: the card's tokens the CPU's (a tie
    under TIE_GAP excepted)."""
    from repro_torch.configs.base import ShapeConfig, get_config
    from repro_torch.core import tree
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models.model_zoo import ModelDef

    rcfg = get_config(arch).reduced()
    S = CHECK_SEQ
    cell = runner.resolve_cell(rcfg, ShapeConfig("xattn_check", S, 1, "train"),
                               overrides=dict(pp=1, dp=1, n_chunks=2), dtype=torch.float32)
    check(cell.plan.offload and cell.plan.remat == "sppo",
          f"[{arch}] reduced plan {cell.plan}: expected the default plan")
    cell = dataclasses.replace(cell, alphas=(1.0, 0.0))
    n_ctx = cell.mdef.n_context()
    tokens, labels = (torch.from_numpy(a) for a in SyntheticLM(rcfg.vocab_size, S, 1).sample_step(0))
    # standard normal, not the stub's x 0.02: the cross path then moves the loss
    context = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, n_ctx, rcfg.d_model)).astype(np.float32))
    with gated(serve):
        start = serve.build_params(cell, "cpu", seed=0)
    step = runner.make_train_step(cell, lr_kwargs=dict(peak=1e-3, warmup=1, total=10))
    out = {}
    for dev in ("cuda", "cpu"):
        params = tree_map(lambda t: t.clone().to(dev), start)
        _, grads = runner.loss_and_grads(cell, params, tokens.to(dev), labels.to(dev),
                                         context=context.to(dev))
        grads = {p: g.cpu() for p, g in tree.items(grads)}
        opt = runner.init_opt_state(cell, params)
        fa.reset_counts()
        hostmem.reset_counts()
        params, opt, met = step(params, opt, tokens.to(dev), labels.to(dev),
                                context=context.to(dev))
        out[dev] = {"loss": float(met["loss"]), "gnorm": float(met["grad_norm"]),
                    "params": {p: t.cpu() for p, t in tree.items(params)}, "grads": grads,
                    "counts": fa.counts(), "copied": hostmem.counts()}
        del params, opt
    card_o, cpu_o = out["cuda"], out["cpu"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    G, Hkv = rcfg.n_heads // rcfg.n_kv_heads, rcfg.n_kv_heads
    calls = xattn_fwd_calls(rcfg, 1, list(zip(cell.sched.offsets, cell.sched.lengths)), S, 0)
    # the sppo seams run each chunked call twice (forward and replay), the encoder once
    fwd_calls = 2 * calls["chunked"] + calls["encoder"]
    n_bwd = len(calls["chunked"]) + len(calls["encoder"])
    splits = sum(fa._geometry(b, tq, sl, G, Hkv, n_sm)[2] > 1 for b, tq, sl in fwd_calls)
    want = {**{k: 0 for k in card_o["counts"]}, "fwd": len(fwd_calls), "merge": splits,
            "bwd_dq": n_bwd, "bwd_dkv": n_bwd}
    check(card_o["counts"] == want,
          f"[{arch}] the reduced fp32 step launched {card_o['counts']}, expected {want}")
    n_bytes = 4 * xattn_offload_elems(cell)
    check(card_o["copied"]["d2h_bytes"] == card_o["copied"]["h2d_bytes"] == n_bytes
          and card_o["copied"]["d2h_pinned"] == card_o["copied"]["d2h"] > 0,
          f"[{arch}] the reduced step copied {card_o['copied']}, expected {n_bytes} pinned "
          "bytes each way")
    rel = {"loss": abs(card_o["loss"] - cpu_o["loss"]) / abs(cpu_o["loss"]),
           "grad_norm": abs(card_o["gnorm"] - cpu_o["gnorm"]) / abs(cpu_o["gnorm"])}
    worst = {"grad": (0.0, None), "update": (0.0, None), "update_all": (0.0, None)}
    start = dict(tree.items(start))
    for p, t in card_o["params"].items():
        g_card, g_cpu = card_o["grads"][p], cpu_o["grads"][p]
        d_card, d_cpu = t - start[p], cpu_o["params"][p] - start[p]
        # a k bias's gradient is zero up to rounding (it shifts every score
        # of a query alike): measured against its layer's q bias's
        q = p[:-2] + "bq" if p.endswith("attn/bk") else p
        g_ref = cpu_o["grads"][q]
        sure = g_cpu.abs() > 1e-3 * g_ref.abs().max()
        for key, a, b, n in (("grad", g_card, g_cpu, g_ref.norm()),
                             ("update", d_card[sure], d_cpu[sure], d_cpu[sure].norm()),
                             ("update_all", d_card, d_cpu, d_cpu.norm())):
            if n > 0:
                worst[key] = max(worst[key], (((a - b).norm() / n).item(), p),
                                 key=lambda v: v[0])
    rel.update({k: v[0] for k, v in worst.items() if k != "update_all"})
    print(f"train [{arch}] reduced fp32 step ({card}), gates {XATTN_GATES}, default plan: loss "
          f"card {card_o['loss']:.6f} vs CPU {cpu_o['loss']:.6f}; relative "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f" (worst leaves: gradient {worst['grad'][1]}, update {worst['update'][1]}); the "
          f"update over every element {worst['update_all'][0]:.3e} ({worst['update_all'][1]}); "
          f"launches {card_o['counts']}; D2H {n_bytes} bytes")
    check(all(v <= GRAD_REL_TOL for v in rel.values()),
          f"[{arch}] the reduced step disagrees card vs CPU: {rel} (tol {GRAD_REL_TOL})")
    pre = runner.resolve_cell(rcfg, ShapeConfig("xattn_fp32", S, BATCH, "prefill"),
                              overrides=dict(pp=1, dp=1, n_chunks=S // 64, offload=False,
                                             remat="none"), dtype=torch.float32)
    dec = runner.resolve_cell(rcfg, ShapeConfig("xattn_fp32", S, BATCH, "decode"),
                              overrides=dict(pp=1, dp=1), dtype=torch.float32)
    with gated(serve):
        params = serve.build_params(pre, "cpu", seed=0)
    rng = np.random.default_rng(1)
    prompts = rng.integers(2, rcfg.vocab_size, size=(BATCH, S)).astype(np.int32)
    ctx_np = rng.standard_normal((BATCH, n_ctx, rcfg.d_model)).astype(np.float32)
    fa.reset_counts()
    got = static_decode(runner, pre, dec, tree_map(lambda t: t.cuda(), params), prompts,
                        CHECK_DECODE, "cuda", context=ctx_np)
    serve_counts = fa.counts()
    gaps = []
    with recorded_gaps(ModelDef, gaps):
        want_toks = static_decode(runner, pre, dec, params, prompts, CHECK_DECODE, "cpu",
                                  context=ctx_np)
    ties = held_against_cpu(got, want_toks, np.stack(gaps, axis=1), f"{arch} reduced fp32 serve")
    print(f"serve [{arch}] reduced fp32 ({card}): {BATCH} rows, prefill {S} with its context, "
          f"{CHECK_DECODE} decode steps: tokens as the CPU's ({len(ties)} ties); launches "
          f"{serve_counts}")
    return card_o["counts"], {"step_rel": rel, "update_all_rel": worst["update_all"][0],
                              "serve_ties": ties}


def xattn_phase(fa, hostmem, serve, runner, train_mod, card):
    """The VLM and audio families (ROADMAP Queue 1 item 7(e)): (a)
    llama-3.2-vision-11b and whisper-tiny served at full width and depth;
    (b) trained at full width (the VLM at one group), plans (d) and (b),
    the losses bitwise equal at every step and D2H = H2D at the closed form
    of the real tag shapes (``train_plan``: launches with the encoder's once
    a step, copies; (d)'s last step profiled for the idle share), with the
    MFU that counts the encoder and the cross K/V where they run; (c) the
    reduced configs in fp32 against the CPU.  Every cell with the VLM's
    cross gates set (``gated``).  Returns (launch counts by path, a
    summary)."""
    from repro_torch.configs.base import ShapeConfig, get_config

    t_phase = time.perf_counter()
    paths, summary = {}, {"seconds": {}, "gates": XATTN_GATES}
    for arch in XATTN_ARCHS:
        key = arch.split("-")[0]
        t0 = time.perf_counter()
        paths[f"serve_{key}"], serve_sum = xattn_serve(fa, hostmem, serve, arch, card)
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=XATTN_TRAIN_LAYERS[arch])
        rows = {}
        for plan in ("d", "b"):
            with gated(serve, train_mod):
                paths[f"train_{key}_plan_{plan}"], rows[plan], _ = train_plan(
                    fa, hostmem, serve, runner, train_mod, cfg, card, plan, seq=XATTN_SEQ,
                    n_chunks=XATTN_CHUNKS, steps=XATTN_STEPS, batch=XATTN_TRAIN_BATCH[arch],
                    label=f"{arch} {cfg.n_layers} layers", grads="none", profiled=plan == "d")
            torch.cuda.empty_cache()
        check(rows["d"]["losses"] == rows["b"]["losses"],
              f"[{arch}] plans (d) and (b) losses differ: {rows['d']['losses']} vs "
              f"{rows['b']['losses']}, expected bitwise equal at every step")
        print(f"train [{arch}] plans (d) and (b): losses bitwise equal at every step "
              f"{rows['d']['losses']}")
        cell = runner.resolve_cell(cfg, ShapeConfig("t", XATTN_SEQ, XATTN_TRAIN_BATCH[arch],
                                                    "train"),
                                   overrides=dict(pp=1, dp=1, n_chunks=XATTN_CHUNKS))
        rows["d"]["mfu_encoder_and_cross_kv"] = xattn_mfu(rows["d"], cell, card)
        t2 = time.perf_counter()
        paths[f"train_{key}_fp32"], check_sum = xattn_cpu_check(fa, hostmem, serve, runner, arch,
                                                                card)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        summary[arch] = {"serve": serve_sum, "train": rows, "fp32_check": check_sum}
        summary["seconds"][arch] = {"serve": t1 - t0, "train": t2 - t1, "fp32_check": t3 - t2}
    summary["seconds"]["total"] = time.perf_counter() - t_phase
    print(f"cross-attention phase took {summary['seconds']['total']:.1f} s "
          f"({json.dumps({a: {k: round(v, 1) for k, v in d.items()} for a, d in summary['seconds'].items() if a != 'total'})})")
    return paths, summary


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
    from repro_torch.launch import mesh
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
    # the model axis's shapes (sp = 2, the full-width cell's last chunk):
    # gather_q, all of the chunk's queries over rank 1's gapped cache shard;
    # gather_kv, rank 1's queries over both ranks' shards concatenated; the
    # ring's two hops on rank 1, its 832 queries over its resident 4096-slot
    # gapped shard, then over rank 0's
    ma_cell = model_axis_cell(runner, dataclasses.replace(cfg, n_layers=SP_LAYERS), SP_SEQ, 1,
                              SP_CHUNKS)
    for label, mode, kv in (("gather_q", "gather_q", None), ("gather_kv", "gather_kv", None),
                            ("ring resident hop", "ring", 1), ("ring peer hop", "ring", 0)):
        args = model_axis_inputs(gen, ma_cell, ma_cell.sched.n - 1, mode, 1, torch.bfloat16,
                                 kv_rank=kv)
        extra_measured.append(measure_bwd_shape(f"model axis {label} last chunk", fa, ref, *args))
        del args
    ma_fwd_err, ma_bwd_rel = model_axis_check_shapes(fa, ref, gen, runner, cfg)
    # granite-moe-1b-a400m's shapes (hd 64, G = 2): the 24-layer train
    # cell's first and last chunk, forward and backward, and its decode step
    moe_cfg = get_config(MOE_ARCH)
    _, moe_in = train_chunk_shapes(gen, runner, moe_cfg, n_layers=moe_cfg.n_layers,
                                   seq=MOE_SEQ, n_chunks=MOE_CHUNKS)
    extra_measured += [measure_bwd_shape(f"{MOE_ARCH} {name}", fa, ref, *args)
                       for name, args in moe_in.items()]
    del moe_in
    _, moe_decode_in = serving_shapes(gen, moe_cfg)
    moe_decode_rows = measure_shape(f"{MOE_ARCH} decode step", fa, ref, *moe_decode_in)
    del moe_decode_in
    # causal self-attention at each later family's serving prefill chunk and
    # decode step and its train cell's first and last chunk: zamba2-7b's
    # shared block (hd 112, G 1, 32 heads), llama-3.2-vision-11b's self
    # layers (hd 128, G 4) and whisper-tiny's decoder (hd 64, G 1)
    family_cells = {"zamba2-7b": dict(n_layers=SSM_TRAIN_LAYERS["zamba2-7b"], seq=SSM_SEQ,
                                      n_chunks=SSM_CHUNKS),
                    **{arch: dict(n_layers=XATTN_TRAIN_LAYERS[arch], seq=XATTN_SEQ,
                                  n_chunks=XATTN_CHUNKS, batch=XATTN_TRAIN_BATCH[arch])
                       for arch in XATTN_ARCHS}}
    self_rows, shape_s = {}, {}
    for arch, kw in family_cells.items():
        t0 = time.perf_counter()
        self_rows[arch.split("-")[0]] = self_attn_kernel_shapes(fa, ref, gen, runner,
                                                                get_config(arch), **kw)
        shape_s[f"{arch} self"] = time.perf_counter() - t0
    # the cross-attention families' shapes, non-causal: the VLM's cross
    # layer (hd 128, G 4 over 1600 patches), whisper's encoder (1500 x 1500,
    # hd 64, G 1) and cross layer (over 1500 frames)
    t0 = time.perf_counter()
    xattn_fwd_rows, xattn_bwd_rows, xattn_edge = xattn_kernel_shapes(fa, ref, gen, runner)
    shape_s["cross and encoder"] = time.perf_counter() - t0
    print(f"the later families' kernel shapes took "
          f"{json.dumps({k: round(v, 1) for k, v in shape_s.items()})} s")
    # the paged step's shape: 8 rows at their own positions over their
    # gathered 2112 logical slots (bf16, timed as the serving shapes are),
    # and the multi-rank serving phase's fp32 shapes (untimed)
    from repro_torch.runtime import kvpool

    paged_geo = kvpool.PoolGeometry(s_bucket=PAGED["s_bucket"], sp=1, max_new=PAGED["max_new"],
                                    block_tokens=PAGED["block_tokens"], n_blocks=1056,
                                    n_slots=PAGED["slots"])
    paged_rows = measure_shape("paged decode step", fa, ref,
                               *paged_step_shape(gen, paged_geo, PAGED["slots"]))
    serve_fp32_err = serve_fp32_shapes(fa, ref, gen, runner,
                                       dataclasses.replace(cfg, n_layers=SERVE_FP32_LAYERS))
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
    # ---- this slice's path: the paged continuous-batching engine
    paged_counts, paged_summary = paged_serve_phase(fa, runner, serve, cfg, card)

    t_phase4 = time.perf_counter()
    print(f"phase 3 took {t_phase4 - t_phase3:.1f} s")
    # ---- phase 4: the training path, through the train CLI's function
    plan_counts, train_summary = train_phase(fa, hostmem, serve, runner, train_mod, cfg, card)
    train_counts = plan_counts["d"]      # the main path: the default plan at S = 8192
    torch.cuda.empty_cache()
    train_rel, fp32_counts = train_cpu_check(fa, hostmem, serve, runner, cfg, card)
    torch.cuda.empty_cache()
    # ---- packed training, its fp32 check, three configs
    t_packed = time.perf_counter()
    print(f"phase 4 took {t_packed - t_phase4:.1f} s")
    packed_counts, packed_summary = packed_phase(
        fa, hostmem, serve, runner, train_mod, cfg, card,
        train_summary["train_plans"]["d"]["warm_step_ms"])
    packed_fp32, packed_fp32_counts = packed_cpu_check(fa, hostmem, serve, runner, cfg, card)
    config_counts, config_rows = config_phase(fa, hostmem, serve, runner, train_mod, card)
    print(f"packed and config phases took {time.perf_counter() - t_packed:.1f} s")
    # ---- the multi-rank pipeline, its ranks sharing the card
    t_ranks = time.perf_counter()
    pipe_counts, pipe_summary = pipeline_phase(fa, mesh, runner, card)
    print(f"pipeline phase took {time.perf_counter() - t_ranks:.1f} s")
    # ---- the model axis, its ranks sharing the card
    t_ranks = time.perf_counter()
    ma_counts, ma_summary = model_axis_phase(fa, mesh, runner, card)
    print(f"model-axis phase took {time.perf_counter() - t_ranks:.1f} s")
    # ---- serving over ranks: sp = 2, pp = 2, the engine at 1 x 2
    t_ranks = time.perf_counter()
    sr_counts, sr_summary = serve_ranks_phase(fa, mesh, runner, serve, card)
    print(f"serving-over-ranks phase took {time.perf_counter() - t_ranks:.1f} s")
    # ---- the MoE family: granite served and trained at 24 layers, EP at sp = 2
    torch.cuda.empty_cache()
    moe_counts, moe_summary = moe_phase(fa, hostmem, mesh, serve, runner, train_mod, card)
    # ---- MLA: deepseek-v3-671b's kernels, serving and gradients at full width
    torch.cuda.empty_cache()
    mla_counts, mla_rows, mla_summary = mla_phase(fa, hostmem, serve, runner, ref, card)
    # ---- the SSM family: rwkv6-3b and zamba2-7b served at full width and
    # depth, trained at full width
    torch.cuda.empty_cache()
    ssm_counts, ssm_summary = ssm_phase(fa, hostmem, serve, runner, train_mod, card)
    # ---- the VLM and audio families: llama-3.2-vision-11b and whisper-tiny
    # served at full width and depth, trained at full width
    torch.cuda.empty_cache()
    xattn_counts, xattn_summary = xattn_phase(fa, hostmem, serve, runner, train_mod, card)
    xattn_summary["seconds"]["kernel_shapes"] = shape_s

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
             **{f"train_{arch}": c for arch, c in config_counts.items()},
             "train_pipeline_pp2": pipe_counts["plain"], "train_pipeline_pp2_msp": pipe_counts["msp"],
             **{f"train_pipeline_{k}": c for k, c in pipe_counts.items() if k.startswith("fp32_")},
             **{f"train_model_axis_{k}": c for k, c in ma_counts.items()},
             **paged_counts, **sr_counts, **moe_counts, **mla_counts, **ssm_counts,
             **xattn_counts}
    pipe_tc = ("train_pipeline_pp2", "train_pipeline_pp2_msp",
               *(f"train_model_axis_{k}" for k in SP_MODES), "train_moe_plan_d",
               "train_mla_plan_d", "train_zamba2_plan_d", "train_llama_plan_d",
               "train_whisper_plan_d")
    pipe_cc = (*(f"train_pipeline_{k}" for k in pipe_counts if k.startswith("fp32_")),
               *(f"train_model_axis_{k}" for k in ma_counts if k.startswith("fp32_")),
               *sr_counts, "train_moe_fp32", "train_moe_ep_sp2", "train_mla_fp32",
               "train_zamba2_fp32", "train_llama_fp32", "train_whisper_fp32")

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
         + sum(c["fwd_tc"] for c in full.values()) + packed_counts["packed_d"]["fwd_tc"]
         + sum(paths[p]["fwd_tc"] for p in pipe_tc)
         + paged_counts["serve_paged_continuous"]["fwd_tc"] + moe_counts["serve_moe"]["fwd_tc"]
         + mla_counts["serve_mla"]["fwd_tc"] + ssm_counts["serve_zamba2"]["fwd_tc"]
         + xattn_counts["serve_llama"]["fwd_tc"] + xattn_counts["serve_whisper"]["fwd_tc"],
         "launches_by_path": by_path("fwd_tc"),
         "merged_in_kernel_by_path": by_path("merged_in_kernel"),
         **{key: tc_rows[0][key] for key in common},
         "edge_grid_max_abs_err": grid_err["tensor_cores"],
         "shapes": (tc_rows + [r["tensor_cores"] for r in extra_fwd]
                    + [paged_rows["tensor_cores"], moe_decode_rows["tensor_cores"]]),
         **{f"{tag}_shapes": [r["tensor_cores"] for r in f] for tag, (f, _) in self_rows.items()},
         "xattn_shapes": [r["tensor_cores"] for r in xattn_fwd_rows],
         "xattn_edge_max_abs_err": xattn_edge[0],
         "mla_edge_grid_max_abs_err": mla_summary["edge_grid"]["fwd_max_abs_err"],
         "mla_shapes": [r["fwd"] for r in mla_rows.values()]},
        {"name": "flash_attention_partial", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_partial.cu",
         "replaces": "src/repro/kernels/flash_attention.py:260",
         "launches": fp32_counts["fwd"] + packed_fp32_counts["fwd"]
         + sum(paths[p]["fwd"] for p in pipe_cc),
         "launches_by_path": by_path("fwd"),
         **{key: cc_rows[0][key] for key in common},
         "edge_grid_max_abs_err": grid_err["cuda_cores"],
         "fp32_check_shapes_max_abs_err": fp32_fwd_err,
         "fp32_packed_check_shapes_max_abs_err": fp32_packed_err,
         "model_axis_check_shapes_max_abs_err": ma_fwd_err,
         "serve_fp32_check_shapes_max_abs_err": serve_fp32_err,
         "shapes": cc_rows + [r["cuda_cores"] for r in extra_fwd]
         + [paged_rows["cuda_cores"], moe_decode_rows["cuda_cores"]],
         **{f"{tag}_shapes": [r["cuda_cores"] for r in f] for tag, (f, _) in self_rows.items()},
         "xattn_shapes": [r["cuda_cores"] for r in xattn_fwd_rows],
         "xattn_edge_max_abs_err": xattn_edge[0]},
        # the CUDA-core forward's split-KV merge (decode), launched by the
        # same wrapper call; its output is what the decode shape's check holds
        {"name": "flash_attention_partial_merge", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_partial.cu",
         "replaces": "src/repro/kernels/flash_attention.py:260",
         "launches": fp32_counts["merge"] + packed_fp32_counts["merge"]
         + sum(paths[p]["merge"] for p in pipe_cc),
         "launches_by_path": by_path("merge"),
         "max_abs_err": decode_cc["max_abs_err"],
         **{key: decode_cc["merge"][key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None, "shapes": [decode_cc["merge"]]},
    ]
    # launches: on the main paths that run each pair (bf16 training at 4
    # layers, at full depth and packed for the tensor cores, the fp32
    # training checks for the CUDA cores)
    tc_paths = ("train", *full, "train_packed", *pipe_tc)
    cc_paths = ("train_fp32", "train_packed_fp32", *pipe_cc)
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
            "model_axis_check_shapes_max_rel_err": ma_bwd_rel,
            "shapes": [r[part] for r in bwd_rows + extra_bwd],
            **{f"{tag}_shapes": [r[part] for r in b] for tag, (_, b) in self_rows.items()},
            "xattn_shapes": [r[part] for r in xattn_bwd_rows],
            "xattn_edge_max_rel_err": xattn_edge[1],
            **({"mla_edge_grid_max_rel_err": mla_summary["edge_grid"]["bwd_max_rel_err"],
                "mla_shapes": [r[part[:-3]] for r in mla_rows.values() if part[:-3] in r]}
               if part.endswith("_tc") else {})})
    summary = {"prefill_s_runs": pre_runs, "decode_s_runs": dec_runs,
               "prefill_s": pre_s, "prefill_tokens_per_s": BATCH * PREFILL_LEN / pre_s,
               "decode_ms_per_step": 1e3 * dec_s / DECODE_STEPS,
               "decode_tokens_per_s": BATCH * DECODE_STEPS / dec_s,
               "peak_bytes": peak, "cpu_check_rel_l2": rel,
               **profile, **train_summary, "train_cpu_check_rel_l2": train_rel,
               **packed_summary, "packed_fp32_check": packed_fp32, "train_configs": config_rows,
               "train_chunks": list(train_cell.sched.lengths), "pipeline": pipe_summary,
               "model_axis": ma_summary, "paged_serve": paged_summary,
               "serve_ranks": sr_summary, "moe": moe_summary, "mla": mla_summary,
               "ssm": ssm_summary, "xattn": xattn_summary,
               "seconds": time.perf_counter() - t_start}
    print("summary:", json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
