"""Smoke test of the PyTorch/CUDA port on one CUDA card.

  python3 chip_smoke.py

Three phases, each of which exits non-zero on failure:

1. device and build: the card's name and power limit, then the Hopper
   attention kernel built for sm_90a from src/repro_torch/kernels/csrc with
   nvcc's register and shared-memory report;
2. the kernel against its plain PyTorch version on the card, at the serving
   path's prefill-chunk and decode shapes (bf16) and on a small grid of edge
   cases in fp32 and bf16 (fully masked rows exact).  Both sides compute in
   fp32 from the same inputs, so every case is held to 1e-5.  Beside the
   kernel's bound: CUDA-event times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (a yardstick only: the port never
   calls it);
3. the static serve path of qwen2-7b through its CLI entry point at full
   width, all 28 layers, bf16, random weights from a seed: B = 4, a
   2048-token prompt (16 prefill chunks of 128) and 32 decode steps, served
   3 times over in one process (the first run pays one-time costs; each run
   is timed).  The kernel must be called exactly 28 x (16 + 32) times a run,
   and its merge launched at every decode call.  The same seed-built model
   cut to 2 layers then prefills one 256-token prompt on the card (bf16) and
   on the CPU (plain path, fp32): the last hidden states must agree within a
   relative L2 error of 2e-2, a bf16 tolerance.  Last, outside the counted
   run and after a warm-up, a prefill and 4 decode steps run under
   torch.profiler for the device's busy time by kernel group and its idle
   share against the wall time of the same profiled run and against that of
   the last unprofiled run (the profiler slows the host).

The last line is ``{"ok": true, "device": {...}}``; the line before it lists
each kernel with its check and times.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType

PAD = 2**30
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
L2_BYTES = 50 * 2**20
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak, H100 SXM data sheet
FP32_FLOPS = 67e12          # fp32 outside the tensor cores
PREFILL_LEN, BATCH, DECODE_STEPS, REPEATS = 2048, 4, 32, 3
KERNEL_TOL = 1e-5  # kernel vs plain version: both fp32 inside, inputs alike


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


def time_ms(fn, copies, reps: int = 24) -> float:
    """Device time of one call ``fn(*copies[i])``: the mean over ``reps``
    calls between two CUDA events, cycling through the copies.  A sleep
    kernel queued first holds the device until the host has queued every
    call (it is lengthened until it does), so host overhead is not timed."""
    for args in copies:
        fn(*args)
    torch.cuda.synchronize()
    cycles = 2_000_000
    while True:
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


def kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, causal=True):
    """Run the kernel (wrapper) and the plain version on the same inputs and
    fail unless they agree; returns (max |normalized diff|, kernel outputs)."""
    o1, m1, l1 = fa.flash_attention_partial(q, k, v, q_pos, kv_pos,
                                            causal=causal, q_start=q_start)
    o2, m2, l2 = ref.attention_partial_ref(q, k, v, q_pos, kv_pos,
                                           causal=causal, q_start=q_start)
    torch.cuda.synchronize()
    err = (ref.normalize(o1, l1) - ref.normalize(o2, l2)).abs().max().item()
    live = m2 > -1e29
    m_err = (m1 - m2)[live].abs().max().item() if live.any() else 0.0
    tol = KERNEL_TOL
    check(err <= tol and m_err <= tol and bool((m1[~live] == m2[~live]).all()),
          f"kernel disagrees with plain version: out err {err}, m err {m_err}"
          f" (tol {tol}) at q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}")
    return err, (o1, m1, l1)


def edge_grid(fa, ref, gen):
    """fp32 and bf16 at 1e-5: ragged sizes, hd_k != hd_v, small and
    non-power-of-two head dims, GQA G = 7, non-causal, KV splits (a long
    decode), a q_start window and fully masked rows (which must be exact)."""
    dev = "cuda"
    cases = [  # B, Tq, S, H, Hkv, hdk, hdv, causal
        (2, 17, 33, 6, 2, 16, 16, True), (1, 8, 128, 8, 1, 64, 32, True),
        (1, 16, 48, 4, 4, 32, 32, False), (2, 9, 100, 14, 2, 128, 128, True),
        (1, 1, 64, 4, 2, 32, 32, True), (3, 70, 200, 28, 4, 128, 128, True),
        (2, 5, 77, 14, 2, 24, 8, True), (2, 3, 70, 14, 2, 40, 96, True),
        (1, 1, 2000, 14, 2, 128, 128, True)]
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Tq, S, H, Hkv, hdk, hdv, causal in cases:
            q = torch.randn(B, Tq, H, hdk, generator=gen, device=dev).to(dtype)
            k = torch.randn(B, S, Hkv, hdk, generator=gen, device=dev).to(dtype)
            v = torch.randn(B, S, Hkv, hdv, generator=gen, device=dev).to(dtype)
            q_pos = (torch.arange(Tq, dtype=torch.int32, device=dev) + S - Tq)[None].repeat(B, 1)
            kv_pos = torch.arange(S, dtype=torch.int32, device=dev)
            q_start = torch.zeros(B, Tq, dtype=torch.int32, device=dev)
            err, _ = kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start, causal)
            worst, n = max(worst, err), n + 1
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
        err, (o, m, l) = kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start)
        dead = ~visible_mask(B, q_pos, kv_pos, q_start).any(dim=-1)
        check(int(dead.sum()) == 4, f"expected 4 dead rows, got {int(dead.sum())}")
        check(bool((o[dead] == 0).all() and (l[dead] == 0).all() and (m[dead] == -1e30).all()),
              "fully masked rows are not exactly o = l = 0, m = -1e30")
        worst, n = max(worst, err), n + 1
    return worst, n


def measure_shape(name, fa, ref, q, k, v, q_pos, kv_pos, q_start):
    """Check one serving shape and time kernel, plain version and SDPA.  The
    bound counts what this data needs: q.k and p.v for each visible (query,
    slot) pair and head; bytes of the query rows that see some slot, the K/V
    rows some query of their batch row sees, every position read and every
    output written."""
    err, _ = kernel_vs_plain(fa, ref, q, k, v, q_pos, kv_pos, q_start)
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
    kernel_ms = time_ms(lambda *a: fa.flash_attention_partial(*a[:5], q_start=a[5]), copies)
    plain_ms = time_ms(lambda *a: ref.attention_partial_ref(*a[:5], q_start=a[5]), copies,
                       reps=len(copies))
    mask = vis[:, None]                        # [B, 1, Tq, S]
    lib_ms = time_ms(lambda *a: F.scaled_dot_product_attention(
        a[0].transpose(1, 2), a[1].transpose(1, 2), a[2].transpose(1, 2), attn_mask=mask,
        enable_gqa=True), copies)
    row = {"shape": name, "q": list(q.shape), "kv": list(k.shape), "dtype": str(q.dtype),
           "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "library_ms": lib_ms, "bytes": n_bytes, "ops": ops,
           "fp32_simt_floor_ms": 1e3 * ops / FP32_FLOPS}
    print(f"kernel [{name}] q {tuple(q.shape)} kv {tuple(k.shape)}: err {err:.3e}, "
          f"kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
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
    kernels) from a torch.profiler run.  Groups: the flash kernel and its
    merge, cuBLAS matrix products (nvjet / gemm kernels), everything else.
    Only device events count: a host op's self device time is the time of
    the kernels it launched, which are listed as events of their own."""
    groups = {"attention kernel": 0.0, "matmul": 0.0, "other": 0.0}
    kernels = []
    for evt in prof.key_averages():
        ms = evt.self_device_time_total / 1e3
        if evt.device_type == DeviceType.CPU or ms <= 0:
            continue
        kernels.append((evt.key[:60], ms))
        name = evt.key.lower()
        if "flash_partial" in name or "merge_splits" in name:
            groups["attention kernel"] += ms
        elif any(tag in name for tag in ("nvjet", "gemm", "xmma", "cutlass", "matmul")):
            groups["matmul"] += ms
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


def main():
    if not torch.cuda.is_available():
        fail("no CUDA device")
    src = Path(__file__).resolve().parent / "src"
    check((src / "repro_torch").is_dir(), f"no port sources under {src}")
    sys.path.insert(0, str(src))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.parallel import runner

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
    _, build_log = fa.build()
    print(f"built {fa._SRC.name} for sm_90a in {time.perf_counter() - t0:.1f} s")
    for line in build_log.splitlines():
        if "registers" in line or "bytes stack frame" in line or "Compiling entry" in line:
            print("  ptxas:", line.strip())

    # ---- phase 2: kernel against its plain version
    gen = torch.Generator(device="cuda").manual_seed(0)
    grid_err, n_grid = edge_grid(fa, ref, gen)
    print(f"edge grid: {n_grid} cases (fp32 and bf16) within {KERNEL_TOL} "
          f"(max err {grid_err:.3e}), dead rows exact")
    prefill_in, decode_in = serving_shapes(gen)
    rows = [measure_shape("prefill chunk", fa, ref, *prefill_in),
            measure_shape("decode step", fa, ref, *decode_in)]
    del prefill_in, decode_in
    torch.cuda.empty_cache()

    # ---- phase 3: the main path, through the CLI entry point
    cfg = get_config("qwen2-7b")
    fa.launches = fa.merge_launches = 0
    out = serve.main(["--arch", "qwen2-7b", "--prompt-len", str(PREFILL_LEN),
                      "--batch", str(BATCH), "--decode-steps", str(DECODE_STEPS),
                      "--repeats", str(REPEATS)])
    launches, merges = fa.launches, fa.merge_launches
    n_chunks = out["n_chunks"]
    expected = REPEATS * cfg.n_layers * (n_chunks + DECODE_STEPS)
    print(f"main path: {cfg.name} {cfg.n_layers} layers, {REPEATS} runs of prefill "
          f"{n_chunks} chunks + {DECODE_STEPS} decode steps: kernel calls {launches} "
          f"(expected {expected}), merge launches {merges} (one per decode call), "
          f"{launches + merges} device launches in all")
    check(n_chunks == 16, f"prefill ran {n_chunks} chunks, expected 16")
    check(launches == expected, f"kernel called {launches} times, expected {expected}")
    check(merges == REPEATS * cfg.n_layers * DECODE_STEPS,
          f"merge launched {merges} times, expected one per decode call")
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

    main_row = rows[0]
    kernel = {"name": "flash_attention_partial", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/flash_partial.cu",
              "replaces": "src/repro/kernels/flash_attention.py:260",
              "launches": launches, "merge_launches": merges,
              **{key: main_row[key] for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")},
              "edge_grid_max_abs_err": grid_err, "shapes": rows}
    summary = {"prefill_s_runs": pre_runs, "decode_s_runs": dec_runs,
               "prefill_s": pre_s, "prefill_tokens_per_s": BATCH * PREFILL_LEN / pre_s,
               "decode_ms_per_step": 1e3 * dec_s / DECODE_STEPS,
               "decode_tokens_per_s": BATCH * DECODE_STEPS / dec_s,
               "peak_bytes": peak, "cpu_check_rel_l2": rel,
               **profile, "seconds": time.perf_counter() - t_start}
    print("summary:", json.dumps(summary))
    print(card)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
