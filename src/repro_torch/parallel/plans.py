"""Per-cell parallel plans: map (arch x shape) onto the mesh.

A copy of ``repro/parallel/plans.py`` (the JAX package), held against it by
tests/test_torch_serve.py.  Defaults follow the SPPO heuristics (§6.1,
DESIGN.md §4); the single-device port resolves them at data = model = 1.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, ParallelPlan, ShapeConfig
from repro_torch.core import costmodel as cm

ACT_BYTES_BUDGET = 3.5 * 2**30  # target tagged-activation bytes per device


def _pp_for(cfg: ModelConfig, shape: ShapeConfig, data_size: int) -> int:
    big = cfg.name.startswith("deepseek")
    if shape.kind == "train" or shape.kind == "prefill":
        if big:
            return min(16, data_size)
        if shape.seq_len >= 32768 and cfg.n_layers >= 24:
            return 2
        return 1
    # decode
    if big:
        return min(8, data_size)
    return 1


def resolve_plan(cfg: ModelConfig, shape: ShapeConfig, *, data_size: int = 16,
                 model_size: int = 16, pods: int = 1,
                 overrides: dict = None) -> ParallelPlan:
    pp = _pp_for(cfg, shape, data_size)
    dp = data_size // pp
    B = shape.global_batch
    # keep batch divisible across dp*pods (drop dp down if needed)
    while dp > 1 and B % (dp * pods):
        pp_candidates = [p for p in (pp * 2, pp * 4, data_size)
                         if data_size % p == 0]
        if not pp_candidates:
            break
        pp = pp_candidates[0]
        dp = data_size // pp
    if B % (dp * pods):
        dp = 1
        pp = data_size

    if shape.kind == "train":
        # keep the pipeline fed: N >= pp/2 even for short sequences (the
        # paper's bubble ratio (p-1)/N; garbage ticks are real compute here)
        n = max(2 if shape.seq_len >= 4096 else 1, pp // 2)
        while shape.seq_len % (n * model_size):
            n -= 1
    elif shape.kind == "prefill":
        n = max(pp, shape.seq_len // 4096)
    else:
        n = 1  # decode: single-token step, no chunking

    b_loc = max(1, B // (dp * pods))
    accum = 1
    if shape.kind == "train":
        # memory-aware microbatching: the full per-layer activation set
        # (costmodel.full_act_bytes_per_token, ~34·d bf16) spread over
        # pp*sp devices; pick the accumulation factor that fits
        # ACT_BYTES_BUDGET
        per_tok = (cm.full_act_bytes_per_token(cfg) * cfg.n_layers
                   / (pp * model_size))
        tok_budget = max(2048, int(ACT_BYTES_BUDGET / per_tok))
        want = max(1, (b_loc * shape.seq_len + tok_budget - 1) // tok_budget)
        # smallest divisor of b_loc >= want (cap at b_loc: microbatch of 1)
        accum = b_loc
        for c in range(want, b_loc + 1):
            if b_loc % c == 0:
                accum = c
                break

    micro = 1
    if shape.kind == "decode" and pp > 1:
        micro = min(8, b_loc)
        while b_loc % micro:
            micro -= 1

    plan = ParallelPlan(
        dp=dp, pp=pp, sp=model_size,
        n_chunks=n,
        partition="flops" if pp == 1 else "length",
        offload=shape.kind != "decode",
        # one-chunk-ahead backward reload on the trained explicit path
        # (DESIGN.md §12); prefill/decode have no backward, so the seam
        # would be dead structure — they keep the autodiff placement
        prefetch="ahead" if shape.kind == "train" else "sync",
        msp=False,
        remat="sppo" if shape.kind == "train" else "none",
        zero1=pods > 1,
        opt_dtype="bfloat16" if cfg.name.startswith("deepseek") else "float32",
        # big models keep AdamW m/v host-resident (executed ZeRO-Offload
        # analogue, DESIGN.md §11); only train shapes carry an optimizer
        offload_moments=(shape.kind == "train"
                         and cfg.name.startswith("deepseek")),
        grad_accum=accum,
        decode_microbatch=micro,
    )
    if overrides:
        plan = dataclasses.replace(plan, **overrides)
    plan.validate(data_size, model_size)
    return plan
