"""SPPO heuristic solver (§6.1): pick (SP, PP, N) minimizing iteration time.

A copy of ``repro/core/solver.py`` (the JAX package), held against it by
tests/test_torch_plan.py; its hardware defaults to the port's H100.

Search space restrictions (the paper's heuristics, translated to the
reference's mesh, DESIGN.md §2):
  * SP stays on the fast intra-pod `model` axis (no cross-pod SP) and is
    fixed to the axis size (16) by the production mesh;
  * PP divides the `data` axis; the `pod` axis carries only DP;
  * per-chunk workload between MIN_CHUNK_TOKENS and MAX_CHUNK_TOKENS per
    device (the paper's 2K–16K/layer/device heuristic, Fig. 7).

Objective: every candidate (PP, N) is *played out* by the event-driven
simulator (core/simulate.py, DESIGN.md §3): per-stage compute/P2P/D2H/H2D
lanes over the FLOPs-weighted chunk costs, so the score includes fill/drain
bubbles, steady-phase resynchronization, inter-stage hand-off time, and the
unhidden-D2H stall that the closed-form T = (p−1+N)/N·F(N) cannot see.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.core import costmodel as cm
from repro_torch.core import offload as ofl
from repro_torch.core import partition as part
from repro_torch.core import simulate as sim

MIN_CHUNK_TOKENS = 2048
MAX_CHUNK_TOKENS = 16384


@dataclass(frozen=True)
class SolverResult:
    pp: int
    n_chunks: int
    sp: int
    est_time: float
    bubble_ratio: float
    alphas: tuple
    candidates: tuple  # (pp, n, time) explored — for the benchmark report


def iteration_time(cfg, seq_len: int, batch: int, n_params: int,
                   pp: int, n: int, sp: int,
                   hw: cm.Hardware = cm.H100, *, msp: bool = False,
                   msp_split: int = 2,
                   offload: bool = True,
                   offload_moments: bool = False,
                   opt_dtype: str = "float32",
                   prefetch: str = "ahead") -> Tuple[float, tuple]:
    """Simulated per-iteration wall time for one dp replica (seconds)."""
    t, alphas, _ = simulate_candidate(cfg, seq_len, batch, n_params, pp, n,
                                      sp, hw, msp=msp, msp_split=msp_split,
                                      offload=offload,
                                      offload_moments=offload_moments,
                                      opt_dtype=opt_dtype, prefetch=prefetch)
    return t, alphas


def simulate_candidate(cfg, seq_len: int, batch: int, n_params: int,
                       pp: int, n: int, sp: int,
                       hw: cm.Hardware = cm.H100, *, msp: bool = False,
                       msp_split: int = 2, offload: bool = True,
                       offload_moments: bool = False,
                       opt_dtype: str = "float32",
                       prefetch: str = "ahead",
                       offload_dtype: str = "none",
                       moments_dtype: str = "none",
                       doc_lens=None,
                       attn_mode: str = "gather_q"
                       ) -> Tuple[float, tuple, sim.SimResult]:
    """Build the candidate's cost/activation profile and play it out.

    offload_moments adds the optimizer-state epilogue (DESIGN.md §11): the
    per-device moment set crosses the host link once in each direction per
    step, after the last backward — nothing left to hide it under, so it is
    charged in full on top of the pipeline playout.  prefetch selects the
    simulator's H2D lane mode (DESIGN.md §12): "ahead" prices the
    one-chunk-ahead reload seam, "sync" the autodiff placement — both
    plan settings therefore have priced predictions.

    offload_dtype / moments_dtype (DESIGN.md §14) price the compressed
    channels: the act_off D2H/H2D lane volumes scale by the codec's wire
    ratio (the α solver itself keeps planning in raw device bytes — the
    recurrence drains full rows), and the moments epilogue moves the
    payload + host-side scale bytes instead of the full opt_dtype leaves.

    doc_lens (optional) switches the candidate to a packed variable-length
    workload cell (DESIGN.md §13): the documents are greedily packed into
    ``batch`` rows of ``seq_len``, the per-position causal-sawtooth cost
    profile replaces the single triangle, and chunk boundaries / offload
    ratios are balanced over that measured profile.

    attn_mode="ring" (DESIGN.md §15) adds the ring-attention lane: per
    chunk, the sp-hop KV rotation is played out by ``sim.ring_overlap``
    (hop h+1's P2P overlaps hop h's compute on a serialized link), the
    per-hop compute is discounted by the zig-zag causal hop fractions, and
    the per-chunk (occupancy, exposed-fwd, exposed-bwd) triple is handed to
    the schedule simulator's ring lane.  Other modes price no attention
    collectives beyond the baseline (gather/all-gather traffic is small
    against the chunk compute at solver scale)."""
    r = part.flops_per_token_ratio(cfg)
    tok_flops = cm.model_flops_per_token(n_params, train=True)
    chips = sp * pp
    if doc_lens:
        doc_lens = [int(x) for x in doc_lens]
        rows = part.pack_lengths(doc_lens, seq_len)
        row_lens = [[doc_lens[i] for i in row] for row in rows]
        assert len(row_lens) <= batch, (
            f"packing needs {len(row_lens)} rows > batch {batch}")
        row_lens += [[] for _ in range(batch - len(row_lens))]
        profile = part.packed_cost_profile(row_lens, seq_len, r)
        sched = part.partition_profile(
            profile, n, multiple=sp,
            doc_bounds=part.aligned_doc_bounds(row_lens, seq_len))
        # profile units already sum over the batch rows (padding rows ride
        # the dense matmuls at linear cost)
        costs = part.profile_chunk_costs(profile, sched)
        # profile cost units cover all batch rows, so the flops conversion
        # and the linear share are taken against batch*seq_len units
        scale = (batch * seq_len * tok_flops) / sum(costs)
        attn_frac = 1.0 - (batch * seq_len) / sum(costs)
    else:
        sched = part.partition(seq_len, n, cfg, "length")
        costs = part.chunk_costs(sched, r)
        # convert relative costs to flops: linear == per-token matmul flops
        scale = (batch * seq_len * tok_flops) / sum(costs)
        # backward/forward split: the recompute-based flash backward makes
        # the attention share cost 2.5x its forward (vs 2x for matmuls);
        # weight by the attention fraction of the relative chunk costs.
        # Σcosts = Σlengths + attention term: linear share is Σlen/Σcost.
        attn_frac = 1.0 - sum(sched.lengths) / sum(costs)
    chunk_flops = [c * scale for c in costs]
    bwd_ratio = cm.effective_bwd_ratio(attn_frac)
    # the 6N lumped convention prices bwd at 2x fwd; the QK^T recompute of
    # the attention backward adds (1+bwd_ratio)/3 on top
    times = [f / (chips * hw.peak_flops_bf16)
             * (1.0 + bwd_ratio) / (1.0 + cm.BWD_RATIO) +
             2 * cfg.n_layers / pp * hw.kernel_launch_us * 1e-6
             for f in chunk_flops]
    # offload: tagged Type-1 activation bytes per chunk (cost model's
    # per-site ledger — costmodel.tagged_bytes_per_token)
    act = cm.chunk_act_bytes(cfg, sched.lengths, batch=batch, pp=pp, sp=sp)
    # the D2H window is the *forward* compute of the next chunk (§5.2);
    # compression widens it in byte terms — only wire_ratio·A bytes must
    # cross per offloaded row-set, so the solver sees the link at its
    # effective (raw-bytes-per-second) rate and α can grow accordingly
    wire_ratio = cm.offload_wire_ratio(offload_dtype)
    fwd_times = [t / (1.0 + bwd_ratio) for t in times]
    plan = ofl.sequence_aware_alphas(act, fwd_times, hw.d2h_bw / wire_ratio)
    alphas = plan.alphas if offload else tuple(0.0 for _ in act)
    # per-device inter-stage hand-off payload: hidden states of the chunk
    p2p = ([2 * batch * ln * cfg.d_model / sp for ln in sched.lengths]
           if pp > 1 else None)
    ring_t = ring_exposed = ring_bwd_exposed = None
    if attn_mode == "ring" and sp > 1:
        layers = cfg.n_layers / pp
        fracs = cm.ring_hop_fractions(sp, causal=True, layout="zigzag")
        ring_t, ring_exposed, ring_bwd_exposed = [], [], []
        kv_end = 0
        for ln in sched.lengths:
            kv_end += ln
            hop_bytes = cm.ring_hop_bytes(cfg, kv_end / sp, batch)
            xfer = [0.0] + [hop_bytes / hw.ici_bw] * (sp - 1)
            # per-hop attention flops: local queries x one KV block
            hop_flops = (4.0 * batch * (ln / sp) * (kv_end / sp)
                         * cfg.n_heads * cfg.head_dim)
            comp_f = [f * hop_flops / hw.peak_flops_bf16 for f in fracs]
            comp_b = [c * cm.ATTN_BWD_RATIO for c in comp_f]
            _, exp_f, _ = sim.ring_overlap(comp_f, xfer)
            _, exp_b, _ = sim.ring_overlap(comp_b, xfer)
            ring_t.append(layers * sum(xfer))
            ring_exposed.append(layers * exp_f)
            ring_bwd_exposed.append(layers * exp_b)
    res = sim.simulate_schedule(
        times, pp=pp, msp=msp, split=msp_split,
        chunk_acts=act, alphas=alphas,
        d2h_bw=hw.d2h_bw, p2p_bytes=p2p, ici_bw=hw.ici_bw,
        bwd_ratio=bwd_ratio, prefetch=prefetch,
        off_wire_ratio=wire_ratio,
        ring_t=ring_t, ring_exposed=ring_exposed,
        ring_bwd_exposed=ring_bwd_exposed)
    total = res.total
    if offload_moments:
        total += sim.opt_update_transfer(
            n_params / chips,
            cm.moment_wire_bytes_per_param(opt_dtype, moments_dtype,
                                           row_len=cfg.d_model),
            hw.d2h_bw)
    return total, alphas, res


def admit_attn_mode(cfg, seq_len: int, batch: int, n_params: int,
                    pp: int, sp: int, hw: cm.Hardware = cm.H100,
                    modes: tuple = ("local", "gather_kv", "ring")) -> dict:
    """Per-stage HBM admission for each attention schedule (DESIGN.md §15).

    Returns ``{mode: (fits, demand_dict)}`` where the demand comes from
    ``costmodel.stage_attn_demand`` — the resident KV cache plus the
    schedule's transient (gathered KV / in-flight ring blocks) plus the
    stage's parameter shard, checked against ``hw.hbm_bytes``.  This is the
    gate that rejects a multi-million-token cell at ``attn_mode="local"``
    (full visible KV on every device) while admitting it at ``"ring"``
    (one resident shard + two in-flight blocks)."""
    out = {}
    for mode in modes:
        d = cm.stage_attn_demand(cfg, seq_len=seq_len, batch=batch, sp=sp,
                                 pp=pp, mode=mode, n_params=n_params)
        out[mode] = (d["total"] <= hw.hbm_bytes, d)
    return out


def choose_attn_mode(cfg, seq_len: int, batch: int, n_params: int,
                     pp: int, n: int, sp: int,
                     hw: cm.Hardware = cm.H100, *,
                     modes: tuple = ("local", "ring"),
                     **kw) -> Tuple[str, dict]:
    """Pick the fastest attention schedule among those that fit in HBM.

    Every mode in ``modes`` is first screened by ``admit_attn_mode``; the
    admitted ones are played out by ``simulate_candidate`` (extra solver
    kwargs pass through) and the fastest wins.  Returns ``(mode, report)``
    with the per-mode admission verdicts, demands, and simulated times."""
    admitted = admit_attn_mode(cfg, seq_len, batch, n_params, pp, sp, hw,
                               modes=modes)
    best = None
    report = {}
    for mode in modes:
        ok, demand = admitted[mode]
        if not ok:
            report[mode] = dict(admitted=False, demand=demand)
            continue
        t, _, _ = simulate_candidate(cfg, seq_len, batch, n_params, pp, n,
                                     sp, hw, attn_mode=mode, **kw)
        report[mode] = dict(admitted=True, demand=demand, est_time=t)
        if best is None or t < best[1]:
            best = (mode, t)
    assert best is not None, (
        f"no attention mode in {modes} fits in {hw.hbm_bytes} bytes of HBM")
    return best[0], report


def solve(cfg, seq_len: int, batch: int, n_params: int,
          data_size: int = 16, model_size: int = 16,
          hw: cm.Hardware = cm.H100, *, msp: bool = False) -> SolverResult:
    """Search (PP, N) under the §6.1 heuristics, scoring by simulation."""
    sp = model_size
    best = None
    cands: List[Tuple[int, int, float]] = []
    pps = [p for p in (1, 2, 4, 8, 16) if data_size % p == 0]
    for pp in pps:
        if cfg.n_layers < pp:
            continue
        max_n = max(1, seq_len // (MIN_CHUNK_TOKENS))
        min_n = max(1, seq_len // (MAX_CHUNK_TOKENS * 4))
        for n in sorted({1, 2, 4, 8, 16, 32, 64, 128}):
            if n < min_n or n > max_n or n > seq_len // sp:
                continue
            if pp > 1 and n < pp:
                continue
            if seq_len % (n * sp):
                continue
            t, alphas = iteration_time(cfg, seq_len, batch, n_params,
                                       pp, n, sp, hw, msp=msp)
            cands.append((pp, n, t))
            if best is None or t < best[2]:
                best = (pp, n, t, alphas)
    if best is None:  # fall back: no chunking (short sequences)
        t, alphas = iteration_time(cfg, seq_len, batch, n_params, 1, 1,
                                   sp, hw, msp=False)
        best = (1, 1, t, alphas)
        cands.append((1, 1, t))
    pp, n, t, alphas = best
    return SolverResult(pp=pp, n_chunks=n, sp=sp, est_time=t,
                        bubble_ratio=(pp - 1) / n,
                        alphas=alphas, candidates=tuple(cands))
