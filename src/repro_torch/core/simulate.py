"""Event-driven SPPO pipeline simulator (DESIGN.md §3).

A copy of ``repro/core/simulate.py`` (the JAX package; plain floats), held
against it by tests/test_torch_plan.py.

Plays an arbitrary feed-event schedule — plain subsequence pipeline or the
MSP ramp schedule (core/schedule.py) — over per-chunk costs on a per-stage
timeline with four lanes per stage:

  compute  — forward then backward of every event, dependency-chained
             across stages (event e on stage s needs stage s−1's output);
  p2p      — inter-stage activation hand-off (serialized per link);
  d2h      — sequence-aware offload of each event's tagged activations,
             gated by the §5.2 memory recurrence: compute of event e may
             not start until the offload of event e−2 has drained (the
             "make-room" rule — chunk e−1's offload hides under e's
             compute, exactly M_i = M_{i-1} + A_i − α_{i-1}A_{i-1});
  h2d      — backward reloads, prefetched in reverse event order; the
             backward of event e waits for its own reload.

The closed forms in core/schedule.py assume bubbles only at the pipeline
ends; the per-tick playout exposes what they cannot see — steady-phase
resynchronization, queued transfers, unhidden-D2H stalls — which is why the
solver (core/solver.py) scores candidates here rather than with
``total_time``/``msp_total_time``.

Everything is plain floats: importable anywhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.schedule import msp_ramp_schedule

FWD = "fwd"
BWD = "bwd"
D2H = "d2h"
H2D = "h2d"
P2P = "p2p"
RING = "ring"


@dataclass(frozen=True)
class LaneEvent:
    """One occupied interval on one lane of one stage's timeline."""

    stage: int
    lane: str           # fwd | bwd | d2h | h2d | p2p
    chunk: int
    sub: int
    n_sub: int
    start: float
    end: float


@dataclass(frozen=True)
class SimResult:
    total: float                 # iteration wall time (last lane event end)
    feed_events: tuple           # (chunk, sub, n_sub) sequence fed to stage 0
    stage_busy: tuple            # per-stage compute-lane busy seconds
    fill_bubble: tuple           # per-stage idle before the first compute
    drain_bubble: tuple          # per-stage idle after the last compute
    d2h_stall: float             # compute delay charged to unhidden offload
    h2d_stall: float             # backward delay waiting on reloads
    p2p_stall: float             # compute delay from the hand-off *wire*
                                 # (transfer + link queuing; upstream compute
                                 # wait is fill_bubble, not p2p)
    peak_units: tuple            # per-stage forward-pass peak activation units
    peak_units_full: tuple       # per-stage peak over fwd+bwd (with reloads)
    trace: tuple                 # LaneEvent timeline, time-sorted
    ring_stall: float = 0.0      # compute delay from exposed ring-attention
                                 # KV rotation (DESIGN.md §15) — the per-hop
                                 # transfer time ring_overlap could not hide
                                 # under the hop compute

    @property
    def bubble_ratio(self) -> float:
        """Idle fraction of the aggregate compute timeline."""
        p = len(self.stage_busy)
        if self.total <= 0.0:
            return 0.0
        return 1.0 - sum(self.stage_busy) / (p * self.total)


def plain_events(n_chunks: int) -> List[Tuple[int, int, int]]:
    """Feed-event form of the plain schedule: every chunk whole, in order."""
    return [(c, 0, 1) for c in range(n_chunks)]


def _xfer(nbytes: float, bw: Optional[float]) -> float:
    if not nbytes or not bw:
        return 0.0
    if bw == float("inf"):
        return 0.0
    return nbytes / bw


def ring_overlap(hop_compute: Sequence[float],
                 hop_xfer: Sequence[float]
                 ) -> Tuple[float, float, list]:
    """Per-hop playout of one layer's ring attention (DESIGN.md §15).

    hop_compute[h]: tile-compute seconds of hop h (the slowest rank's share
    — costmodel.ring_hop_fractions).  hop_xfer[h]: ICI transfer seconds of
    hop h's KV block (hop 0's block is already resident, so 0).

    Double-buffer recurrence: the send of hop h+1's block is issued at hop
    h's compute *start* (the executed schedule issues the ppermute before
    the partial-attention call), the link serializes transfers, and hop h's
    compute cannot start before its block has arrived.  Returns
    (wall, exposed, events): wall = attention wall time, exposed = wall
    minus total compute (the stall the chunk's critical path inherits),
    events = (kind, hop, start, end) intervals for tracing."""
    n = len(hop_compute)
    arrive = [0.0] * n
    link_free = 0.0
    t = 0.0
    exposed = 0.0
    events = []
    for h in range(n):
        start = max(t, arrive[h])
        exposed += start - t
        events.append(("compute", h, start, start + hop_compute[h]))
        if h + 1 < n:
            s0 = max(link_free, start)
            arrive[h + 1] = s0 + hop_xfer[h + 1]
            link_free = arrive[h + 1]
            if hop_xfer[h + 1]:
                events.append(("xfer", h + 1, s0, arrive[h + 1]))
        t = start + hop_compute[h]
    return t, exposed, events


def simulate(events: Sequence[Tuple[int, int, int]],
             chunk_costs: Sequence[float],
             *,
             pp: int,
             chunk_acts: Optional[Sequence[float]] = None,
             alphas: Optional[Sequence[float]] = None,
             d2h_bw: Optional[float] = None,
             h2d_bw: Optional[float] = None,
             p2p_bytes: Optional[Sequence[float]] = None,
             ici_bw: Optional[float] = None,
             bwd_ratio: float = 2.0,
             prefetch: str = "ahead",
             off_wire_ratio: float = 1.0,
             ring_t: Optional[Sequence[float]] = None,
             ring_exposed: Optional[Sequence[float]] = None,
             ring_bwd_exposed: Optional[Sequence[float]] = None) -> SimResult:
    """Play `events` through a pp-stage pipeline.

    events: (chunk, sub, n_sub) feed order for stage 0 (see
        schedule.msp_ramp_schedule / plain_events).  A sub-event carries
        1/n_sub of its chunk's cost, activation bytes, and p2p payload.
    chunk_costs: per-stage fwd+bwd seconds per *whole* chunk (the solver's
        F(N)/N units: one chunk through one stage's layers).
    chunk_acts/alphas: per-chunk Type-1 activation units and offload ratios
        (§5.2); omit (or alphas of 0) to disable the offload lanes.
    p2p_bytes: per-chunk hand-off payload bytes; with ici_bw drives the p2p
        lane (omit for free hand-offs).
    bwd_ratio: backward/forward cost split of the lumped chunk cost
        (2.0 = the standard 2x-fwd backward; 0.0 = forward-only playout).
    prefetch: H2D reload placement, mirroring ``ParallelPlan.prefetch``
        (DESIGN.md §12) — "ahead": the memory-mirror rule, reload of event
        e issued at the backward *start* of event e+1, hidden under its
        compute; "sync": autodiff placement, reload of event e issued only
        when e's own backward is ready, fully exposed on the critical path.
    off_wire_ratio: compressed-residency lane multiplier (DESIGN.md §14,
        ``costmodel.offload_wire_ratio``) — scales only the D2H/H2D
        transfer *volumes*; the memory recurrence stays in raw device
        units because what materializes and drains on device is the
        uncompressed tagged set (dequantization reconstructs full rows).
    ring_t / ring_exposed / ring_bwd_exposed: the ring-attention lane
        (DESIGN.md §15), per chunk.  ring_t is the total KV-rotation wire
        seconds of the chunk's attention (all hops, all resident layers) —
        drawn as a "ring" lane interval concurrent with the chunk's
        compute.  ring_exposed / ring_bwd_exposed are the parts the
        per-hop playout (``ring_overlap``, run upstream by the solver)
        could NOT hide under hop compute: they extend the chunk's forward /
        backward compute and accumulate into ``ring_stall``.  (The backward
        re-rotates the blocks — the remat'd attention backward replays the
        ring — so it carries its own lane occupancy and exposure.)

    Forward runs events in feed order, backward in reverse (the runner
    differentiates an unrolled forward loop, so each stage finishes all
    forward work before its first backward — DESIGN.md §3).
    """
    assert prefetch in ("ahead", "sync"), prefetch
    events = list(events)
    ne = len(events)
    if ne == 0 or pp < 1:
        return SimResult(0.0, tuple(events), (0.0,) * pp, (0.0,) * pp,
                         (0.0,) * pp, 0.0, 0.0, 0.0, (0.0,) * pp,
                         (0.0,) * pp, ())
    n_chunks = len(chunk_costs)
    alphas = list(alphas) if alphas is not None else [0.0] * n_chunks
    acts = list(chunk_acts) if chunk_acts is not None else [0.0] * n_chunks
    h2d_bw = h2d_bw if h2d_bw is not None else d2h_bw

    f_frac = 1.0 / (1.0 + bwd_ratio)
    fcost = [chunk_costs[c] * f_frac / ns for c, _, ns in events]
    bcost = [chunk_costs[c] * (1.0 - f_frac) / ns for c, _, ns in events]
    off_t = [_xfer(off_wire_ratio * alphas[c] * acts[c] / ns, d2h_bw)
             for c, _, ns in events]
    rld_t = [_xfer(off_wire_ratio * alphas[c] * acts[c] / ns, h2d_bw)
             for c, _, ns in events]
    p2p_t = [_xfer((p2p_bytes[c] if p2p_bytes else 0.0) / ns, ici_bw)
             for c, _, ns in events]
    rng_t = [(ring_t[c] if ring_t else 0.0) / ns for c, _, ns in events]
    rexp_f = [(ring_exposed[c] if ring_exposed else 0.0) / ns
              for c, _, ns in events]
    rexp_b = [(ring_bwd_exposed[c] if ring_bwd_exposed else 0.0) / ns
              for c, _, ns in events]

    trace: List[LaneEvent] = []
    busy = [0.0] * pp
    first_start = [0.0] * pp
    last_end = [0.0] * pp
    d2h_stall = h2d_stall = p2p_stall = 0.0
    ring_stall = 0.0
    # per-stage memory deltas: (time, priority, delta, phase); priority 0
    # applies drains before materializations at timestamp ties, so an
    # offload that exactly fills its hiding window is credited before the
    # next-but-one chunk materializes — the recurrence ordering of
    # offload.peak_memory (peak_i counts drains of chunks <= i-2 only,
    # DESIGN.md §3.2).  phase 0 events bound the forward-pass peak.
    mem: List[List[Tuple[float, int, float, int]]] = [[] for _ in range(pp)]

    # ---- forward ----------------------------------------------------------
    fwd_end = [[0.0] * ne for _ in range(pp)]       # compute completion
    arrival = [[0.0] * ne for _ in range(pp)]       # input availability
    d2h_end = [[0.0] * ne for _ in range(pp)]       # offload completion
    for s in range(pp):
        comp_free = 0.0
        p2p_free = 0.0
        d2h_free = 0.0
        for e, (c, sub, ns) in enumerate(events):
            ready = max(comp_free, arrival[s][e])
            gate = d2h_end[s][e - 2] if e >= 2 else 0.0
            if gate > ready:
                d2h_stall += gate - ready
            if s > 0 and arrival[s][e] > max(comp_free, gate):
                # only the wire component (transfer + link queuing) counts
                # as hand-off stall; waiting on the upstream *compute* is
                # the ordinary fill bubble, reported separately
                wire = arrival[s][e] - fwd_end[s - 1][e]
                p2p_stall += min(wire, arrival[s][e] - max(comp_free, gate))
            start = max(ready, gate)
            end = start + fcost[e] + rexp_f[e]
            ring_stall += rexp_f[e]
            if rng_t[e]:
                trace.append(LaneEvent(s, RING, c, sub, ns, start,
                                       start + rng_t[e]))
            if e == 0:
                first_start[s] = start
            fwd_end[s][e] = end
            comp_free = end
            busy[s] += fcost[e]
            trace.append(LaneEvent(s, FWD, c, sub, ns, start, end))
            mem[s].append((start, 1, acts[c] / ns, 0))
            if s + 1 < pp:
                p_start = max(end, p2p_free)
                p_end = p_start + p2p_t[e]
                p2p_free = p_end
                arrival[s + 1][e] = p_end
                if p2p_t[e]:
                    trace.append(LaneEvent(s, P2P, c, sub, ns, p_start, p_end))
            if alphas[c] > 0.0:
                d_start = max(end, d2h_free)
                d_end = d_start + off_t[e]
                d2h_free = d_end
                d2h_end[s][e] = d_end
                trace.append(LaneEvent(s, D2H, c, sub, ns, d_start, d_end))
                mem[s].append((d_end, 0, -alphas[c] * acts[c] / ns, 0))

    # ---- backward ---------------------------------------------------------
    if bwd_ratio > 0.0:
        bwd_end = [[0.0] * ne for _ in range(pp)]
        barrive = [[0.0] * ne for _ in range(pp)]
        for s in range(pp - 1, -1, -1):
            comp_free = fwd_end[s][ne - 1]          # all fwd first, then bwd
            p2p_free = 0.0
            # the reload lane opens at the stage's first-*backward*
            # readiness, not its last forward: the runner's drain hand-off
            # (link_drain) issues the first H2D with the first cotangent,
            # which on stages < pp−1 arrives only after the downstream
            # backward + hand-off (barrive).  The old fwd_end init let
            # upstream stages pre-load during their drain bubble — a
            # placement the executed program has no dataflow for.
            bwd_ready0 = fwd_end[s][ne - 1]
            if s < pp - 1:
                bwd_ready0 = max(bwd_ready0, barrive[s][ne - 1])
            h2d_free = bwd_ready0
            h2d_done = [0.0] * ne
            prev_bwd_start = bwd_ready0
            for e in range(ne - 1, -1, -1):
                c, sub, ns = events[e]
                up = (fwd_end[s][e] if s == pp - 1 else barrive[s][e])
                ready = max(comp_free, up)
                if alphas[c] > 0.0:
                    if prefetch == "ahead":
                        # memory-mirror prefetch: reload of event e hides
                        # under the backward of event e+1 (whose activations
                        # are still resident), never earlier — keeps the
                        # backward peak bounded by the forward peak
                        # (DESIGN.md §3.2).
                        h_start = max(h2d_free, d2h_end[s][e],
                                      prev_bwd_start)
                    else:
                        # sync: autodiff places the reload inside event e's
                        # own remat replay — it cannot issue before e's
                        # backward is otherwise ready, and is fully exposed
                        h_start = max(h2d_free, d2h_end[s][e], ready)
                    h_end = h_start + rld_t[e]
                    h2d_free = h_end
                    h2d_done[e] = h_end
                    trace.append(LaneEvent(s, H2D, c, sub, ns, h_start, h_end))
                    mem[s].append((h_end, 1, alphas[c] * acts[c] / ns, 1))
                if alphas[c] > 0.0 and h2d_done[e] > ready:
                    h2d_stall += h2d_done[e] - ready
                start = max(ready, h2d_done[e])
                prev_bwd_start = start
                end = start + bcost[e] + rexp_b[e]
                ring_stall += rexp_b[e]
                if rng_t[e]:
                    trace.append(LaneEvent(s, RING, c, sub, ns, start,
                                           start + rng_t[e]))
                bwd_end[s][e] = end
                comp_free = end
                busy[s] += bcost[e]
                trace.append(LaneEvent(s, BWD, c, sub, ns, start, end))
                mem[s].append((end, 0, -acts[c] / ns, 1))
                if s > 0:
                    p_start = max(end, p2p_free)
                    p_end = p_start + p2p_t[e]
                    p2p_free = p_end
                    barrive[s - 1][e] = p_end
                    if p2p_t[e]:
                        trace.append(
                            LaneEvent(s, P2P, c, sub, ns, p_start, p_end))
        for s in range(pp):
            last_end[s] = bwd_end[s][0]
    else:
        for s in range(pp):
            last_end[s] = fwd_end[s][ne - 1]

    total = max(ev.end for ev in trace)
    peaks_fwd, peaks_full = [], []
    for s in range(pp):
        m = peak_f = peak = 0.0
        for _, _, delta, phase in sorted(mem[s], key=lambda x: (x[0], x[1])):
            m += delta
            peak = max(peak, m)
            if phase == 0:
                peak_f = max(peak_f, m)
        peaks_fwd.append(peak_f)
        peaks_full.append(peak)
    trace.sort(key=lambda ev: (ev.start, ev.stage, ev.lane))
    return SimResult(
        total=total,
        feed_events=tuple(events),
        stage_busy=tuple(busy),
        fill_bubble=tuple(first_start),
        drain_bubble=tuple(total - t for t in last_end),
        d2h_stall=d2h_stall,
        h2d_stall=h2d_stall,
        p2p_stall=p2p_stall,
        peak_units=tuple(peaks_fwd),
        peak_units_full=tuple(peaks_full),
        trace=tuple(trace),
        ring_stall=ring_stall,
    )


def simulate_schedule(chunk_costs: Sequence[float], *, pp: int,
                      msp: bool = False, split: int = 2,
                      **kw) -> SimResult:
    """Convenience wrapper: plain or MSP-ramp feed events over `chunk_costs`."""
    n = len(chunk_costs)
    ev = msp_ramp_schedule(n, pp, split) if msp and pp > 1 else plain_events(n)
    return simulate(ev, chunk_costs, pp=pp, **kw)


def opt_update_transfer(n_params_local: int, moment_bytes_per_param: float,
                        d2h_bw: Optional[float],
                        h2d_bw: Optional[float] = None) -> float:
    """Post-step optimizer-transfer time for host-resident AdamW moments
    (DESIGN.md §11): the update stages one H2D of the full local moment set
    onto the device and one D2H writes the new moments back.  Unlike the
    activation offload of §5.2 there is no next-chunk compute left to hide
    under — the last backward has already drained — so the solver charges
    the full round trip as an epilogue on the iteration time."""
    vol = n_params_local * moment_bytes_per_param
    h2d_bw = h2d_bw if h2d_bw is not None else d2h_bw
    return _xfer(vol, h2d_bw) + _xfer(vol, d2h_bw)


def spmd_tick_peak(events: Sequence[Tuple[int, int, int]], *, pp: int,
                   chunk_acts: Sequence[float],
                   alphas: Sequence[float],
                   chunk_scales: Optional[Sequence[float]] = None
                   ) -> Tuple[float, list]:
    """Predicted §5.2 memory recurrence of the *lock-step SPMD* tick loop
    (parallel/runner.py, pp > 1): every stage materializes one tagged set
    per tick — including the pp−1 drain ticks, which replay the last feed
    event's chunk (masked compute, real allocation), and MSP sub-events,
    which rematerialize their full chunk (DESIGN.md §2).  This is the
    apples-to-apples prediction for the memledger's measured per-tick
    ledger; the per-stage event playout above (`simulate`) remains the
    idealized pipeline target.  Returns (peak, per-tick resident).

    chunk_scales: per-chunk device-resident codec scale bytes of the rows
    that offload (DESIGN.md §14) — they materialize with the chunk like
    its activations but never drain with the off rows (they stay on device
    until the backward consumes them); caller pre-multiplies by the
    deployed (quantized) α, mirroring how the off-bytes drain is scaled."""
    events = list(events)
    ne = len(events)
    if ne == 0:
        return 0.0, []
    scales = (list(chunk_scales) if chunk_scales is not None
              else [0.0] * len(chunk_acts))
    n_ticks = ne + max(pp, 1) - 1
    resident = []
    m = 0.0
    prev_off = 0.0
    peak = 0.0
    for t in range(n_ticks):
        c = events[min(t, ne - 1)][0]
        a = chunk_acts[c]
        m += a + scales[c]
        peak = max(peak, m)
        resident.append(m)
        m -= prev_off
        prev_off = alphas[c] * a
    return peak, resident
