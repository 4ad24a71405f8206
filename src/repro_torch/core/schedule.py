"""SPPO adaptive pipeline schedule (§6): ticks, bubbles, MSP (Defs 6.1/6.2).

A copy of ``repro/core/schedule.py`` (the JAX package; plain Python), held
against it by tests/test_torch_plan.py.

The subsequence pipeline: stage s processes chunk c = t − s at tick t,
t ∈ [0, N + pp − 1).  Bubble model (§3.3):
    t_b = (p−1)·F(N)/N,   R_b = (p−1)/N,   T = (p−1+N)/N · F(N).

Multiplexed sequence partitioning (§6.2) is implemented two ways:
  * the paper's phase tables (Definition 6.1/6.2) verbatim — property-tested;
  * an executable *ramp-chunk* schedule for the SPMD pipeline: the
    bubble-adjacent chunks (the first and last pp−1) are split into `split`
    sub-chunks processed at 1/split duration, so fill/drain bubbles shrink
    from (p−1)·F/N to (p−1)·F/(split·N) — DESIGN.md §2 records why the
    per-stage-divergent original formulation is adapted this way for an
    SPMD pipeline.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Set, Tuple


# ---------------------------------------------------------------------------
# Bubble model (§3.3)
# ---------------------------------------------------------------------------


def bubble_ratio(pp: int, n: int) -> float:
    return (pp - 1) / n


def total_time(pp: int, n: int, f_n: float) -> float:
    """T = (p−1+N)/N · F(N)."""
    return (pp - 1 + n) / n * f_n


# ---------------------------------------------------------------------------
# Tick schedule
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Tick:
    """One pipeline tick. chunk_of(stage) = tick − stage (None if idle)."""

    index: int
    sub: int = 0          # MSP sub-chunk index within the chunk
    n_sub: int = 1        # number of sub-chunks this tick's chunk is split into


def ticks(n_chunks: int, pp: int) -> List[int]:
    """Plain SPPO schedule: tick t feeds chunk t into stage 0."""
    return list(range(n_chunks + pp - 1))


def chunk_at(tick: int, stage: int, n_chunks: int):
    c = tick - stage
    return c if 0 <= c < n_chunks else None


def msp_ramp_schedule(n_chunks: int, pp: int, split: int = 2
                      ) -> List[Tuple[int, int, int]]:
    """Executable MSP: list of (chunk, sub, n_sub) feed events for stage 0.

    The first and last (pp−1) chunks are split into `split` sub-chunks;
    steady chunks are whole.  Fill/drain bubble cost scales by 1/split."""
    ramp = min(pp - 1, n_chunks // 2)
    events = []
    for c in range(n_chunks):
        if c < ramp or c >= n_chunks - ramp:
            events.extend((c, s, split) for s in range(split))
        else:
            events.append((c, 0, 1))
    return events


def msp_total_time(pp: int, n: int, f_n: float, split: int = 2) -> float:
    """Analytic cost of the ramp schedule: steady ticks cost F/N, ramp
    sub-ticks cost F/(N·split); bubbles are (pp−1) sub-ticks on each side."""
    per_chunk = f_n / n
    ramp = min(pp - 1, n // 2)
    steady = (n - 2 * ramp) * per_chunk
    ramp_t = 2 * ramp * per_chunk            # same total work, split finer
    bubble = (pp - 1) * per_chunk / split
    return steady + ramp_t + bubble


# ---------------------------------------------------------------------------
# Paper Definitions 6.1 / 6.2 — phase ID mapping and communication scope
# ---------------------------------------------------------------------------


def left_sp_ids(pp: int, n: int, stage: int) -> Set[int]:
    """Subsequences stage handles in its Left-SP (fill-bubble) phase:
    {0 .. PP−2−stage} (Table 3)."""
    return set(range(0, pp - 1 - stage))


def right_sp_ids(pp: int, n: int, stage: int) -> Set[int]:
    """Right-SP (drain-bubble) phase: {N−stage .. N−1} (Table 3)."""
    return set(range(max(0, n - stage), n))


def steady_ids(pp: int, n: int, stage: int) -> Set[int]:
    """Steady phase (adaptive offloading): {PP−1−stage .. N−1−stage}."""
    return set(range(pp - 1 - stage, n - stage))


def comm_scope(pp: int, stage: int, phase: str) -> Set[int]:
    """Def 6.2: inter-stage communication range C(i) per phase."""
    if phase == "left":
        return set(range(stage, pp))
    if phase == "steady":
        return set(range(0, pp))
    if phase == "right":
        return set(range(0, stage + 1))
    raise ValueError(phase)


def msp_phase_table(pp: int, n: int) -> dict:
    """Reproduces Table 3 of the paper for arbitrary (PP, N)."""
    table = {}
    for s in range(pp):
        left = left_sp_ids(pp, n, s)
        right = right_sp_ids(pp, n, s)
        steady = steady_ids(pp, n, s)
        table[s] = {
            "left": left,
            "steady": steady,
            "right": right,
            "left_sp_range": comm_scope(pp, s, "left") if left else set(),
            "right_sp_range": comm_scope(pp, s, "right") if right else set(),
        }
    return table
