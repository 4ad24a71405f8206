"""SPPO sequence partitioning (§3.2, §5.2): length-based vs FLOPs-balanced.

A copy of ``repro/core/partition.py`` (the JAX package): the uniform
layout, held against it by tests/test_torch_kernels.py, and the packed
variable-length layout (DESIGN.md §13), held against it by
tests/test_torch_varlen.py.  For causal
attention the per-token cost grows with position: processing tokens [a, b)
of a sequence costs
    F(a, b) = c_lin * (b - a) + c_attn * (b^2 - a^2) / 2
so the FLOPs-balanced partition makes earlier chunks longer in tokens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class ChunkSchedule:
    """Static per-sequence chunk plan."""

    lengths: tuple            # tokens per chunk
    offsets: tuple            # start position per chunk
    seq_len: int
    policy: str

    @property
    def n(self) -> int:
        return len(self.lengths)


def flops_per_token_ratio(cfg) -> float:
    """c_attn / c_lin: relative weight of the position-dependent attention
    term vs the position-independent (projections + MLP) term, per layer."""
    d = cfg.d_model
    lin = 12 * d * d  # rough per-token matmul cost (qkv+o+mlp), scale-free
    if cfg.family == "ssm":
        return 0.0
    attn = 4 * cfg.n_heads * cfg.hd  # per (token, kv-token) qk+av cost
    return attn / lin


def chunk_cost(a: int, b: int, r: float) -> float:
    """Relative cost of processing tokens [a, b) causally; r = c_attn/c_lin."""
    return (b - a) + r * (b * b - a * a) / 2.0


def _clamp_chunks(seq_len: int, n: int, multiple: int) -> int:
    """Largest feasible chunk count: every chunk needs >= max(multiple, 1)
    tokens, so n*multiple > seq_len degrades to fewer chunks, never to
    zero-length (or negative) chunks."""
    return max(1, min(n, seq_len // max(multiple, 1)))


def partition_length(seq_len: int, n: int, multiple: int = 1) -> ChunkSchedule:
    n = _clamp_chunks(seq_len, n, multiple)
    if n == 1:  # single chunk: the multiple constraint is vacuous
        return ChunkSchedule((seq_len,), (0,), seq_len, "length")
    # base >= multiple by the feasibility clamp (n <= seq_len // multiple);
    # the last chunk absorbs the non-divisible remainder.
    base = seq_len // n // max(multiple, 1) * max(multiple, 1)
    lens = [base] * n
    lens[-1] += seq_len - base * n
    offs = [sum(lens[:i]) for i in range(n)]
    return ChunkSchedule(tuple(lens), tuple(offs), seq_len, "length")


def partition_flops(seq_len: int, n: int, r: float,
                    multiple: int = 1) -> ChunkSchedule:
    """FLOPs-balanced boundaries: F(0, b_1) = F(b_1, b_2) = ... (§4 workflow).

    Solve F(0, b_i) = (i/n) * F(0, S) for each boundary:
        b + r b^2/2 = (i/n)(S + r S^2/2)   (quadratic in b).
    Boundaries are rounded to ``multiple`` (sequence-shard divisibility).
    """
    n = _clamp_chunks(seq_len, n, multiple)
    if r <= 0 or n == 1:
        return partition_length(seq_len, n, multiple)
    total = chunk_cost(0, seq_len, r)
    bounds = [0]
    mult = max(multiple, 1)
    for i in range(1, n):
        target = total * i / n
        # solve r/2 b^2 + b - target = 0
        b = (-1 + math.sqrt(1 + 2 * r * target)) / r
        b = int(round(b / mult)) * mult
        # lower clamp first, upper clamp last.  The cap reserves >= mult
        # tokens per remaining chunk *in aligned units*: with a non-divisible
        # seq_len, `seq_len - (n - i) * mult` is itself unaligned and would
        # leak a misaligned interior boundary (e.g. S=37, mult=16 -> 21).
        # bounds[i-1] + mult never exceeds the cap once n is feasibility-
        # clamped, so by induction every length stays positive and every
        # interior boundary stays multiple-aligned; only the last chunk
        # absorbs the remainder.
        b = min((seq_len // mult - (n - i)) * mult, max(b, bounds[-1] + mult))
        bounds.append(b)
    bounds.append(seq_len)
    lens = tuple(bounds[i + 1] - bounds[i] for i in range(n))
    assert all(l > 0 for l in lens) and sum(lens) == seq_len
    return ChunkSchedule(lens, tuple(bounds[:-1]), seq_len, "flops")


def partition(seq_len: int, n: int, cfg, policy: str = "flops",
              multiple: int = 1) -> ChunkSchedule:
    n = max(1, min(n, seq_len // max(multiple, 1)))  # feasibility clamp
    r = flops_per_token_ratio(cfg)
    if policy == "flops" and r > 0 and n > 1:
        return partition_flops(seq_len, n, r, multiple)
    return partition_length(seq_len, n, multiple)


def chunk_costs(sched: ChunkSchedule, r: float) -> list:
    """Relative cost of each chunk of ``sched`` (``chunk_cost`` of its
    tokens); the offload planner scales them to seconds."""
    return [chunk_cost(a, a + l, r)
            for a, l in zip(sched.offsets, sched.lengths)]


# ---------------------------------------------------------------------------
# Packed variable-length layouts (FlexSP / Seq1F1B adaptation, DESIGN.md §13)
# ---------------------------------------------------------------------------
#
# A packed batch keeps each document contiguous inside a fixed-width row of
# ``seq_len`` tokens (tail padding only).  Causal attention restarts at every
# document boundary, so the per-position cost profile is sawtoothed — a token
# at in-document offset d costs 1 + r*d (its causal window is d+1 tokens) —
# instead of the single triangle the uniform-sequence partitioner assumes.
# ``packed_cost_profile`` materializes that profile summed over the batch
# rows and ``partition_profile`` equalizes its cumulative sum (the Seq1F1B
# FLOPs-balance generalized to arbitrary profiles), snapping boundaries to
# nearby aligned document boundaries where possible.


def pack_lengths(lengths: Sequence[int], seq_len: int) -> List[List[int]]:
    """Greedy first-fit-decreasing bin packing of document lengths into rows
    of ``seq_len`` tokens.  Returns, per row, the list of *document indices*
    (into ``lengths``) in placement order.  Every document is placed exactly
    once — no drops, no duplicates, no splits (each length must fit a row)."""
    order = sorted(range(len(lengths)), key=lambda i: (-lengths[i], i))
    rows: List[List[int]] = []
    free: List[int] = []
    for i in order:
        ln = int(lengths[i])
        assert 0 < ln <= seq_len, f"doc {i} length {ln} vs row {seq_len}"
        for rix, f in enumerate(free):
            if f >= ln:
                rows[rix].append(i)
                free[rix] -= ln
                break
        else:
            rows.append([i])
            free.append(seq_len - ln)
    return rows


def packed_cost_profile(row_lens: Sequence[Sequence[int]], seq_len: int,
                        r: float) -> np.ndarray:
    """Per-position relative cost [seq_len] of a packed batch, summed over
    rows.  ``row_lens[row]`` lists the document lengths packed into that row
    (contiguous, in order, tail-padded).  A real token at in-document offset
    d costs 1 + r*d; padding positions cost 1 (they still ride the dense
    projections/MLP) with no attention term (fully masked)."""
    prof = np.zeros(seq_len, dtype=np.float64)
    for lens in row_lens:
        pos = 0
        for ln in lens:
            ln = int(ln)
            prof[pos:pos + ln] += 1.0 + r * np.arange(ln, dtype=np.float64)
            pos += ln
        assert pos <= seq_len, f"row overflows: {sum(lens)} > {seq_len}"
        prof[pos:] += 1.0
    return prof


def partition_profile(profile: Sequence[float], n: int, multiple: int = 1,
                      doc_bounds: Optional[Sequence[int]] = None
                      ) -> ChunkSchedule:
    """Chunk boundaries equalizing the cumulative cost ``profile`` (the
    packed-layout generalization of :func:`partition_flops`).  Boundaries
    are rounded to ``multiple``; when ``doc_bounds`` (global positions where
    a document starts in every row of the packed layout) offers an aligned
    boundary near the cost-balanced one, it is preferred so chunks respect
    document boundaries where possible."""
    prof = np.asarray(profile, dtype=np.float64)
    seq_len = int(prof.shape[0])
    n = _clamp_chunks(seq_len, n, multiple)
    if n == 1:
        return ChunkSchedule((seq_len,), (0,), seq_len, "flops-packed")
    mult = max(multiple, 1)
    cum = np.cumsum(prof)
    total = float(cum[-1])
    aligned_docs = sorted(int(b) for b in (doc_bounds or ())
                          if 0 < b < seq_len and b % mult == 0)
    bounds = [0]
    for i in range(1, n):
        target = total * i / n
        b = int(np.searchsorted(cum, target)) + 1
        b = int(round(b / mult)) * mult
        # aligned cap, as in partition_flops: keep interior boundaries on
        # the multiple even when seq_len % mult != 0
        lo, hi = bounds[-1] + mult, (seq_len // mult - (n - i)) * mult
        b = min(hi, max(b, lo))
        # prefer a document boundary within half a mean chunk of the
        # balanced position (it can only cost a bounded imbalance)
        window = max(mult, seq_len // (2 * n))
        cand = [d for d in aligned_docs if lo <= d <= hi
                and abs(d - b) <= window]
        if cand:
            b = min(cand, key=lambda d: abs(d - b))
        bounds.append(b)
    bounds.append(seq_len)
    lens = tuple(bounds[i + 1] - bounds[i] for i in range(n))
    assert all(l > 0 for l in lens) and sum(lens) == seq_len
    return ChunkSchedule(lens, tuple(bounds[:-1]), seq_len, "flops-packed")


def aligned_doc_bounds(row_lens: Sequence[Sequence[int]],
                       seq_len: int) -> List[int]:
    """Positions that are document boundaries in *every* row of the packed
    layout — a chunk cut there never splits a document.  A row's tail
    padding region counts as all-boundary (cutting padding is free)."""
    common: Optional[set] = None
    for lens in row_lens:
        lens = [int(l) for l in lens]
        cuts = set(np.cumsum(lens).tolist()) if lens else set()
        cuts |= set(range(sum(lens), seq_len + 1))
        common = cuts if common is None else (common & cuts)
    return sorted(b for b in (common or ()) if 0 < b < seq_len)


def profile_chunk_costs(profile: Sequence[float],
                        sched: ChunkSchedule) -> List[float]:
    """Per-chunk cost sums of a packed-layout profile under ``sched``."""
    prof = np.asarray(profile, dtype=np.float64)
    return [float(prof[a:a + l].sum())
            for a, l in zip(sched.offsets, sched.lengths)]


def imbalance(values: Sequence[float]) -> float:
    """max/mean ratio — 1.0 == perfectly balanced (Fig. 4/5 metric)."""
    values = list(values)
    return max(values) / (sum(values) / len(values))
