"""SPPO sequence partitioning (§3.2, §5.2): length-based vs FLOPs-balanced.

A copy of the uniform-layout half of ``repro/core/partition.py`` (the JAX
package), held against it by tests/test_torch_kernels.py.  For causal
attention the per-token cost grows with position: processing tokens [a, b)
of a sequence costs
    F(a, b) = c_lin * (b - a) + c_attn * (b^2 - a^2) / 2
so the FLOPs-balanced partition makes earlier chunks longer in tokens.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


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
