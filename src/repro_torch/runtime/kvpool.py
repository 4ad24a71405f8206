"""Paged/blocked KV-cache pool for continuous-batching decode (port of
``repro/runtime/kvpool.py``, DESIGN.md §16; numpy, copied word for word but
for the cost model, the port's ``core/costmodel.py``, and the sink below).

The static serve path gives every request a private, maximum-length cache
row.  The pool instead shares one physical buffer per (data, model) rank and
layer — ``[P_loc, Hkv, hd]`` with ``P_loc = n_blocks * block_tokens`` — and
maps each request slot's *logical* cache through a host-managed block table,
so slots of different lengths share device memory and freed blocks are
recycled across requests.

Geometry (all per model rank; the model axis keeps its sequence sharding):

  * prompts are right-aligned into a fixed bucket of ``s_bucket`` tokens, so
    the prefill region of every request occupies logical slots
    ``[0, base)`` with ``base = s_bucket // sp`` — exactly the prefill cell's
    chunk-contiguous layout, which lets ingest copy cache rows by identity;
  * decode token ``d`` lives on rank ``d % sp`` at logical slot
    ``base + d // sp`` (the striped layout of ``make_serve_step``);
  * logical slot ``j`` therefore has a *static* global position — the
    per-rank ``pos_map`` — shared by every request, so the pool needs no
    per-slot position tags: a slot beyond a request's write frontier holds
    garbage, but its position exceeds the causal horizon and the kernel
    masks it (allocation covers the full budget up front, see below).

Allocation is per admission, wholesale: a request gets
``blocks_for(max_new)`` blocks when it is admitted and returns all of them
on eviction.  No mid-flight growth means the block table pushed at admission
stays valid for the request's whole lifetime, which is what keeps the decode
loop free of host round trips.

The sink (the port's): torch has no scatter that drops an out-of-range
index (jnp's ``mode="drop"``, which the reference's pool writes use for
inactive rows, non-owning ranks and rows outside an admission): on CUDA
such an index is a device-side assert, and -1 wraps onto the last slot.  So
each layer's pool buffer holds ``SINK_SLOTS`` more slot past ``p_loc``;
every write that the reference drops lands there instead, and no gather
reads it (a gathered slot is ``max(block, 0) * block_tokens + j %
block_tokens < p_loc``).  Its bytes are ``sink_bytes``, a closed form of
their own beside ``PoolGeometry.pool_bytes``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core import costmodel as cm


@dataclass(frozen=True)
class PoolGeometry:
    """Static shape of the pool on one (data, model) rank."""

    s_bucket: int       # padded prompt bucket, global tokens
    sp: int             # model-axis size (sequence shards)
    max_new: int        # decode budget per request, global tokens
    block_tokens: int   # logical slots per block (per rank)
    n_blocks: int       # physical blocks (per rank)
    n_slots: int        # request slots (engine batch)

    def __post_init__(self):
        assert self.s_bucket % self.sp == 0, (
            f"s_bucket {self.s_bucket} must divide by sp {self.sp}")
        assert self.block_tokens >= 1 and self.n_blocks >= 1
        assert self.max_new >= 1

    @property
    def base(self) -> int:
        """Prefill logical slots per rank."""
        return self.s_bucket // self.sp

    @property
    def dec_loc(self) -> int:
        """Decode logical slots per rank at the full budget."""
        return -(-self.max_new // self.sp)

    @property
    def l_loc(self) -> int:
        """Logical cache length per request per rank (the gather extent)."""
        return self.base + self.dec_loc

    @property
    def max_blocks(self) -> int:
        """Block-table width: blocks per request at the full budget."""
        return -(-self.l_loc // self.block_tokens)

    @property
    def p_loc(self) -> int:
        """Physical pool slots per rank."""
        return self.n_blocks * self.block_tokens

    def blocks_for(self, max_new: int) -> int:
        """Blocks a request decoding <= max_new tokens needs (prompt included)."""
        assert 1 <= max_new <= self.max_new, (
            f"max_new {max_new} exceeds pool decode budget {self.max_new}")
        return -(-(self.base + -(-max_new // self.sp)) // self.block_tokens)

    def pool_bytes(self, cfg, n_layers: int,
                   itemsize: int = cm.ACT_ITEMSIZE) -> int:
        """Device bytes of the pool arrays on one rank (the Type-0 channel)."""
        return int(cm.kv_pool_bytes(cfg, self.n_blocks, self.block_tokens,
                                    n_layers, itemsize=itemsize))


def pos_map(geo: PoolGeometry, sched) -> np.ndarray:
    """[sp, l_loc] int32: global position of logical slot j on each rank.

    The prefill region mirrors the prefill cell's chunk-contiguous layout
    (chunk at offset ``off`` with local length ``lloc`` puts rank r's shard
    at positions ``off + r*lloc + arange(lloc)``); the decode region is the
    striped layout of the static serve path.
    """
    sp = geo.sp
    out = np.empty((sp, geo.l_loc), np.int32)
    covered = 0
    for off, ln in zip(sched.offsets, sched.lengths):
        if off >= geo.s_bucket:
            break
        ln = min(ln, geo.s_bucket - off)
        assert ln % sp == 0, f"chunk length {ln} not divisible by sp {sp}"
        lloc = ln // sp
        j0 = off // sp
        for r in range(sp):
            out[r, j0:j0 + lloc] = off + r * lloc + np.arange(lloc)
        covered += ln
    assert covered == geo.s_bucket, (
        f"schedule covers {covered} tokens, bucket is {geo.s_bucket}")
    for r in range(sp):
        e = np.arange(geo.dec_loc)
        out[r, geo.base:] = geo.s_bucket + e * sp + r
    return out


class BlockPool:
    """Host-side free-list allocator over the physical blocks of one pool.

    Tracks peak concurrent usage and lifetime allocation volume so tests can
    assert that freed blocks are actually recycled (total allocated over a
    trace exceeding ``n_blocks`` while peak stays within it).
    """

    def __init__(self, n_blocks: int):
        self.n_blocks = n_blocks
        self._free: List[int] = list(range(n_blocks - 1, -1, -1))
        self.peak_used = 0
        self.total_allocated = 0

    @property
    def used(self) -> int:
        return self.n_blocks - len(self._free)

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise MemoryError(
                f"pool exhausted: need {n} blocks, {len(self._free)} free "
                f"of {self.n_blocks}")
        blocks = [self._free.pop() for _ in range(n)]
        self.total_allocated += n
        self.peak_used = max(self.peak_used, self.used)
        return blocks

    def free(self, blocks: Sequence[int]):
        for b in blocks:
            assert 0 <= b < self.n_blocks and b not in self._free, (
                f"double free of block {b}")
            self._free.append(b)


def concurrent_peak(intervals: Sequence[Tuple[int, int, int]]) -> int:
    """Analytic peak of ``sum(weight)`` over overlapping [start, end)
    intervals — the bound a BlockPool trace replay must not exceed."""
    events: List[Tuple[int, int]] = []
    for start, end, weight in intervals:
        events.append((start, weight))
        events.append((end, -weight))
    peak = cur = 0
    for _, delta in sorted(events, key=lambda e: (e[0], e[1])):
        cur += delta
        peak = max(peak, cur)
    return peak


def block_table_row(geo: PoolGeometry, blocks: Sequence[int]) -> np.ndarray:
    """[max_blocks] int32 row for one request: its blocks in logical order,
    -1 beyond its allocation (the device side clamps and causally masks)."""
    row = np.full((geo.max_blocks,), -1, np.int32)
    row[:len(blocks)] = np.asarray(blocks, np.int32)
    return row


SINK_SLOTS = 1   # slots past p_loc in each layer's pool buffer (the port's)


def sink_bytes(cfg, n_layers: int, itemsize: int = cm.ACT_ITEMSIZE) -> int:
    """Device bytes of the sink slots on one rank: ``SINK_SLOTS`` tokens'
    k + v rows in every layer."""
    return int(SINK_SLOTS * cm.kv_bytes_per_token(cfg, itemsize) * n_layers)


def device_pool_bytes(geo: PoolGeometry, cfg, n_layers: int,
                      itemsize: int = cm.ACT_ITEMSIZE) -> int:
    """What one rank's pool buffers hold: the pool's blocks
    (``PoolGeometry.pool_bytes``, the cost model's ``kv_pool_bytes``) plus
    the sink."""
    return (geo.pool_bytes(cfg, n_layers, itemsize)
            + sink_bytes(cfg, n_layers, itemsize))
