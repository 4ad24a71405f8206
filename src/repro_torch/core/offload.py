"""SPPO adaptive offloading (port of ``repro/core/offload.py``; DESIGN.md §5,
§10 and §12).

1. **Sequence-aware offloading** (§5.2): the offload ratio α_i of each chunk
   is chosen so the D2H transfer of chunk i hides under the forward compute
   of chunk i+1, α_i·A_i = BW_D2H · T_{i+1}; the final chunk never offloads
   (its backward begins at once).  ``sequence_aware_alphas``,
   ``peak_memory``, ``split_rows`` and ``quantized_alpha`` are pure Python,
   copied from the reference and held against it by
   tests/test_torch_offload.py.

2. **Two-level activation management** (§5.1), executed (§10, §12): the KV
   cache (Type 0) stays on the device; each tagged Type-1 tensor (q, k, v
   after RoPE, the attention output, the MLP hidden) is split along its
   token axis at ``split_rows(rows, α)``: the first rows go to pinned host
   memory, the rest stay on the device.  The reference expresses this as
   named residuals of ``jax.checkpoint``; the port runs each chunk's layer
   stack once without a graph (``CaptureTag`` records the split of every
   tagged tensor), and replays it in the chunk's backward with the saved
   rows in place of the tagged tensors (``InjectTag``): q, k and v are not
   recomputed, the attention output and the MLP hidden are (their
   producers' backward needs the attention's and the MLP's intermediates,
   as under the reference's policy) and the saved rows take their place.
   ``Link`` carries one step's host rows from the forward to the backward
   and reloads each chunk's rows one chunk ahead ("ahead") or at the
   chunk's own backward ("sync"); at pp > 1 it is keyed by the rank's
   event, not the chunk (an MSP ramp runs a chunk twice).  The seam itself is
   ``models/transformer.py::stage_apply`` with remat "sppo" or "full".
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

from repro_torch.runtime import hostmem

# ---------------------------------------------------------------------------
# 1. Sequence-aware offload ratio solver (copied)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OffloadPlan:
    alphas: tuple               # per-chunk offload ratio in [0, 1]
    m_threshold: float          # bytes offloaded per chunk slot (paper's M_thr)
    peak_units: float           # peak device activation memory (chunk-activation units)


def sequence_aware_alphas(act_bytes: Sequence[float],
                          comp_times: Sequence[float],
                          bw_d2h: float,
                          *, reserve_last: bool = True,
                          bwd_over_fwd: float = 2.0) -> OffloadPlan:
    """act_bytes[i]: Type-1 activation volume of chunk i; comp_times[i]:
    *forward* compute time of chunk i; bw_d2h: host-link bytes/s.

    α_i = min(1, BW · T_{i+1} / A_i): offload exactly what hides under the
    next chunk's compute.  α of the final chunk is 0 (its backward starts
    immediately).  With ``reserve_last=False`` the final chunk offloads too,
    sized so each direction of its exposed round trip costs at most about
    one backward of it, ``comp_times[-1] * bwd_over_fwd``."""
    n = len(act_bytes)
    alphas = []
    for i in range(n):
        if i == n - 1 and reserve_last:
            alphas.append(0.0)
            continue
        window = (comp_times[i + 1] if i + 1 < n
                  else comp_times[i] * bwd_over_fwd)
        alphas.append(max(0.0, min(1.0, bw_d2h * window / max(act_bytes[i], 1e-9))))
    m_thr = max((a * b for a, b in zip(alphas, act_bytes)), default=0.0)
    peak = peak_memory(act_bytes, alphas)
    return OffloadPlan(tuple(alphas), m_thr, peak)


def peak_memory(act_bytes: Sequence[float], alphas: Sequence[float]) -> float:
    """Simulate M_i = M_{i-1} + A_i − α_{i-1}A_{i-1} (offload of chunk i-1
    completes during chunk i's compute); returns the forward-pass peak."""
    m = 0.0
    peak = 0.0
    prev_off = 0.0
    for a, al in zip(act_bytes, alphas):
        m += a              # chunk i activations materialize
        peak = max(peak, m)
        m -= prev_off       # previous chunk's offload drains
        prev_off = al * a
    # last chunk's offload (if any) drains after the loop
    peak = max(peak, m)
    return peak


def split_rows(rows: int, alpha: float) -> int:
    """Rows routed off-device for a fractional α (the tags' split point):
    nearest-row rounding, clipped to [0, rows]."""
    if alpha <= 0.0:
        return 0
    if alpha >= 1.0:
        return rows
    return max(0, min(rows, int(round(rows * alpha))))


def quantized_alpha(rows: int, alpha: float) -> float:
    """The offload ratio the row split actually deploys for a tensor with
    ``rows`` rows: ``split_rows(rows, α) / rows``."""
    if rows <= 0:
        return 0.0
    return split_rows(rows, float(alpha)) / rows


# ---------------------------------------------------------------------------
# 2. Executed offload: capture, reload, inject
# ---------------------------------------------------------------------------


class residual_substitute(torch.autograd.Function):
    """Identity-by-value swap: the forward returns ``staged`` (a saved copy
    of ``computed``, bitwise equal to it), the backward routes the whole
    gradient to ``computed``'s producers and none to ``staged``.  The
    replay's consumers thus read (and save) the staged rows while the
    gradient reaches the true producers."""

    @staticmethod
    def forward(ctx, computed, staged):
        return staged.view_as(staged)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def compact(t):
    """``t`` itself where it owns its storage, else a copy of just its
    elements (a row slice or a head slice must not keep its base alive)."""
    if t.untyped_storage().nbytes() == t.numel() * t.element_size():
        return t
    return t.clone(memory_format=torch.contiguous_format)


class CaptureTag:
    """Forward tag: an identity that appends the row split of each tagged
    tensor to ``collector`` in traversal order, ("off", the first
    ``split_rows(rows, α)`` rows) for the host and ("keep", the rest) for
    the device.  Entries are views of the tensor; the seam copies them."""

    replay = False

    def __init__(self, alpha: float, collector: list, *, axis: int = 1):
        self.alpha, self.collector, self.axis = float(alpha), collector, axis

    def __call__(self, t):
        rows = t.shape[self.axis]
        k = split_rows(rows, self.alpha)
        if k <= 0:
            self.collector.append(("keep", t))
        elif k >= rows:
            self.collector.append(("off", t))
        else:
            self.collector.append(("off", t.narrow(self.axis, 0, k)))
            self.collector.append(("keep", t.narrow(self.axis, k, rows - k)))
        return t


class InjectTag:
    """Replay tag: walks the same tag sites as ``CaptureTag`` (same α, same
    shapes, so the same splits in the same order) and hands out the staged
    rows, the reloaded ``off_acts`` and the device-resident ``keep_acts``
    (iterables consumed in traversal order).

    A site whose producer's backward needs only the producer's inputs takes
    its staged tensors with ``take`` and skips the producer (q, k and v:
    ``models/attention.py::_SavedQKV``).  A site whose producer's backward
    needs intermediates the replay computes anyway (the attention output:
    the attention's (o, l); the MLP hidden: its gate and up projections)
    calls the tag on the recomputed tensor, which puts the staged rows in
    its place through ``residual_substitute``."""

    replay = True

    def __init__(self, alpha: float, off_acts, keep_acts, *, axis: int = 1):
        self.alpha, self.axis = float(alpha), axis
        self.off, self.keep = iter(off_acts), iter(keep_acts)

    def take(self, shape, dtype):
        """The next site's staged tensor, checked against its ``shape`` and
        ``dtype``."""
        rows = shape[self.axis]
        k = split_rows(rows, self.alpha)
        if k <= 0:
            staged = next(self.keep)
        elif k >= rows:
            staged = next(self.off)
        else:
            staged = torch.cat([next(self.off), next(self.keep)], dim=self.axis)
        if staged.shape != tuple(shape) or staged.dtype != dtype:
            raise ValueError(f"staged rows {tuple(staged.shape)} {staged.dtype} do not "
                             f"match the tag site's {tuple(shape)} {dtype}")
        return staged

    def __call__(self, t):
        return residual_substitute.apply(t, self.take(t.shape, t.dtype))


@dataclass
class ChunkOffload:
    """What a chunk's seam does with its tagged rows: split them at ``alpha``
    and send the off rows to host through ``link``.  Without a link (remat
    "sppo" with offload off) ``alpha`` must deploy no row: every row stays
    on the device.

    With a ``codec`` ("fp8" / "int8", DESIGN.md §14) the off rows cross
    compressed: ``send`` quantizes each one and sends only its 1-byte
    payload (int8 in the reference's transport view), keeping its per-row
    fp32 scales here, on the device, with the chunk that owns them; in the
    chunk's backward ``restore`` dequantizes each reloaded payload at its
    tag site."""

    chunk: int
    alpha: float
    link: Optional["Link"] = None
    codec: str = "none"
    scales: list = field(default_factory=list)   # (scale, dtype) per sent row set
    # the seam's event on its rank at pp > 1 (None at pp = 1): two MSP
    # sub-events share a chunk, and the seam before a rank's event e is
    # its event e - 1, so the link is keyed by event there (``key``)
    event: Optional[int] = None

    @property
    def key(self) -> int:
        """The link's key: the event at pp > 1, else the chunk (the
        reference's tags ``@t{t}`` / ``@c{c}``)."""
        return self.chunk if self.event is None else self.event

    def send(self, t) -> None:
        if self.codec == "none":
            self.link.send(self.key, t)
            return
        payload, scale = hostmem.quantize(t, self.codec)
        self.scales.append((scale, t.dtype))
        self.link.send(self.key, hostmem.to_transport(payload, self.codec))

    def restore(self, staged: list):
        """The off rows from this chunk's reloaded ``staged`` tensors, in
        capture order: as they are, or dequantized one by one as the
        replay's tag sites consume them."""
        if self.codec == "none":
            return staged
        scales, self.scales = self.scales, []
        if len(scales) != len(staged):
            raise RuntimeError(f"seam {self.key}: {len(staged)} payloads reloaded for "
                               f"{len(scales)} scales")
        return (hostmem.dequantize(hostmem.from_transport(p, self.codec), sc, self.codec, dt)
                for p, (sc, dt) in zip(staged, scales))


class Link:
    """One step's host rows, seam by seam, from the forward to the backward
    (the reference's ``link`` threaded through its prefetch seams, DESIGN.md
    §12).  A seam's key is its chunk at pp = 1 and its event on the rank at
    pp > 1 (``ChunkOffload.key``); either way the seams of a rank run in
    key order, so the seam before key k is k - 1.

    ``send`` copies a seam's off rows to host as its forward captures them.
    In the backward, each seam calls ``begin``, then (under "ahead")
    ``prefetch`` of the seam before it, whose H2D has no data dependency on
    this seam's work and so overlaps it, then ``take``s its own rows:
    reloaded one seam ahead under "ahead" (the last seam's by
    ``runner.link_drain``), or now under "sync".  At most one seam's rows
    are staged ahead at any time."""

    def __init__(self, ahead: bool):
        self.ahead = ahead
        self.host = {}      # key -> [Staged] host copies, in capture order
        self.staged = {}    # key -> [Staged] device copies, reloaded
        self.current = None  # the seam whose backward runs

    def send(self, key: int, t) -> None:
        self.host.setdefault(key, []).append(hostmem.to_host(t, key))

    def prefetch(self, key: int) -> None:
        """Issue the H2D of seam ``key``'s host rows (none: nothing to do)."""
        rows = self.host.pop(key, [])
        if rows:
            ahead = set(self.staged) - {self.current}
            if ahead:
                raise RuntimeError(f"seam {key}'s rows reloaded while seam(s) "
                                   f"{sorted(ahead)} are already staged ahead")
            self.staged[key] = [hostmem.to_device(h, key) for h in rows]

    def begin(self, key: int) -> None:
        """Seam ``key``'s backward begins: its staged rows are no longer
        ahead of it."""
        self.current = key
        hostmem.note("bwd", key)

    def take(self, key: int) -> list:
        """Seam ``key``'s reloaded off rows on the device, in capture order,
        the compute stream told to wait for their copies."""
        if key in self.host:
            if self.ahead:
                raise RuntimeError(f"seam {key}'s rows were not reloaded ahead "
                                   "of its backward")
            self.prefetch(key)
        hostmem.note("replay", key)
        return [hostmem.wait(s) for s in self.staged.pop(key, [])]
