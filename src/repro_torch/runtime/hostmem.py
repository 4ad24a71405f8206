"""Host memory for the executed activation offload (port of
``repro/runtime/hostmem.py``, DESIGN.md §10 and §12).

The reference places a tensor in a host memory kind with ``device_put`` and
leaves the copy's timing to XLA.  Here each copy is explicit:

- ``to_host(t, chunk)``: one D2H of ``t`` into a pinned host buffer, on a
  copy stream of its own.  The copy stream first waits for the work queued
  on the compute stream so far (the producer of ``t``), so the copy overlaps
  whatever the compute stream is given next.  ``t`` is marked as in use by
  the copy stream (``record_stream``): the caching allocator does not hand
  its memory out again before the copy has read it.
- ``to_device(h, chunk)``: one H2D of a host copy into a fresh device
  tensor, on the same copy stream, after the work queued on the compute
  stream so far.  The caller makes the compute stream wait on the returned
  event (``wait``) before it reads the tensor.

Pinned buffers come from PyTorch's caching host allocator, so the same
sizes are reused step after step.  A pinned allocation that fails raises;
nothing falls back to pageable memory.  On the CPU, where the tests run,
the "host" copy is a separate CPU buffer (a clone, never an alias) and there
are no streams or events.

Counters of copies and bytes in each direction and an ordered log of
(what, chunk) entries are kept for the tests and chip_smoke.py, like the
kernels' launch counters: ``counts()``, ``log()``, ``reset_counts()``.
The log also takes the offload seam's ``note``s ("bwd" where a chunk's
backward begins, "replay" where it starts its replay).
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple, Optional

import torch

LOG_LEN = 1 << 16  # the log keeps the newest entries only

d2h_copies = 0
d2h_bytes = 0
d2h_pinned = 0      # D2H copies whose host buffer was checked to be pinned
h2d_copies = 0
h2d_bytes = 0
_log: deque = deque(maxlen=LOG_LEN)
_streams = {}       # device index -> its copy stream


class Staged(NamedTuple):
    """One copy: the tensor it wrote, the device the rows belong to, and the
    event that completes with the copy (None on the CPU)."""

    tensor: torch.Tensor
    device: torch.device
    event: Optional[torch.cuda.Event]


def reset_counts():
    global d2h_copies, d2h_bytes, d2h_pinned, h2d_copies, h2d_bytes
    d2h_copies = d2h_bytes = d2h_pinned = h2d_copies = h2d_bytes = 0
    _log.clear()


def counts() -> dict:
    return {"d2h": d2h_copies, "d2h_bytes": d2h_bytes, "d2h_pinned": d2h_pinned,
            "h2d": h2d_copies, "h2d_bytes": h2d_bytes}


def log() -> list:
    """The ordered (what, chunk) entries since the last ``reset_counts``:
    "d2h" and "h2d" for each copy, and the seam's notes."""
    return list(_log)


def note(what: str, chunk: int):
    _log.append((what, chunk))


def copy_stream(device) -> torch.cuda.Stream:
    """The copy stream of a CUDA device, made at first use."""
    device = torch.device(device)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _streams:
        _streams[idx] = torch.cuda.Stream(device=idx)
    return _streams[idx]


def to_host(t: torch.Tensor, chunk: int) -> Staged:
    """One D2H of ``t`` (the off rows of a tag site) into pinned host
    memory, on the copy stream."""
    global d2h_copies, d2h_bytes, d2h_pinned
    n = t.numel() * t.element_size()
    d2h_copies += 1
    d2h_bytes += n
    _log.append(("d2h", chunk))
    if t.device.type == "cpu":
        return Staged(t.clone(), t.device, None)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    if not host.is_pinned():
        raise RuntimeError(f"a pinned host buffer of {n} bytes came back pageable")
    d2h_pinned += 1
    compute, side = torch.cuda.current_stream(t.device), copy_stream(t.device)
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    t.record_stream(side)
    return Staged(host, t.device, done)


def to_device(h: Staged, chunk: int) -> Staged:
    """One H2D of a host copy back to its device, on the copy stream; the
    caller ``wait``s on the result before reading it."""
    global h2d_copies, h2d_bytes
    t = h.tensor
    h2d_copies += 1
    h2d_bytes += t.numel() * t.element_size()
    _log.append(("h2d", chunk))
    if h.device.type == "cpu":
        return Staged(t.clone(), h.device, None)
    out = torch.empty(t.shape, dtype=t.dtype, device=h.device)
    compute, side = torch.cuda.current_stream(h.device), copy_stream(h.device)
    # the fresh block may have been used by work still queued on the compute
    # stream: the copy waits for it
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        out.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    out.record_stream(side)
    return Staged(out, h.device, done)


def wait(s: Staged) -> torch.Tensor:
    """The copied tensor, once the compute stream has been told to wait for
    its copy."""
    if s.event is not None:
        torch.cuda.current_stream(s.device).wait_event(s.event)
    return s.tensor
