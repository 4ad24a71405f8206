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

The optimizer moments in host memory (``optim/adamw.py``, DESIGN.md §11)
use the same primitives with their own streams and counters:

- ``host_zeros(specs, device)``: zeros born in host memory, one view each
  of a single buffer.  For a CUDA device the buffer is page-locked at its
  exact size with ``cudaHostRegister`` (PyTorch's caching host allocator
  rounds every block up to a power of two: 1.8x the bytes of qwen2-7b's
  fp32 moment leaves); a registration that fails raises;
- ``fetch(h, device)`` / ``store(t, h)``: one H2D of a host moment buffer
  on the moment H2D stream, one D2H back into it on the moment D2H stream,
  so neither direction queues behind the other (on the H100 machine the
  two directions share the link's rate: PERF.md §5).

The codec of the compressed host channels (DESIGN.md §14), torch ops
matching the reference's jnp ones bit for bit (``quantize``,
``dequantize``, ``codec_wire_dtype``, ``to_transport``, ``from_transport``):
one fp32 scale per row of the trailing axis (absmax / qmax), all-zero rows
as (zeros, 1.0) exactly, the input saturated to +-qmax before the cast to
the 1-byte wire dtype (``float8_e4m3fn`` has no inf), int8 rounded half to
even.  The one departure: a row whose scale is subnormal, which the
reference's XLA CPU backend flushes to zero (returning the row as zeros),
comes back within the codec's resolution here.

Counters of copies and bytes in each direction and an ordered log of
(what, chunk) entries are kept for the tests and chip_smoke.py, like the
kernels' launch counters: ``counts()``, ``log()``, ``reset_counts()``.
The activation rows' counters (``d2h``, ``h2d``, ...) and the moments'
(``moment_d2h``, ``moment_h2d``, ...) are kept apart.  The log also takes
the offload seam's ``note``s ("bwd" where a chunk's backward begins,
"replay" where it starts its replay).
"""
from __future__ import annotations

import math
from collections import deque
from typing import NamedTuple, Optional

import torch

LOG_LEN = 1 << 16  # the log keeps the newest entries only

d2h_copies = 0
d2h_bytes = 0
d2h_pinned = 0      # D2H copies whose host buffer was checked to be pinned
h2d_copies = 0
h2d_bytes = 0
_moments = {}       # the moment copies' counters (counts()'s "moment_*" keys)
_log: deque = deque(maxlen=LOG_LEN)
_streams = {}       # (device index, channel) -> its copy stream


class Staged(NamedTuple):
    """One copy: the tensor it wrote, the device the rows belong to, and the
    event that completes with the copy (None on the CPU)."""

    tensor: torch.Tensor
    device: torch.device
    event: Optional[torch.cuda.Event]


MOMENT_KEYS = ("moment_d2h", "moment_d2h_bytes", "moment_d2h_pinned",
               "moment_h2d", "moment_h2d_bytes")


def reset_counts():
    global d2h_copies, d2h_bytes, d2h_pinned, h2d_copies, h2d_bytes
    d2h_copies = d2h_bytes = d2h_pinned = h2d_copies = h2d_bytes = 0
    _moments.update(dict.fromkeys(MOMENT_KEYS, 0))
    _log.clear()


reset_counts()


def counts() -> dict:
    return {"d2h": d2h_copies, "d2h_bytes": d2h_bytes, "d2h_pinned": d2h_pinned,
            "h2d": h2d_copies, "h2d_bytes": h2d_bytes, **_moments}


def log() -> list:
    """The ordered (what, chunk) entries since the last ``reset_counts``:
    "d2h" and "h2d" for each copy, and the seam's notes."""
    return list(_log)


def note(what: str, chunk: int):
    _log.append((what, chunk))


def copy_stream(device, channel: str = "rows") -> torch.cuda.Stream:
    """A copy stream of a CUDA device, made at first use: "rows" carries
    the activation rows both ways, "moment_h2d" and "moment_d2h" the
    optimizer moments."""
    device = torch.device(device)
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if (idx, channel) not in _streams:
        _streams[idx, channel] = torch.cuda.Stream(device=idx)
    return _streams[idx, channel]


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


# ---------------------------------------------------------------------------
# Host buffers of the optimizer moments
# ---------------------------------------------------------------------------

ALIGN = 512  # byte alignment of each view in a host buffer


class HostBuffer:
    """One host allocation, page-locked for a CUDA device's copies, that
    ``host_zeros`` carves into views.  It stays registered while this
    object lives; when it goes, the device is synchronized and the buffer
    unregistered (views still alive then read pageable memory)."""

    def __init__(self, n_bytes: int, device: torch.device):
        # zeroed before it is registered: the zeroing touches every page on
        # all threads, and the registration then finds them resident
        self.tensor = torch.zeros(max(n_bytes, 1), dtype=torch.uint8)
        self.registered = False
        if device.type == "cuda":
            cudart = torch.cuda.cudart()
            err = cudart.cudaHostRegister(self.tensor.data_ptr(), self.tensor.numel(), 0)
            if err != cudart.cudaError.success:
                raise RuntimeError(f"page-locking {n_bytes} bytes of host memory failed: "
                                   f"{cudart.cudaGetErrorString(err)}")
            self.registered = True
            if not self.tensor.is_pinned():
                raise RuntimeError(f"a registered host buffer of {n_bytes} bytes reads "
                                   "as pageable")

    def __del__(self):
        if self.registered:
            torch.cuda.synchronize()
            torch.cuda.cudart().cudaHostUnregister(self.tensor.data_ptr())
            self.registered = False


def host_zeros(specs, device) -> tuple:
    """Zeros born in host memory for each (shape, dtype) of ``specs``
    (nothing is allocated on the device): returns (the ``HostBuffer``,
    the list of views).  The caller keeps the buffer as long as it uses
    the views as pinned memory.  ``device``: where the copies go; a CUDA
    device page-locks the buffer, the CPU (the tests) leaves it pageable."""
    sizes = [math.prod(shape) * dtype.itemsize for shape, dtype in specs]
    offsets, end = [], 0
    for n in sizes:
        offsets.append(end)
        end += -(-n // ALIGN) * ALIGN
    buf = HostBuffer(end, torch.device(device))
    return buf, [buf.tensor[off:off + n].view(dtype).view(shape)
                 for (shape, dtype), off, n in zip(specs, offsets, sizes)]


def fetch(h: torch.Tensor, device) -> Staged:
    """One H2D of a host moment buffer into a fresh device tensor, on the
    moment H2D stream after the work queued on the compute stream so far;
    the caller ``wait``s on the result before reading it.  On the CPU a
    clone."""
    device = torch.device(device)
    _moments["moment_h2d"] += 1
    _moments["moment_h2d_bytes"] += h.numel() * h.element_size()
    if device.type == "cpu":
        return Staged(h.clone(), device, None)
    out = torch.empty(h.shape, dtype=h.dtype, device=device)
    compute, side = torch.cuda.current_stream(device), copy_stream(device, "moment_h2d")
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        out.copy_(h, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    out.record_stream(side)
    return Staged(out, device, done)


def store(t: torch.Tensor, h: torch.Tensor) -> Optional[torch.cuda.Event]:
    """One D2H of the device moment ``t`` into its host buffer ``h`` (same
    shape and dtype), on the moment D2H stream after the work queued on the
    compute stream so far (``t``'s producer).  ``t`` is held by the copy
    stream until the copy has read it.  Returns the event that completes
    with the copy (None on the CPU, where it is a copy_)."""
    n = h.numel() * h.element_size()
    _moments["moment_d2h"] += 1
    _moments["moment_d2h_bytes"] += n
    if t.device.type == "cpu":
        h.copy_(t)
        return None
    if not h.is_pinned():
        raise RuntimeError(f"a host moment buffer of {n} bytes is pageable")
    _moments["moment_d2h_pinned"] += 1
    compute, side = torch.cuda.current_stream(t.device), copy_stream(t.device, "moment_d2h")
    side.wait_stream(compute)
    with torch.cuda.stream(side):
        h.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record(side)
    t.record_stream(side)
    return done


# ---------------------------------------------------------------------------
# The codec of the compressed host channels (DESIGN.md §14)
# ---------------------------------------------------------------------------

OFFLOAD_CODECS = ("none", "fp8", "int8")

# symmetric range per codec: float8_e4m3fn saturates at 448, int8 at 127
_CODEC_QMAX = {"fp8": 448.0, "int8": 127.0}


def codec_wire_dtype(codec: str):
    """The 1-byte wire dtype of a codec (None for the uncompressed channel)."""
    if codec in (None, "none"):
        return None
    if codec == "fp8":
        return torch.float8_e4m3fn
    if codec == "int8":
        return torch.int8
    raise ValueError(f"unknown offload codec {codec!r}; known: {OFFLOAD_CODECS}")


def quantize(t: torch.Tensor, codec: str):
    """Per-row symmetric quantization: (payload, scale), rows over the
    trailing axis (one fp32 scale per [..., 1] slice; a 0-d tensor has one
    0-d scale).  All-zero rows give (zeros, 1.0) exactly."""
    wire = codec_wire_dtype(codec)
    if wire is None:
        raise ValueError(f"quantize called with codec={codec!r}")
    qmax = _CODEC_QMAX[codec]
    t32 = t.float()
    amax = t32.abs().amax(dim=-1, keepdim=True) if t.dim() >= 1 else t32.abs()
    # a divisor tensor on t's device: CUDA divides by a Python scalar as a
    # product with its reciprocal, which rounds differently from the
    # reference's (and the CPU's) true division
    scale = torch.where(amax > 0.0, amax / amax.new_full((), qmax), 1.0)
    # saturate before the wire cast: float8_e4m3fn has no inf, and an
    # overflowing cast gives NaN
    q = torch.clamp(t32 / scale, -qmax, qmax)
    payload = torch.round(q).to(wire) if codec == "int8" else q.to(wire)
    return payload, scale


def dequantize(payload: torch.Tensor, scale: torch.Tensor, codec: str, dtype):
    """Inverse of ``quantize``: payload x scale in fp32, cast to ``dtype``."""
    return (payload.float() * scale).to(dtype)


def to_transport(payload: torch.Tensor, codec: str) -> torch.Tensor:
    """The reference's link view: an int8 payload crosses as the fp8 byte
    container (a bit-exact ``view``); fp8 passes through."""
    return payload.view(torch.float8_e4m3fn) if codec == "int8" else payload


def from_transport(payload: torch.Tensor, codec: str) -> torch.Tensor:
    """Inverse of ``to_transport``: the int8 payload's bytes back."""
    return payload.view(torch.int8) if codec == "int8" else payload
