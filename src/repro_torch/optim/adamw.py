"""AdamW with global-norm clipping and a cosine schedule (port of
``repro/optim/adamw.py``), its moments on the device or in pinned host
memory (DESIGN.md §11), raw or compressed (DESIGN.md §14).

The update is the reference's, written out by hand: gradients clipped by
their global norm, bias-corrected moments, ``eps`` outside the square root,
decoupled weight decay on matrices only (``ndim >= 2``).
``torch.optim.AdamW`` puts ``eps`` and the decay elsewhere and computes a
different update.  The moments and the arithmetic are fp32 whatever the
parameter dtype (the reference's bf16 moments are deepseek's, not yet a
model of the port).  Parameters and moments are updated in place (the
reference returns new arrays): the moments are the largest state of
training, and no second copy of them is made.

Moment offload (``offload_moments``, the reference's
``moments_mode="explicit"``): ``init_state`` gives birth to the moments in
host memory (``runtime/hostmem.py::host_zeros``: one buffer page-locked for
the device's copies, nothing allocated on the device), and ``apply_update``
moves each moment leaf through the device: one H2D, the same fp32 update
as with the moments on the device, one D2H back into its host buffer.  The
round trip is an identity, so the parameters and moments are bitwise those
of the on-device update.  With a codec (``moments_dtype`` "fp8" / "int8")
each host moment leaf is the pair (1-byte payload, fp32 per-row scales):
both cross, the H2D side dequantizes to fp32 on the device and the D2H side
quantizes the new moment (lossy by design; drift bounds in
tests/test_torch_optstate.py).

Overlap and the device's bound: the H2D copies run on one copy stream and
the D2H copies on another, so neither queues behind the other, and leaf
i + 1's H2D is issued before leaf i's update, so it runs under it.  Before
issuing it, the host waits for leaf i - 1's D2H, so the device holds the
moments of at most two leaves at once (leaf i's, staged and then updated
until its D2H has read them, and leaf i + 1's staged copy) beside leaf i's
update temporaries: with qwen2-7b's fp32 moments, twice the 4.4 GB of the
embedding table's m and v, not the 61 GB of all of them (chip_smoke.py
checks the bound on the card).  The reference's ``moments_mode="xla"``
(placement left to XLA through shardings) has no counterpart here and is
refused.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import tree
from repro_torch.runtime import hostmem


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 [] on the parameters' device
    m: object            # tree like params: fp32 tensors, or (payload, scale) pairs
    v: object            # tree like params
    host: object = None  # the hostmem.HostBuffer the offloaded moments are views of


def _check_moments(offload_moments, moments_mode, moments_dtype):
    if moments_mode != "explicit":
        raise ValueError(f"moments_mode={moments_mode!r}: the port places the moments "
                         "itself ('explicit', one H2D and one D2H a leaf); 'xla' is the "
                         "reference's placement through XLA shardings")
    if moments_dtype not in (None, "none"):
        hostmem.codec_wire_dtype(moments_dtype)
        if not offload_moments:
            raise ValueError(f"moments_dtype={moments_dtype!r} requires offload_moments: "
                             "the codec compresses the host channel, and moments on the "
                             "device have none")


def _scale_shape(shape):
    return tuple(shape[:-1]) + (1,) if len(shape) >= 1 else ()


def init_state(params, *, offload_moments=False, moments_dtype="none",
               moments_mode="explicit") -> AdamWState:
    """Zero fp32 moments beside each parameter, or, with
    ``offload_moments``, born in host memory (pinned where the parameters
    are on a CUDA device): fp32, or under ``moments_dtype`` a (payload,
    scale) pair per leaf, zeros (a zero payload dequantizes to zero)."""
    _check_moments(offload_moments, moments_mode, moments_dtype)
    flat = tree.leaves(params)
    dev = flat[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if not offload_moments:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return AdamWState(step=step, m=tree.map_(zeros, params), v=tree.map_(zeros, params))
    wire = hostmem.codec_wire_dtype(moments_dtype)
    if wire is None:
        specs = [(tuple(p.shape), torch.float32) for p in flat] * 2
    else:
        specs = [spec for p in flat for spec in ((tuple(p.shape), wire),
                                                 (_scale_shape(p.shape), torch.float32))] * 2
    buf, views = hostmem.host_zeros(specs, dev)
    if wire is not None:
        # (payload, scale) pairs; a zero scale would be as good, 1.0 is what
        # quantize gives an all-zero row
        for scale in views[1::2]:
            scale.fill_(1.0)
        views = list(zip(views[0::2], views[1::2]))
    half = len(views) // 2
    m_it, v_it = iter(views[:half]), iter(views[half:])
    return AdamWState(step=step, m=tree.map_(lambda _: next(m_it), params),
                      v=tree.map_(lambda _: next(v_it), params), host=buf)


def cosine_lr(step, *, peak=3e-4, warmup=100, total=10000, floor=0.1):
    """Linear warmup to ``peak``, then cosine decay to ``floor * peak`` at
    ``total``: an fp32 tensor, computed as the reference computes it."""
    step = torch.as_tensor(step)
    warm = peak * (step + 1) / warmup
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos).to(torch.float32)


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in tree.leaves(grads)))


def _moment_entries(params, moments) -> list:
    """The moment tree's entry for each parameter leaf, in leaf order (a
    tensor, or a (payload, scale) pair)."""
    out = []
    tree.map_(lambda _, m: out.append(m), params, moments)
    return out


class _MomentStream:
    """The copies of an offloaded update, leaf by leaf: ``stage(i)`` issues
    leaf i's H2D (waiting first, on the host, for the D2H of the leaf two
    before it), ``take(i)`` returns its fp32 moments on the device (the
    compute stream told to wait, a codec's pair dequantized), ``put(i, m,
    v)`` issues the D2H of the new moments into the host buffers
    (quantized under a codec), ``finish()`` makes the compute stream wait
    for the last D2H."""

    def __init__(self, host_m, host_v, device, codec):
        self.host = list(zip(host_m, host_v))
        self.device, self.codec = device, codec
        self.staged, self.stored = {}, {}

    def _pairs(self, i):
        return [h if isinstance(h, tuple) else (h,) for h in self.host[i]]

    def stage(self, i):
        done = self.stored.pop(i - 2, None)
        for event in done or ():
            event.synchronize()
        self.staged[i] = [tuple(hostmem.fetch(h, self.device) for h in pair)
                          for pair in self._pairs(i)]

    def take(self, i):
        out = []
        for pair in self.staged.pop(i):
            tensors = [hostmem.wait(s) for s in pair]
            out.append(tensors[0] if self.codec is None else
                       hostmem.dequantize(*tensors, self.codec, torch.float32))
        return out

    def put(self, i, m32, v32):
        events = []
        for new, pair in zip((m32, v32), self._pairs(i)):
            parts = (new,) if self.codec is None else hostmem.quantize(new, self.codec)
            events += [hostmem.store(t, h) for t, h in zip(parts, pair)]
        self.stored[i] = [e for e in events if e is not None]

    def finish(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_stream(
                hostmem.copy_stream(self.device, "moment_d2h"))


@torch.no_grad()
def apply_update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0,
                 offload_moments=False, moments_mode="explicit", moments_dtype="none"):
    """One AdamW step, in place.  Returns (params, state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``.  With
    ``offload_moments`` the moments in ``state`` are host buffers
    (``init_state(offload_moments=True, moments_dtype=...)``): each leaf's
    pass through the device is described in the module docstring."""
    _check_moments(offload_moments, moments_mode, moments_dtype)
    gnorm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    flat_p, flat_g = tree.leaves(params), tree.leaves(grads)
    ms, vs = _moment_entries(params, state.m), _moment_entries(params, state.v)
    moving = None
    if offload_moments:
        codec = None if moments_dtype in (None, "none") else moments_dtype
        moving = _MomentStream(ms, vs, gnorm.device, codec)
        if flat_p:
            moving.stage(0)
    for i, (p, g) in enumerate(zip(flat_p, flat_g)):
        if moving is None:
            m, v = ms[i], vs[i]
        else:
            if i + 1 < len(flat_p):
                moving.stage(i + 1)
            m, v = moving.take(i)
        g32 = g.float() * scale
        # m32 = b1 m + (1 - b1) g32, v32 = b2 v + (1 - b2) g32 g32 and
        # u = (m32 / bc1) / (sqrt(v32 / bc2) + eps), with each op that the
        # out-of-place form gives a temporary done in place (it rounds the
        # same): at most four fp32 copies of a leaf live at once, not five
        m32 = b1 * m
        m32.add_((1 - b1) * g32)
        v32 = b2 * v
        v32.add_(((1 - b2) * g32).mul_(g32))
        del g32
        u = m32 / bc1
        u.div_((v32 / bc2).sqrt_().add_(eps))
        if moving is None:
            m.copy_(m32)
            v.copy_(v32)
        else:
            del m, v
            moving.put(i, m32, v32)
        del m32, v32
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            u = u + weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    if moving is not None:
        moving.finish()
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
