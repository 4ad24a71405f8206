"""AdamW with global-norm clipping and a cosine schedule (port of
``repro/optim/adamw.py``), its moments on the device or in pinned host
memory (DESIGN.md §11), raw or compressed (DESIGN.md §14).

The update is the reference's, written out by hand: gradients clipped by
their global norm, bias-corrected moments, ``eps`` outside the square root,
decoupled weight decay on matrices only (``ndim >= 2``).
``torch.optim.AdamW`` puts ``eps`` and the decay elsewhere and computes a
different update.  The arithmetic is fp32 whatever the parameter dtype; the
moments are kept in ``opt_dtype``: fp32, or bf16 (deepseek's, as the
reference's ``init_state(opt_dtype=jnp.bfloat16)``: each moment is read as
fp32, updated, and rounded back to bf16 to nearest even, as JAX's
``astype`` rounds).  Parameters and moments are updated in place (the
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

ZeRO-1 over the pod axis (``PodSlices``, ``parallel/specs.py``): a rank
keeps only its pod's slice of some leaves' moments, on the device or in
host memory alike, updates that slice of the parameter (the global norm is
the full gradients', taken before), and hands the updated slices to a
``gather`` that fills in the other pods' (``Ctx.all_gather_pod``).  The
update is elementwise, so the parameters come out the same bits as
without the slicing.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import tree
from repro_torch.runtime import hostmem


class PodSlices(NamedTuple):
    """ZeRO-1 over ``n`` pods: ``dims[i]`` is the dim along which this
    rank's moments of parameter leaf i cover slice ``index`` of ``n`` equal
    parts, and its update writes only that slice; None: the whole leaf."""

    dims: tuple
    n: int
    index: int

    def of(self, i: int, t):
        """Leaf i's slice of ``t`` (a view), or ``t``."""
        d = self.dims[i]
        if d is None:
            return t
        k = t.shape[d] // self.n
        return t.narrow(d, self.index * k, k)


def _slices(pod_slices, flat):
    """Each leaf of ``flat`` as the update sees it (its pod slice)."""
    return flat if pod_slices is None else [pod_slices.of(i, t) for i, t in enumerate(flat)]


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32 [] on the parameters' device
    m: object            # tree like params: opt_dtype tensors, or (payload, scale) pairs
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


OPT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _opt_dtype(opt_dtype):
    """The moments' torch dtype from its name (the plan's ``opt_dtype``)."""
    if opt_dtype not in OPT_DTYPES:
        raise ValueError(f"opt_dtype {opt_dtype!r}: the moments are one of {sorted(OPT_DTYPES)}")
    return OPT_DTYPES[opt_dtype]


def init_state(params, *, opt_dtype="float32", offload_moments=False, moments_dtype="none",
               moments_mode="explicit", pod_slices: PodSlices = None) -> AdamWState:
    """Zero moments of ``opt_dtype`` ("float32" or "bfloat16") beside each
    parameter, or, with ``offload_moments``, born in host memory (pinned
    where the parameters are on a CUDA device): ``opt_dtype``, or under
    ``moments_dtype`` a (payload, scale) pair per leaf, zeros (a zero
    payload dequantizes to zero).  Under ZeRO-1 (``pod_slices``) each leaf's
    moments have its pod slice's shape."""
    _check_moments(offload_moments, moments_mode, moments_dtype)
    dtype = _opt_dtype(opt_dtype)
    flat = _slices(pod_slices, tree.leaves(params))
    dev = flat[0].device
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if not offload_moments:
        def zeros():
            it = iter(flat)
            return tree.map_(lambda _: torch.zeros(next(it).shape, dtype=dtype, device=dev),
                             params)

        return AdamWState(step=step, m=zeros(), v=zeros())
    wire = hostmem.codec_wire_dtype(moments_dtype)
    if wire is None:
        specs = [(tuple(p.shape), dtype) for p in flat] * 2
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
            # raw: rounded to the host buffer's dtype (bf16 moments) on the device
            parts = ((new.to(pair[0].dtype),) if self.codec is None
                     else hostmem.quantize(new, self.codec))
            events += [hostmem.store(t, h) for t, h in zip(parts, pair)]
        self.stored[i] = [e for e in events if e is not None]

    def finish(self):
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).wait_stream(
                hostmem.copy_stream(self.device, "moment_d2h"))


@torch.no_grad()
def apply_update(params, grads, state: AdamWState, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0,
                 offload_moments=False, moments_mode="explicit", moments_dtype="none",
                 grad_norm=None, pod_slices: PodSlices = None, gather=None):
    """One AdamW step, in place.  Returns (params, state, metrics) with
    metrics ``grad_norm`` (before clipping) and ``lr``.  ``grad_norm``, where
    given, is the global norm the clip uses in place of ``global_norm(grads)``
    (a pipeline rank holds one stage's gradients: ``runner.global_grad_norm``
    sums the model's).  With
    ``offload_moments`` the moments in ``state`` are host buffers
    (``init_state(offload_moments=True, moments_dtype=...)``): each leaf's
    pass through the device is described in the module docstring.  Under
    ZeRO-1 (``pod_slices``, with ``state`` from ``init_state(pod_slices=)``)
    each leaf's update covers its pod slice, and ``gather(params, dims)``
    then fills in the other pods' slices of the sliced leaves."""
    _check_moments(offload_moments, moments_mode, moments_dtype)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    flat_p = _slices(pod_slices, tree.leaves(params))
    flat_g = _slices(pod_slices, tree.leaves(grads))
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
        # (bf16 moments are read as fp32 first)
        m32 = b1 * m.float()
        m32.add_((1 - b1) * g32)
        v32 = b2 * v.float()
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
    if pod_slices is not None:
        sliced = [(p, d) for p, d in zip(tree.leaves(params), pod_slices.dims) if d is not None]
        gather([p for p, _ in sliced], [d for _, d in sliced])
    return params, state._replace(step=step), {"grad_norm": gnorm, "lr": lr}
