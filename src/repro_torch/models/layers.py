"""Shared model layers: norms, RoPE, MLPs, embeddings (port of ``repro/models/layers.py``).

Conventions kept from the reference so the parity tests compare like with
like: weights are ``[in, out]`` and applied as ``x @ W``; norm math runs in
fp32 and returns the input dtype; matmul inputs and outputs stay in the
model dtype.  The embedding and the loss are the reference's vocab-parallel
ones over the model axis of a ``parallel/ctx.py::Ctx`` (its collectives are
the identity at sp = 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.parallel.ctx import SINGLE

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm with a zero-initialized scale applied as ``(1 + scale)``."""
    d = x.shape[-1]
    return F.rms_norm(x.float(), (d,), 1.0 + scale.float(), eps).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    d = x.shape[-1]
    return F.layer_norm(x.float(), (d,), scale.float(), bias.float(), eps).to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


# ---------------------------------------------------------------------------
# RoPE (positions given explicitly — chunked execution needs global offsets)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None):
    rot = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def rope_tables(positions, head_dim: int, theta: float, fraction: float = 1.0):
    """(cos, sin, rot) of the angles pos x inv_freq in fp32, cos and sin
    [B or 1, T, 1, rot/2]: computed once per chunk and shared by q, k and
    every layer."""
    inv, rot = rope_freqs(head_dim, theta, fraction, device=positions.device)
    pos = positions.float()
    if pos.dim() == 1:
        pos = pos[None, :]
    ang = pos[..., None] * inv                          # [B, T, rot/2]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :], rot


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: [B, T, H, hd]; positions: [B, T] or [T] int global positions."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta, fraction))


def rotate(x, cos, sin, rot: int):
    """RoPE from ``rope_tables``.  Rotates *interleaved* pairs
    (x[..., 0::2], x[..., 1::2]), as the reference does — not the
    half-split ``rotate_half`` layout."""
    hd = x.shape[-1]
    if rot == 0:
        return x
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.stack([r1, r2], dim=-1).reshape(*x.shape[:-1], rot)
    if rot < hd:
        out = torch.cat([out, x[..., rot:].float()], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations / MLP
# ---------------------------------------------------------------------------


def _act(h, kind: str):
    if kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(h, approximate="tanh")
    if kind == "relu2":
        return F.relu(h).square()
    raise ValueError(kind)


def mlp(x, p, act: str, *, name_tag=None):
    """Transformer MLP. Gated (swiglu/geglu) uses w1 (gate) + w3 (up).

    name_tag: optional fn applied to the big [.., d_ff] intermediate, the
    MLP's tag site of SPPO's offload (core/offload.py)."""
    if act in ("swiglu", "geglu"):
        g = x @ p["w1"]
        u = x @ p["w3"]
        h = (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")) * u
    else:
        h = x @ p["w1"]
        if "b1" in p:
            h = h + p["b1"]
        h = _act(h, act)
    if name_tag is not None:
        h = name_tag(h)
    y = h @ p["w2"]
    if "b2" in p:
        y = y + p["b2"]
    return y


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def pad_vocab(v: int, multiple: int = 128) -> int:
    return (v + multiple - 1) // multiple * multiple


def embed_tokens(ids, table, ctx=SINGLE, *, out_dtype=torch.bfloat16):
    """ids: [B, T] the chunk's token ids; table: [Vp / sp, d] this model
    rank's rows of the vocab.  Returns this rank's sequence shard [B, T /
    sp, d]: a masked local gather (ids outside the rank's rows give zero
    rows and no gradient), then one reduce-scatter over the sequence (half
    the bytes of a psum; reference ``layers.py:127-140``).

    The gather is ``F.embedding``: its CUDA backward reduces each id's rows
    in a fixed order, so the table's gradient is bitwise the same from run
    to run (``index_select``'s backward adds repeated ids' rows with
    atomics, in an order that varies)."""
    vloc = table.shape[0]
    lo = ctx.model_index() * vloc
    idx = (ids - lo).clamp(0, vloc - 1)
    hit = ((ids >= lo) & (ids < lo + vloc))[..., None]
    out = torch.where(hit, F.embedding(idx, table), 0).to(out_dtype)
    return ctx.reduce_scatter_model(out, axis=1)


# ---------------------------------------------------------------------------
# LM head + cross entropy
# ---------------------------------------------------------------------------


def vocab_parallel_xent(x, head, labels, mask, ctx=SINGLE, *, real_vocab: int):
    """The reference's vocab-parallel cross entropy (``layers.py:148-176``).

    x: [B, T / sp, d] this model rank's sequence shard; head: [d, Vp / sp]
    its vocab columns; labels, mask: [B, T], the chunk's.  x is all-gathered
    over the sequence, the local logits are fp32 with the padded vocab
    columns masked to -1e30, and the row max (gradient-frozen: it cancels
    in the softmax ratio), the softmax sum and the picked logit are reduced
    over the model axis, so no rank holds the full-vocab logits.  Returns
    (sum of (log l + m - logit[label]) * mask, sum of mask), the same on
    every model rank; a label outside the table contributes no logit, as in
    the reference's masked pick."""
    x = ctx.all_gather_model(x, axis=1)                          # [B, T, d]
    logits = (x @ head).float()                                  # [B, T, Vp / sp]
    vloc = logits.shape[-1]
    lo = ctx.model_index() * vloc
    col = lo + torch.arange(vloc, device=logits.device)
    logits = torch.where(col < real_vocab, logits, -1e30)
    m = ctx.pmax_model(logits.detach().amax(dim=-1))
    l = ctx.psum_model(torch.exp(logits - m[..., None]).sum(dim=-1))   # [B, T]
    idx = (labels - lo).clamp(0, vloc - 1).long()
    picked = logits.gather(-1, idx[..., None])[..., 0]
    hit = ctx.psum_model(torch.where((labels >= lo) & (labels < lo + vloc), picked, 0.0))
    tok_loss = (torch.log(l) + m - hit) * mask
    return tok_loss.sum(), mask.sum()
