"""Shared model layers: norms, RoPE, MLPs, embeddings (port of ``repro/models/layers.py``).

Conventions kept from the reference so the parity tests compare like with
like: weights are ``[in, out]`` and applied as ``x @ W``; norm math runs in
fp32 and returns the input dtype; matmul inputs and outputs stay in the
model dtype.  The port runs at sp = 1, so the reference's vocab-parallel
collectives reduce to the single-shard case.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def mlp(x, p, act: str):
    """Transformer MLP. Gated (swiglu/geglu) uses w1 (gate) + w3 (up)."""
    if act in ("swiglu", "geglu"):
        g = x @ p["w1"]
        u = x @ p["w3"]
        h = (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")) * u
    else:
        h = x @ p["w1"]
        if "b1" in p:
            h = h + p["b1"]
        h = _act(h, act)
    y = h @ p["w2"]
    if "b2" in p:
        y = y + p["b2"]
    return y


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


def pad_vocab(v: int, multiple: int = 128) -> int:
    return (v + multiple - 1) // multiple * multiple


def embed_tokens(ids, table, *, out_dtype=torch.bfloat16):
    """ids: [B, T] token ids; table: [Vp, d].  Returns [B, T, d]; ids outside
    the table give zero rows, as the reference's masked gather does."""
    vp = table.shape[0]
    idx = ids.clamp(0, vp - 1)
    hit = ((ids >= 0) & (ids < vp))[..., None]
    rows = table.index_select(0, idx.reshape(-1)).reshape(*ids.shape, -1)
    return torch.where(hit, rows, 0).to(out_dtype)
