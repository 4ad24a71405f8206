"""SSM mixers: Mamba2 (SSD, chunked) and RWKV6 (Finch, data-dependent
decay) (port of ``repro/models/ssm.py``).

Both carry an fp32 recurrent state across chunks and decode steps, and
both run a sub-chunk scan inside a chunk: the quadratic dual form within
each sub-chunk of P tokens (P <= 128 for Mamba2, <= 32 for RWKV6), the
state carried from one sub-chunk to the next.  The reference scans the
sub-chunks one at a time (``jax.lax.scan``); here the terms that do not
depend on the carried state (each sub-chunk's own outputs, its decay
totals and its contribution to the state) are computed for every
sub-chunk at once, and only the carry runs as a loop: a chunk of T tokens
is T / P small steps, not T / P passes of the whole dual form.  One token
(a decode step) runs the recurrence itself, which is the dual form at P =
1 with its zero terms left out.

Numbers follow the reference: the recurrence math is fp32, the
projections run in the model dtype, and where JAX promotes a model-dtype
operand against an fp32 leaf (RWKV's LoRA and decay leaves are fp32 in a
bf16 model) the cast is written out, since ``torch.matmul`` refuses mixed
dtypes.  The decay matrices mask *inside* the exp (``_segsum_decay``, the
RWKV ``dec_ts``), so the masked entries, whose raw differences are large
and positive, neither overflow nor poison a gradient with inf x 0.  The
RWKV group norm uses the population variance (``jnp.var``'s ddof 0).

The model axis (the reference's head-parallel Mamba2 and sequence-sharded
RWKV6, stitched by ``_shard_token_shift`` and ``_compose_states``) runs at
sp = 1 only here: more raises NotImplementedError naming ROADMAP Queue 1
item 7.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.parallel.ctx import SINGLE


def _single_device(ctx, what: str) -> None:
    if ctx is not None and ctx.sp > 1:
        raise NotImplementedError(
            f"{what} at sp = {ctx.sp}: the port runs the SSM mixers at sp = 1; their "
            "model-axis form comes with a later slice (ROADMAP Queue 1, item 7)")


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------


class MambaState(NamedTuple):
    ssm: torch.Tensor    # [B, H, hd, ds] fp32
    conv: torch.Tensor   # [B, W - 1, d_in + 2 ds] fp32, the carried conv tail


def mamba2_dims(cfg, sp: int = 1):
    """(d_inner, heads, heads per model rank)."""
    d_in = cfg.ssm.expand * cfg.d_model
    H = d_in // cfg.ssm.head_dim
    if H % sp:
        raise ValueError(f"mamba heads {H} must divide the model axis {sp}")
    return d_in, H, H // sp


def mamba2_init_state(cfg, batch: int, device, sp: int = 1) -> MambaState:
    d_in, _, Hl = mamba2_dims(cfg, sp)
    ds, w = cfg.ssm.d_state, cfg.ssm.conv_width
    return MambaState(
        ssm=torch.zeros((batch, Hl, cfg.ssm.head_dim, ds), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, w - 1, d_in // sp + 2 * ds), dtype=torch.float32,
                         device=device))


def _causal_conv(x, conv_tail, kernel):
    """Depthwise causal conv.  x: [B, T, C]; conv_tail: [B, W - 1, C];
    kernel: [W, C].  Returns (y [B, T, C], new tail [B, W - 1, C] fp32),
    the taps summed in the reference's order."""
    W, T = kernel.shape[0], x.shape[1]
    xx = torch.cat([conv_tail.to(x.dtype), x], dim=1)
    y = xx[:, 0:T] * kernel[0]
    for i in range(1, W):
        y = y + xx[:, i:i + T] * kernel[i]
    return y, xx[:, -(W - 1):].float()


def pick_subchunk(t: int, cap: int = 128) -> int:
    """Largest power-of-two divisor of t, capped (the sub-chunk scan width)."""
    p = 1
    while p * 2 <= cap and t % (p * 2) == 0:
        p *= 2
    return p


def _segsum_decay(a):
    """a: [..., P] per-step log-decay.  L[..., t, s] = exp(sum_{s<j<=t} a_j)
    for s <= t, else 0; the mask is applied inside the exp."""
    P = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    tri = torch.ones((P, P), dtype=torch.bool, device=a.device).tril()
    return torch.exp(torch.where(tri, diff, -1e30))


def _carry(S0, tot, U):
    """The sub-chunk carry: S_{j+1} = S_j * tot_j + U_j from S_0 = S0, with
    tot [B, nc, H, n] broadcast over U's last dim ([B, nc, H, n, m]).
    Returns (the state entering each sub-chunk [B, nc, H, n, m], the state
    after the last)."""
    ins, S = [], S0
    for j in range(U.shape[1]):
        ins.append(S)
        S = S * tot[:, j, :, :, None] + U[:, j]
    return torch.stack(ins, dim=1), S


def mamba2_mixer(x, p, cfg, state: MambaState, *, name_tag=None, pre_gathered=False,
                 subchunk=128, ctx=SINGLE):
    """x: [B, T, d] (a chunk, or one decode token with ``pre_gathered``).
    Returns (y [B, T, d], new state).  The tag sites are the conv's x
    branch after the SiLU and the gated, normalized output before
    ``@ out`` (reference ``ssm.py:90-170``)."""
    _single_device(ctx, "mamba2_mixer")
    ssm = cfg.ssm
    d_in, H, _ = mamba2_dims(cfg)
    hd, ds = ssm.head_dim, ssm.d_state
    B, T, _ = x.shape
    xs = x @ p["in_x"]
    bc = x @ p["in_bc"]
    dt = x @ p["in_dt"] + p["dt_bias"]
    z = x @ p["in_z"]
    conv_out, new_tail = _causal_conv(torch.cat([xs, bc], dim=-1), state.conv,
                                      torch.cat([p["conv_x"], p["conv_bc"]], dim=-1))
    conv_out = F.silu(conv_out)
    xs, Bm, Cm = conv_out.split([d_in, ds, ds], dim=-1)
    if name_tag is not None:
        xs = name_tag(xs)
    dt = F.softplus(dt.float())                                  # [B, T, H]
    A = -torch.exp(p["A_log"].float())
    da = dt * A                                                  # log-decay
    xh = xs.reshape(B, T, H, hd).float()

    if T == 1:
        # one token (a decode step): the dual form at P = 1 is the recurrence
        # S' = S exp(dt A) + dt x B^T, y = S' C
        S = (state.ssm * torch.exp(da[:, 0])[:, :, None, None]
             + (dt[:, 0, :, None] * xh[:, 0])[..., None] * Bm.float()[:, 0, None, None, :])
        y = torch.einsum("bhdn,bn->bhd", S, Cm.float()[:, 0])[:, None]
    else:
        P = pick_subchunk(T, subchunk)
        nc = T // P
        xc = xh.reshape(B, nc, P, H, hd)
        Bc = Bm.float().reshape(B, nc, P, ds)
        Cc = Cm.float().reshape(B, nc, P, ds)
        dac = da.reshape(B, nc, P, H)
        dtc = dt.reshape(B, nc, P, H)
        # every sub-chunk's own terms at once
        Lmat = _segsum_decay(dac.transpose(-1, -2))              # [B, nc, H, t, s]
        w = torch.einsum("bcpn,bcqn->bcpq", Cc, Bc)[:, :, None] * Lmat
        y = torch.einsum("bchts,bcsh,bcshd->bcthd", w, dtc, xc)
        cs = torch.cumsum(dac, dim=2)
        cumin = torch.exp(cs)                                    # [B, nc, P, H]
        decay_s = torch.exp(cs[:, :, -1:] - cs)
        U = torch.einsum("bcph,bcphd,bcpn->bchdn", decay_s * dtc, xc, Bc)
        # the carry, then the incoming state's share of each sub-chunk
        S_in, S = _carry(state.ssm, cumin[:, :, -1, :, None].expand(B, nc, H, hd), U)
        y = y + torch.einsum("bcph,bcpn,bchdn->bcphd", cumin, Cc, S_in)
    y = y.reshape(B, T, H, hd) + xh * p["D"].float()[:, None]
    # gated per-head RMSNorm, then the output projection
    yg = (y.reshape(B, T, d_in) * F.silu(z.float())).reshape(B, T, H, hd)
    yg = yg * torch.rsqrt((yg * yg).mean(dim=-1, keepdim=True) + 1e-6)
    y = (yg.reshape(B, T, d_in) * (1.0 + p["norm_scale"].float())).to(x.dtype)
    if name_tag is not None:
        y = name_tag(y)
    return y @ p["out"], MambaState(ssm=S, conv=new_tail)


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------


class RWKVState(NamedTuple):
    wkv: torch.Tensor      # [B, H, dk, dv] fp32
    shift_t: torch.Tensor  # [B, 1, d] fp32, the previous chunk's last token (time-mix)
    shift_c: torch.Tensor  # [B, 1, d] fp32, the same for the channel-mix


def rwkv6_init_state(cfg, batch: int, device, sp: int = 1) -> RWKVState:
    H, dk = cfg.n_heads, cfg.hd
    return RWKVState(
        wkv=torch.zeros((batch, H, dk, dk), dtype=torch.float32, device=device),
        shift_t=torch.zeros((batch, 1, cfg.d_model), dtype=torch.float32, device=device),
        shift_c=torch.zeros((batch, 1, cfg.d_model), dtype=torch.float32, device=device))


def _shard_token_shift(x, prev_tail, ctx=SINGLE):
    """The previous-token view of a chunk: (x_prev [B, T, d], the chunk's
    last token [B, 1, d] fp32), the first row from the carried tail."""
    _single_device(ctx, "the RWKV token shift")
    x_prev = torch.cat([prev_tail.to(x.dtype), x[:, :-1]], dim=1)
    return x_prev, x[:, -1:].float()


def _compose_states(S_start, dec, S_loc, ctx=SINGLE):
    """(the state entering this rank's tokens, the state after them): at
    sp = 1 the carried state, and it decayed over the chunk plus the
    chunk's own."""
    _single_device(ctx, "the RWKV state composition")
    return S_start, S_start * dec[..., None] + S_loc


def rwkv6_time_mix(x, p, cfg, state: RWKVState, *, name_tag=None, pre_gathered=False,
                   subchunk=32, ctx=SINGLE):
    """RWKV6 time-mix (WKV6) of x [B, T, d]: (out [B, T, d], new state).
    The tag site is the gated, group-normed output before ``@ wo``
    (reference ``ssm.py:234-313``)."""
    _single_device(ctx, "rwkv6_time_mix")
    H, dk = cfg.n_heads, cfg.hd
    dv = dk
    B, T, d = x.shape
    xf = x.float()
    if pre_gathered:
        xprev, new_tail = state.shift_t.float(), xf[:, -1:]
    else:
        xprev, new_tail = _shard_token_shift(xf, state.shift_t, ctx)
    xx = xprev - xf
    # the data-dependent lerp through a small fp32 LoRA
    xbar = xf + xx * p["mu_x"]
    lora = torch.tanh(xbar @ p["ddl_a"]) @ p["ddl_b"]             # [B, T, 5 d]
    lam = lora.reshape(B, T, 5, d) + p["mu_rkvwg"]
    # the five lerps in one pass: each element as the reference's xf + xx * lam_i
    xr, xk, xv, xw, xg = (xf[:, :, None] + xx[:, :, None] * lam).to(x.dtype).unbind(dim=2)
    r = (xr @ p["wr"]).reshape(B, T, H, dk).float()
    k = (xk @ p["wk"]).reshape(B, T, H, dk).float()
    v = (xv @ p["wv"]).reshape(B, T, H, dv).float()
    g = F.silu(xg @ p["wg"])                                     # [B, T, d] gate
    # JAX promotes the model-dtype xw against the fp32 decay LoRA to fp32
    dd = p["w0"] + torch.tanh(xw.float() @ p["dec_a"]) @ p["dec_b"]
    lw = -torch.exp(dd.float()).reshape(B, T, H, dk)             # log-decay <= 0
    u = p["u"].reshape(H, dk).float()
    if T == 1:
        # one token (a decode step): the dual form at P = 1 is the recurrence
        # y = r (S + u k v^T), S' = S exp(lw) + k v^T
        r1, k1, v1 = r[:, 0], k[:, 0], v[:, 0]                   # [B, H, dk]
        kv = k1[..., None] * v1[..., None, :]
        y = torch.einsum("bhc,bhcv->bhv", r1, state.wkv + u[..., None] * kv)[:, None]
        S_fin = state.wkv * torch.exp(lw[:, 0])[..., None] + kv
        return _rwkv_out(y, p, g, x, name_tag), RWKVState(wkv=S_fin, shift_t=new_tail,
                                                          shift_c=state.shift_c)

    P = pick_subchunk(T, subchunk)
    nc = T // P

    def blocks(t):                                               # [B, nc, H, P, c]
        return t.reshape(B, nc, P, H, -1).permute(0, 1, 3, 2, 4)

    rb, kb, vb, lwb = blocks(r), blocks(k), blocks(v), blocks(lw)
    cs = torch.cumsum(lwb, dim=3)                                # inclusive
    cs_prev = cs - lwb                                           # exclusive
    # intra-sub-chunk per-channel decay in segsum form: every exponent <= 0
    tri = torch.ones((P, P), dtype=torch.bool, device=x.device).tril(-1)
    diff = cs_prev[..., :, None, :] - cs[..., None, :, :]        # [B, nc, H, t, s, c]
    dec_ts = torch.exp(torch.where(tri[:, :, None], diff, -1e30))
    del diff
    att = torch.einsum("bnhtc,bnhtsc,bnhsc->bnhts", rb, dec_ts, kb)
    del dec_ts
    diag = torch.einsum("bnhtc,hc,bnhtc->bnht", rb, u, kb)
    y = torch.einsum("bnhts,bnhsv->bnhtv", att, vb) + diag[..., None] * vb
    tot = torch.exp(cs[:, :, :, -1])                             # [B, nc, H, dk]
    U = torch.einsum("bnhsc,bnhsv->bnhcv", kb * torch.exp(cs[:, :, :, -1:] - cs), vb)
    # the carry from a zero state, as the reference's local scan; the
    # incoming state's share is added over the whole chunk below
    S_sub, S_loc = _carry(torch.zeros_like(state.wkv), tot, U)
    y = y + torch.einsum("bnhtc,bnhcv->bnhtv", rb * torch.exp(cs_prev), S_sub)
    dec_loc = tot.prod(dim=1)                                    # [B, H, dk]
    if pre_gathered:
        S_in, S_fin = state.wkv, state.wkv * dec_loc[..., None] + S_loc
    else:
        S_in, S_fin = _compose_states(state.wkv, dec_loc, S_loc, ctx)
    lw_cum_prev = torch.cumsum(lw, dim=1) - lw                   # [B, T, H, dk]
    y_in = torch.einsum("bthc,bhcv->bthv", r * torch.exp(lw_cum_prev), S_in)
    y = y.permute(0, 1, 3, 2, 4).reshape(B, T, H, dv) + y_in
    return _rwkv_out(y, p, g, x, name_tag), RWKVState(wkv=S_fin, shift_t=new_tail,
                                                      shift_c=state.shift_c)


def _rwkv_out(y, p, g, x, name_tag):
    """The time-mix's output from the WKV y [B, T, H, dv]: the per-head
    group norm (population variance), the gate, the tag site, ``@ wo``."""
    B, T, H, dv = y.shape
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    y = (y - mu) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, T, H * dv) * p["ln_x_scale"] + p["ln_x_bias"]
    y = (y * g).to(x.dtype)
    if name_tag is not None:
        y = name_tag(y)
    return y @ p["wo"]


def rwkv6_channel_mix(x, p, cfg, state: RWKVState, *, name_tag=None, pre_gathered=False,
                      ctx=SINGLE):
    """RWKV6 channel-mix (the FFN analogue) of x [B, T, d]: (out, new
    state).  The tag site is the squared-ReLU hidden before ``@ wv_c``."""
    _single_device(ctx, "rwkv6_channel_mix")
    xf = x.float()
    if pre_gathered:
        xprev, new_tail = state.shift_c.float(), xf[:, -1:]
    else:
        xprev, new_tail = _shard_token_shift(xf, state.shift_c, ctx)
    xx = xprev - xf
    xk = (xf + xx * p["mu_k"]).to(x.dtype)
    xr = (xf + xx * p["mu_r"]).to(x.dtype)
    h = F.relu(xk @ p["wk_c"]).square()
    if name_tag is not None:
        h = name_tag(h)
    kv = h @ p["wv_c"]
    out = torch.sigmoid((xr @ p["wr_c"]).float()).to(x.dtype) * kv
    return out, RWKVState(wkv=state.wkv, shift_t=state.shift_t, shift_c=new_tail)
