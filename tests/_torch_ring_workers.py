"""The ranks of the ring and pod-axis tests (tests/test_torch_ring.py):
functions that ``repro_torch.launch.mesh.spawn`` runs in each process.
Imports no JAX, so that a rank starts fast and the card tests
(tests/test_torch_cuda.py, run with ``--noconftest`` where there is no JAX)
can reuse them.

``ring_rank`` runs everything one spawn asks of a rank, in turn: the
permutation checks (``Ctx.ppermute_model`` and its backward), ring
attention cases on this rank's rows of a sequence, layout jobs (one reduced
config under a pods x dp x pp x sp layout: the loss and the rank's
gradients, or training steps with and without ZeRO-1) and train CLI runs.
"""
import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import ring, runner
from repro_torch.parallel.ctx import Ctx

from _torch_model_axis_workers import _np, layout_overrides


def ring_rank(rank, device, data):
    """``data``: dict(perms: [(name, perm)], attention: {name: case},
    jobs: [job], cli: [argv]), every entry optional.  Returns what the rank
    measured, keyed like ``data``."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = torch.distributed.get_world_size()
    out = {}
    if data.get("perms"):
        ctx = Ctx(sp=world, device=device)
        out["perms"] = {name: _permute(ctx, perm, device) for name, perm in data["perms"]}
    if data.get("attention"):
        ctx = Ctx(sp=world, device=device, attn_mode="ring")
        out["attention"] = {name: attention_case(ctx, case, device)
                            for name, case in data["attention"].items()}
    out["jobs"] = {job["name"]: _job(rank, device, job) for job in data.get("jobs", ())}
    if data.get("cli"):
        from repro_torch.launch import train

        out["cli"] = [[r["loss"] for r in train.main(list(argv))] for argv in data["cli"]]
    return out


def _permute(ctx, perm, device):
    """x_r = (r + 1) x a ramp, float and int, along ``perm``; the float
    output times g_r = (r + 1) x ones differentiated: the rank's input
    gradient is its destination's g (zeros where it sends nothing)."""
    m = ctx.model_index()
    base = torch.arange(12, dtype=torch.float32, device=device).view(3, 4)
    x = (base * (m + 1)).requires_grad_()
    ints = torch.arange(5, dtype=torch.int32, device=device) + 10 * m
    ctx.reset_counts()
    y, yi = ctx.ppermute_model((x, ints), perm)
    (y * (m + 1)).sum().backward()
    return {"y": _np(y), "ints": yi.cpu().numpy(), "x_grad": _np(x.grad),
            "int_requires_grad": yi.requires_grad, "counts": ctx.counts()}


def attention_case(ctx, case, device):
    """``case``: q, k, v [B, T, heads, hd], pos [T], q_start [B, T] or None,
    causal.  This rank's rows [r T / sp, (r + 1) T / sp) through
    ``ring_attention``, its loss sum(o^2) differentiated (the global loss
    is the ranks' sum); returns the loss, o, dq, dk, dv of the rows and the
    context's counts."""
    sp, m = ctx.sp, ctx.model_index()
    T = case["q"].shape[1]
    rows = slice(m * T // sp, (m + 1) * T // sp)
    q, k, v = (torch.from_numpy(case[n][:, rows]).to(device).requires_grad_()
               for n in ("q", "k", "v"))
    pos = torch.from_numpy(case["pos"][rows]).to(device)
    qs = (None if case.get("q_start") is None
          else torch.from_numpy(case["q_start"][:, rows]).to(device))
    ctx.reset_counts()
    o = ring.ring_attention(q, k, v, pos, pos, ctx, causal=case["causal"], q_start=qs)
    loss = (o.float() ** 2).sum()
    loss.backward()
    return {"loss": float(loss.detach()), "o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad),
            "dv": _np(v.grad), "counts": ctx.counts()}


def _job(rank, device, job):
    """``job``: name, arch, layout (pods, dp, pp, sp, n_chunks, msp, plan
    overrides), params (the JAX pp = 1 stack as numpy), tokens, labels
    [B, S]; with ``steps``, train that many steps under each of
    ``step_plans`` (plan overrides by name; lr_kwargs) and return the loss,
    the parameters and the moments after the last, and the host moment
    bytes; else the loss and the rank's gradients."""
    dt = torch.float32
    cfg = get_config(job["arch"]).reduced()
    lay = job["layout"]
    pods, sp = lay.get("pods", 1), lay.get("sp", 1)
    data_size = lay.get("dp", 1) * lay.get("pp", 1)
    tokens, labels = job["tokens"], job["labels"]
    B, S = tokens.shape

    def cell_of(**kw):
        return runner.resolve_cell(cfg, ShapeConfig("t", S, B, "train"),
                                   overrides={**layout_overrides(lay), **kw}, dtype=dt,
                                   data_size=data_size, model_size=sp, pods=pods)

    cell = cell_of()
    ctx = cell.ctx(device=device)
    stage, m = ctx.stage_index(), ctx.model_index()

    def params():
        return params_from_numpy(job["params"], dtype=dt, device=device, stage=stage,
                                 pp=cell.plan.pp, cfg=cfg, sp=sp, model_rank=m)

    tok, lab = (torch.from_numpy(a).to(device) for a in cell.rows(ctx, tokens, labels))
    out = dict(rank=rank, stage=stage, dp_index=ctx.dp_index(), model_index=m,
               pod_index=ctx.pod_index(), zero1=cell.plan.zero1, b_loc=cell.b_loc)
    if "steps" in job:
        out["plans"] = {}
        for plan_name, ov in job["step_plans"].items():
            c = cell_of(**ov)
            p = params()
            state = runner.init_opt_state(c, p, ctx)
            step = runner.make_train_step(c, lr_kwargs=job["lr_kwargs"], ctx=ctx)
            ctx.reset_counts()
            losses = []
            for _ in range(job["steps"]):
                p, state, met = step(p, state, tok, lab)
                losses.append(float(met["loss"]))
            moments = [t for t in tree.leaves([state.m, state.v])]
            slices = runner.pod_slices(c, p, ctx)
            shapes = [tuple(t.shape) for t in tree.leaves(p)] if slices is None else [
                tuple(slices.of(i, t).shape) for i, t in enumerate(tree.leaves(p))]
            out["plans"][plan_name] = {
                "losses": losses, "params": tree.map_(_np, p),
                "moments": [_np(t) for t in moments],
                "moment_bytes": sum(t.numel() * t.element_size() for t in moments),
                "moment_bytes_closed_form": cm.moment_bytes_from_shapes(shapes),
                "pod_slices": None if slices is None else list(slices.dims),
                "counts": ctx.counts()}
        return out
    ctx.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params(), tok, lab, ctx=ctx)
    out["loss"] = float(loss)
    out["grads"] = tree.map_(_np, grads)
    out["ctx_counts"] = ctx.counts()
    return out
