"""The ranks of the model-axis tests (tests/test_torch_model_axis.py):
functions that ``repro_torch.launch.mesh.spawn`` runs in each process.
Imports no JAX, so that a rank starts fast and the card tests
(tests/test_torch_cuda.py, run with ``--noconftest`` where there is no JAX)
can reuse them.

``collectives_rank`` holds each model-axis collective, its backward and the
two attention schedules on small tensors; ``layout_rank`` runs a list of
jobs, each one layout (dp x pp x sp ranks) of one reduced config under
plan overrides, and returns what the rank measured: its coordinates, the
loss, its gradients (its shard of each leaf), the context's counts, and,
where a job asks, the parameters after some training steps.
"""
import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import runner
from repro_torch.parallel.ctx import Ctx


def _np(t):
    """A numpy copy (an fp32 CPU tensor's ``numpy()`` shares its memory,
    which the in-place update would change)."""
    return np.array(t.detach().float().cpu().numpy())


def collectives_rank(rank, device, data):
    """Each collective of a 2-rank model group on ``data``'s arrays (x
    [4, 6]: rank r holds columns 3r:3r+3 where a shard is wanted; g: the
    rank's cotangent), forward and backward; then ``dist_attention`` under
    gather_q and gather_kv on this rank's rows of ``data["attn"]``.
    Returns numpy results keyed by name."""
    from repro_torch.models import attention as A

    torch.set_num_threads(1)
    out = {}
    ctx = Ctx(sp=2, device=device)
    m = ctx.model_index()
    x = torch.from_numpy(data["x"]).to(device)
    g = torch.from_numpy(data["g"][m]).to(device)
    shard = x[:, 3 * m:3 * m + 3].clone().requires_grad_()
    y = ctx.all_gather_model(shard, axis=1)
    y.backward(g)
    out["all_gather"], out["all_gather_grad"] = _np(y), _np(shard.grad)
    full = (x * (m + 1)).requires_grad_()
    y = ctx.reduce_scatter_model(full, axis=1)
    y.backward(g[:, :3])
    out["reduce_scatter"], out["reduce_scatter_grad"] = _np(y), _np(full.grad)
    full = (x * (m + 1)).requires_grad_()
    y = ctx.psum_model(full)
    y.backward(g)
    out["psum"], out["psum_grad"] = _np(y), _np(full.grad)
    mx = ctx.pmax_model((x * (m + 1) - 3 * m).requires_grad_())
    out["pmax"], out["pmax_requires_grad"] = _np(mx), mx.requires_grad
    comp = Ctx(sp=2, device=device, grad_compress=True)
    shard = x[:, 3 * m:3 * m + 3].clone().requires_grad_()
    comp.all_gather_param(shard, 1).backward(g)
    out["all_gather_param_bf16_grad"] = _np(shard.grad)
    out["ppermute"] = _np(ctx.ppermute_model(x * (m + 1), [(0, 1), (1, 0)]))
    # the all-to-all of expert parallelism: rank r's rows 2j:2j+2 go to
    # rank j, concatenated there along the columns; an integer tensor (the
    # expert ids) passes without a gradient
    sent = (x * (m + 1)).requires_grad_()
    y = ctx.all_to_all_model(sent, 0, 1)
    y.backward(g.reshape(y.shape))
    out["all_to_all"], out["all_to_all_grad"] = _np(y), _np(sent.grad)
    ids = torch.arange(8, dtype=torch.int32, device=device).reshape(4, 2) + 100 * m
    got = ctx.all_to_all_model(ids, 0, 0)
    out["all_to_all_ids"], out["all_to_all_ids_dtype"] = got.cpu().numpy(), str(got.dtype)
    out["all_to_all_counts"] = {k: v for k, v in ctx.counts().items()
                                if k.startswith("model_all_to_all")}
    # the attention schedules: this rank's rows of q, k, v of a chunk, the
    # cache shard holding this rank's positions
    a = data["attn"]
    T = a["q"].shape[1] // 2
    rows = slice(m * T, (m + 1) * T)
    for mode in ("gather_q", "gather_kv"):
        mctx = Ctx(sp=2, device=device, attn_mode=mode)
        q, k, v = (torch.from_numpy(a[n][:, rows]).to(device).requires_grad_()
                   for n in ("q", "k", "v"))
        pos = torch.from_numpy(a["pos"][rows]).to(device)
        qs = torch.from_numpy(a["q_start"][:, rows]).to(device)
        o = A.dist_attention(q, k, v, pos, pos, mctx, q_start=qs)
        o.backward(torch.from_numpy(a["do"][:, rows]).to(device))
        out[mode] = {"o": _np(o), "dq": _np(q.grad), "dk": _np(k.grad), "dv": _np(v.grad),
                     "counts": mctx.counts()}
    return out


def layout_overrides(layout: dict) -> dict:
    ov = dict(pp=layout.get("pp", 1), dp=layout.get("dp", 1), n_chunks=layout["n_chunks"],
              grad_accum=1, msp=layout.get("msp", False), msp_split=layout.get("msp_split", 2))
    ov.update(layout.get("plan", {}))
    return ov


def layout_rank(rank, device, jobs):
    """Each job of ``jobs`` (dicts, every one of this many ranks) on this
    rank; returns {job name: what the rank measured}."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {job["name"]: _one_job(rank, device, job) for job in jobs}


def _one_job(rank, device, job):
    """``job``: name, arch, layout (dp, pp, sp, n_chunks, msp, plan
    overrides), params (the JAX pp = 1 stack as numpy), tokens, labels
    [B, S] and optionally doc_start and doc_lens (a packed batch), alphas
    (replacing the cell's), and ``steps`` (train that many steps: the loss
    and every parameter after each, with lr_kwargs) or ``moments`` (train
    3 steps with the moments on the device and in host memory)."""
    import dataclasses

    dt = torch.float32
    cfg = get_config(job["arch"]).reduced()
    lay = job["layout"]
    sp = lay.get("sp", 1)
    world = lay.get("dp", 1) * lay.get("pp", 1) * sp
    tokens, labels = job["tokens"], job["labels"]
    B, S = tokens.shape

    def cell_of(**kw):
        ov = {**layout_overrides(lay), **kw}
        cell = runner.resolve_cell(cfg, ShapeConfig("t", S, B, "train"), overrides=ov,
                                   dtype=dt, data_size=world // sp, model_size=sp,
                                   doc_lens=job.get("doc_lens"))
        if "alphas" in job:
            cell = dataclasses.replace(cell, alphas=tuple(job["alphas"]))
        return cell

    cell = cell_of()
    ctx = cell.ctx(device=device)
    stage, g, m = ctx.stage_index(), ctx.dp_index(), ctx.model_index()

    def params():
        return params_from_numpy(job["params"], dtype=dt, device=device, stage=stage,
                                 pp=cell.plan.pp, cfg=cfg, sp=sp, model_rank=m)

    rows = slice(g * cell.b_loc, (g + 1) * cell.b_loc)
    tok = torch.from_numpy(tokens[rows]).to(device)
    lab = torch.from_numpy(labels[rows]).to(device)
    ds = (None if job.get("doc_start") is None
          else torch.from_numpy(job["doc_start"][rows]).to(device))
    out = dict(rank=rank, stage=stage, dp_index=g, model_index=m, alphas=cell.alphas,
               lengths=cell.sched.lengths)
    if "steps" in job:
        from repro_torch.optim import adamw

        p = params()
        state = adamw.init_state(p)
        step = runner.make_train_step(cell, lr_kwargs=job["lr_kwargs"], ctx=ctx)
        out["step_losses"], out["grad_norms"], out["params_after"] = [], [], []
        for _ in range(job["steps"]):
            p, state, met = step(p, state, tok, lab, ds)
            out["step_losses"].append(float(met["loss"]))
            out["grad_norms"].append(float(met["grad_norm"]))
            out["params_after"].append(tree.map_(_np, p))
        return out
    if "moments" in job:
        from repro_torch.optim import adamw

        runs = {}
        for on in (False, True):
            c = cell_of(offload_moments=on)
            p = params()
            state = adamw.init_state(p, offload_moments=on)
            step = runner.make_train_step(c, lr_kwargs=job["lr_kwargs"], ctx=ctx)
            for _ in range(job["moments"]):
                p, state, met = step(p, state, tok, lab, ds)
            runs[on] = [tree.map_(_np, t) for t in (p, state.m, state.v)]
        out["moments_off"], out["moments_on"] = runs[False], runs[True]
        return out
    ctx.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params(), tok, lab, ds, ctx=ctx)
    out["loss"] = float(loss)
    out["grads"] = tree.map_(_np, grads)
    out["ctx_counts"] = ctx.counts()
    return out
