"""The ranks of the port's multi-rank tests: functions that
``repro_torch.launch.mesh.spawn`` runs in each process.  Imports no JAX, so
that a rank starts fast and the card tests (tests/test_torch_cuda.py, run
with ``--noconftest`` where there is no JAX) can reuse them.

``pipeline_rank`` takes the reduced qwen2-7b's parameters as numpy arrays
(the JAX pp = 1 stack, in the port's converter's layout), a batch and a
layout, and returns what the tests hold against the reference: the loss and
every gradient of the rank's parameters under the default plan (with the
context's counts of what the call moved), and, where
asked, the same with prefetch "sync" and with offload off, the prefill
caches of the rank's stage, and the globals after two training steps.
"""
import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import runner


def layout_overrides(layout: dict, **kw) -> dict:
    return {**dict(pp=layout["pp"], dp=layout["dp"], n_chunks=layout["n_chunks"],
                   grad_accum=1, msp=layout.get("msp", False),
                   msp_split=layout.get("msp_split", 2)), **kw}


def _np(t):
    return t.detach().float().cpu().numpy()


def pipeline_rank(rank, device, runs, params_np, tokens, labels):
    """One rank of each run in ``runs``, a list of (name, layout, want) of
    the same number of ranks; returns {name: what the rank measured}."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {name: _one_layout(rank, device, layout, params_np, tokens, labels, want)
            for name, layout, want in runs}


def _one_layout(rank, device, layout, params_np, tokens, labels, want):
    """``layout``: dict(dp, pp, n_chunks, msp, msp_split, S, B); ``want``: a
    set of "grads", "ablations", "accum", "prefill", "steps"."""
    dt = torch.float32
    cfg = get_config("qwen2-7b").reduced()
    world = layout["dp"] * layout["pp"]
    S, B = layout["S"], layout["B"]

    def cell_of(kind="train", **kw):
        return runner.resolve_cell(cfg, ShapeConfig("t", S, B, kind),
                                   overrides=layout_overrides(layout, **kw), dtype=dt,
                                   data_size=world)

    cell = cell_of()
    ctx = cell.ctx(device=device)
    stage, g = ctx.stage_index(), ctx.dp_index()

    def params():
        return params_from_numpy(params_np, dtype=dt, device=device, stage=stage,
                                 pp=layout["pp"], cfg=cfg)

    rows = slice(g * cell.b_loc, (g + 1) * cell.b_loc)
    tok = torch.from_numpy(tokens[rows]).to(device)
    lab = torch.from_numpy(labels[rows]).to(device)
    out = dict(rank=rank, stage=stage, dp_index=g, alphas=cell.alphas)
    if "grads" in want:
        ctx.reset_counts()
        loss, grads = runner.loss_and_grads(cell, params(), tok, lab, ctx=ctx)
        out["loss"] = float(loss)
        out["grads"] = tree.map_(_np, grads)
        out["ctx_counts"] = ctx.counts()
    if "ablations" in want:
        # offload on (ahead and sync) against off, bitwise
        same = {}
        for name, kw in (("sync", dict(prefetch="sync")), ("off", dict(offload=False))):
            c = cell_of(**kw)
            l2, g2 = runner.loss_and_grads(c, params(), tok, lab, ctx=ctx)
            same[name] = bool(float(l2) == out["loss"]) and all(
                np.array_equal(_np(a), b) for a, b in zip(tree.leaves(g2),
                                                          tree.leaves(out["grads"])))
        out["ablations_bitwise"] = same
    if "accum" in want:
        # grad_accum = 2 (one row a microbatch) against the whole batch, on
        # labels without the sentinel (the microbatches' means then weigh
        # every token alike)
        whole = torch.roll(tok, -1, dims=1)
        out["accum"] = [(float(l_), tree.map_(_np, g_)) for l_, g_ in (
            runner.loss_and_grads(cell_of(grad_accum=a), params(), tok, whole, ctx=ctx)
            for a in (1, 2))]
    if "prefill" in want:
        pcell = runner.resolve_cell(
            cfg, ShapeConfig("p", S, B, "prefill"),
            overrides=dict(pp=layout["pp"], dp=layout["dp"], n_chunks=layout["n_chunks"],
                           msp=layout.get("msp", False), msp_split=layout.get("msp_split", 2)),
            dtype=dt, data_size=world)
        with torch.no_grad():
            state, last = runner.make_prefill_step(pcell, ctx)(params(), tok)
        out["prefill"] = [(_np(s["kv"].k), _np(s["kv"].v), s["kv"].pos.cpu().numpy())
                          for s in state]
        out["prefill_last"] = _np(last)
    if "steps" in want:
        from repro_torch.optim import adamw

        p = params()
        state = adamw.init_state(p)
        step = runner.make_train_step(cell, lr_kwargs=dict(peak=1e-2, warmup=1, total=10),
                                      ctx=ctx)
        losses = []
        for _ in range(2):
            p, state, met = step(p, state, tok, lab)
            losses.append(float(met["loss"]))
        out["step_losses"] = losses
        out["globals_after"] = tree.map_(_np, p["globals"])
    return out


def cli_rank(rank, device, argvs):
    """Each argv of ``argvs`` through the train CLI's ``main`` on this rank
    (the process group is already up, as under torchrun); returns each
    run's per-step losses."""
    from repro_torch.launch import train

    torch.set_num_threads(1)
    return [[r["loss"] for r in train.main(list(argv))] for argv in argvs]


def failing_rank(rank, device, bad_rank):
    """Raises on ``bad_rank``; the other ranks wait for it in a collective."""
    import torch.distributed as dist

    if rank == bad_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()
    return rank


def hanging_rank(rank, device):
    """Every rank waits for a message nobody sends."""
    import torch.distributed as dist

    buf = torch.zeros(1)
    dist.recv(buf, src=(rank + 1) % dist.get_world_size(), tag=99)
    return rank
