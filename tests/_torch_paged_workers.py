"""The ranks of the serving tests (tests/test_torch_paged.py): functions
that ``repro_torch.launch.mesh.spawn`` runs in each process.  Imports no
JAX, so that a rank starts fast and the card tests (tests/test_torch_cuda.py,
run with ``--noconftest`` where there is no JAX) can reuse them.

``serve_rank`` runs a list of jobs on one process group, each a layout of
the reduced qwen2-7b at fp32 (unless a job names its dtype) from the same
numpy parameters, and returns what the rank measured:

- "static": ``resolve_cell`` + ``make_prefill_step`` + ``make_serve_step``
  at the job's dp x pp x sp: this rank's prefill caches, decoded tokens
  (every stage's at pp > 1) and caches after decoding, and the context's
  counts of the decode steps alone;
- "contract": the cache contract of tests/test_serving.py at the job's
  layout: this rank's caches after prefill(S) and one decode step of the
  last prompt token, and after prefill(S + 1) of the prompt with that
  token appended;
- "engine": a ``ServeEngine`` at the job's mesh running each trace in the
  modes it names, and each request of a trace alone (``solo``);
- "cli": ``launch.serve.main`` with the job's arguments.
"""
import numpy as np
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import runner


def _np(t):
    return np.array(t.detach().float().cpu().numpy())


def _caches(state):
    """[slots, ...] numpy k, v and pos of a stage's caches."""
    return {n: np.stack([_np(getattr(s["kv"], n)) if n != "pos"
                         else s["kv"].pos.cpu().numpy() for s in state])
            for n in ("k", "v", "pos")}


def _dtype(job):
    return getattr(torch, job.get("dtype", "float32"))


def _params(job, ctx, device, cfg, pp):
    return params_from_numpy(job["params"], dtype=_dtype(job), device=device,
                             stage=ctx.stage_index(), pp=pp, cfg=cfg, sp=ctx.sp,
                             model_rank=ctx.model_index())


def _cells(job, cfg, S, B):
    lay = job["layout"]
    dp, pp, sp = lay.get("dp", 1), lay.get("pp", 1), lay.get("sp", 1)
    sizes = dict(data_size=dp * pp, model_size=sp, dtype=_dtype(job))
    pre = runner.resolve_cell(cfg, ShapeConfig("p", S, B, "prefill"),
                              overrides=dict(pp=pp, dp=dp, n_chunks=lay.get("n_chunks", 1),
                                             offload=False, remat="none",
                                             **lay.get("plan", {})), **sizes)
    dec = runner.resolve_cell(cfg, ShapeConfig("d", S, B, "decode"),
                              overrides=dict(pp=pp, dp=dp, **lay.get("dec_plan", {})), **sizes)
    return pre, dec


def _static(job, device):
    cfg = get_config(job["arch"]).reduced()
    prompts = job["prompts"]
    B, S = prompts.shape
    pre, dec = _cells(job, cfg, S, B)
    ctx = pre.ctx(device=device)
    params = _params(job, ctx, device, cfg, pre.plan.pp)
    rows = serve.shard_rows(prompts, dec.plan.dp, dec.plan.pp)[0, ctx.data_index()]
    state, _ = runner.make_prefill_step(pre, ctx)(params, torch.from_numpy(rows).to(device))
    out = dict(rank=ctx.rank, stage=ctx.stage_index(), model=ctx.model_index(),
               prefill=_caches(state), chunks=pre.sched.lengths,
               microbatch=dec.plan.decode_microbatch)
    # the decode cell's context (its plan has the default attention schedule)
    ctx = dec.ctx(device=device)
    step = runner.make_serve_step(dec, decode_steps=job["steps"], ctx=ctx)
    cur = torch.from_numpy(serve.shard_rows(prompts[:, -1:], dec.plan.dp, dec.plan.pp)
                           [0, ctx.data_index()]).to(device)
    toks = []
    for i in range(job["steps"]):
        state, cur = step(params, state, cur, S + i)
        toks.append(cur[:, 0].cpu().numpy())
    out.update(tokens=np.stack(toks, axis=1), decoded=_caches(state), counts=ctx.counts())
    return out


def _contract(job, device):
    cfg = get_config(job["arch"]).reduced()
    prompts = job["prompts"]
    B, S = prompts.shape
    ext = np.concatenate([prompts, prompts[:, -1:]], axis=1)
    pre_s, dec = _cells(job, cfg, S, B)
    pre_s1, _ = _cells(job, cfg, S + 1, B)
    ctx = pre_s.ctx(device=device)
    params = _params(job, ctx, device, cfg, pre_s.plan.pp)
    dp, pp, row = dec.plan.dp, dec.plan.pp, ctx.data_index()

    def rows(a):
        return torch.from_numpy(serve.shard_rows(a, dp, pp)[0, row]).to(device)

    state, _ = runner.make_prefill_step(pre_s, ctx)(params, rows(prompts))
    state, _ = runner.make_serve_step(dec, ctx=ctx)(params, state, rows(prompts[:, -1:]), S)
    state1, _ = runner.make_prefill_step(pre_s1, ctx)(params, rows(ext))
    return dict(rank=ctx.rank, decoded=_caches(state), longer=_caches(state1))


def _engine(job, device):
    lay = job["layout"]
    mesh = (lay.get("dp", 1), lay.get("sp", 1))
    cfg = get_config(job["arch"]).reduced()
    # the model rank of this process (rank = data index x sp + model index)
    model_rank = torch.distributed.get_rank() % mesh[1]
    params = params_from_numpy(job["params"], dtype=_dtype(job), device=device, cfg=cfg,
                               sp=mesh[1], model_rank=model_rank)
    eng = serve.ServeEngine(cfg, mesh, device=device, dtype=_dtype(job), params=params,
                            **job["engine"])
    out = dict(rank=eng.ctx.rank, pos_map=eng.pos_map, pool_bytes_closed_form=
               eng.predicted_pool_bytes(), traces=[])
    for trace in job["traces"]:
        reqs = [serve.Request(**r) for r in trace]
        res = {}
        for mode in job["modes"]:
            toks, stats = eng.run(reqs, mode=mode)
            res[mode] = dict(tokens=toks, stats=stats)
        if job.get("solo"):
            res["solo"] = {r.rid: eng.run([serve.Request(rid=r.rid, prompt=r.prompt,
                                                         max_new=r.max_new)],
                                          mode="static")[0][r.rid] for r in reqs}
        out["traces"].append(res)
    out["counts"] = eng.ctx.counts()
    return out


def _cli(job, device):
    return {name: serve.main(argv) for name, argv in job["argv"].items()}


JOBS = {"static": _static, "contract": _contract, "engine": _engine, "cli": _cli}


def serve_rank(rank, device, jobs):
    """Run ``jobs`` (dicts with a "kind" of ``JOBS`` and a "name") in order
    on this rank; returns {name: result}."""
    torch.set_num_threads(1)
    return {job["name"]: JOBS[job["kind"]](job, device) for job in jobs}
