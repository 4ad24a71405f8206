"""The ranks of the port's MoE tests (tests/test_torch_moe.py): functions
that ``repro_torch.launch.mesh.spawn`` runs in each process.  Imports no
JAX, so that a rank starts fast.

``moe_rank`` takes the reduced granite-moe-1b-a400m's parameters as numpy
arrays (the JAX pp = 1 stack), a batch and a list of layouts of the same
number of ranks, and returns, per layout, this rank's loss, the gradient of
every parameter it holds (its stage's slots and the globals, at sp > 1 its
model shard of each) and its context's counts of what the call moved.
"""
import torch

from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.parallel import runner

ARCH = "granite-moe-1b-a400m"


def layout_cell(layout: dict):
    """The port's fp32 cell of ``layout`` at the reduced granite (4 experts,
    top-2, FFN 32): dict(dp, pp, sp, n_chunks, S, B, msp, plan) (plan:
    further plan overrides; default, the reference's default plan)."""
    ov = dict(pp=layout.get("pp", 1), dp=layout.get("dp", 1), n_chunks=layout["n_chunks"],
              grad_accum=1, partition="length", msp=layout.get("msp", False),
              msp_split=2, **layout.get("plan", {}))
    if layout.get("sp", 1) > 1:
        ov["sp"] = layout["sp"]
    return runner.resolve_cell(get_config(ARCH).reduced(),
                               ShapeConfig("t", layout["S"], layout["B"], "train"),
                               overrides=ov, dtype=torch.float32,
                               data_size=layout.get("dp", 1) * layout.get("pp", 1),
                               model_size=layout.get("sp", 1))


def _np(t):
    return t.detach().float().cpu().numpy()


def moe_rank(rank, device, layouts, params_np, tokens, labels):
    """This rank of each layout in ``layouts`` ({name: layout}); returns
    {name: dict(loss, grads, ctx_counts, stage, dp_index, model_index)}."""
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for name, layout in layouts.items():
        cell = layout_cell(layout)
        ctx = cell.ctx(device=device)
        stage, m = ctx.stage_index(), ctx.model_index()
        params = params_from_numpy(params_np, dtype=torch.float32, device=device, stage=stage,
                                   pp=cell.plan.pp, cfg=cell.cfg, sp=cell.plan.sp,
                                   model_rank=m)
        tok, lab = (torch.from_numpy(a).to(device) for a in cell.rows(ctx, tokens, labels))
        ctx.reset_counts()
        loss, grads = runner.loss_and_grads(cell, params, tok, lab, ctx=ctx)
        out[name] = dict(loss=float(loss), grads=tree.map_(_np, grads),
                         ctx_counts=ctx.counts(), stage=stage, dp_index=ctx.dp_index(),
                         model_index=m)
    return out


def all_to_all_closed_form(cell, *, replay: bool) -> dict:
    """(calls, bytes) of one rank's all-to-alls in one loss-and-gradients
    call at sp > 1: each MoE block's forward sends its rows, their expert
    ids (int32) and the experts' outputs back; its backward sends the two
    row cotangents; the sppo / full seam runs the forward a second time in
    its replay.  The rows of a chunk are B x (its length / sp) tokens of
    the rank, each all-to-all moves sp x C rows."""
    from repro_torch.models.moe import capacities

    cfg, plan = cell.cfg, cell.plan
    item = torch.finfo(cell.dtype).bits // 8
    n_fwd = 2 if replay else 1
    calls = nbytes = 0
    for ln in cell.sched.lengths:
        n_tok = cell.b_loc * (ln // plan.sp)
        C, _ = capacities(cfg, n_tok, plan.sp)
        rows = plan.sp * C
        per_layer_calls = 3 * n_fwd + 2
        per_layer_bytes = n_fwd * (2 * rows * cfg.d_model * item + rows * 4) \
            + 2 * rows * cfg.d_model * item
        calls += cfg.n_layers * per_layer_calls
        nbytes += cfg.n_layers * per_layer_bytes
    return dict(calls=calls, bytes=nbytes)
