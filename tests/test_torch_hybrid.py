"""The port's hybrid family, zamba2-7b (Mamba2 mixers in groups of
``shared_attn_every``, each group followed by the weight-shared attention
block), against the JAX reference, on the CPU, at fp32.

The reduced zamba2 of tests/_torch_ssm_cases.py: 5 mixers in groups of 2,
so 3 slots, the last with a ghost mixer at gate 0, and the shared block
applied 3 times a chunk, each application attending its own slot's cache.

- the train step at S 384 in 3 chunks under remat "none", plan (b) (offload
  off, remat "sppo": the chunk seams carry the mixers' state and the shared
  block's K/V between chunks) and plan (d) (offload on, every chunk
  offloading rows): the loss, the gradient of every leaf, the shared
  block's (summed over the 3 groups and the 3 chunks) included, and the
  parameters after one ``make_train_step``; D2H = H2D at the closed form
  of the hybrid tag shapes;
- static serving: prefill and 4 greedy decode steps, the tokens equal, the
  last hidden state, every group's shared-block cache and every mixer's
  state within 1e-4 x max |reference|;
- the CLIs with ``--arch zamba2-7b --reduced --device cpu``; a hybrid
  stack refuses to run without the globals it reads its shared block from;
- the parameters' shapes, fp32 leaves and markers leaf by leaf, the cost
  model's hybrid branches equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

import _torch_ssm_cases as C
from repro_torch.core import offload as ofl
from repro_torch.launch import serve, train
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.models.ssm import mamba2_dims
from repro_torch.models.transformer import ChunkMeta
from repro_torch.parallel import runner
from repro_torch.runtime import hostmem

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

ARCH = "zamba2-7b"
PLANS = {"none": dict(offload=False, remat="none"), "b": dict(offload=False, remat="sppo"),
         "d": {}}


def hybrid_offload_elems(cell) -> int:
    """Elements of a step's off rows by the hybrid tag shapes: per chunk and
    slot, split_rows of the chunk's rows of every mixer's two sites (the
    conv's x branch and the gated output, d_inner each; the ghost mixers
    run too) and of the shared block's q, k, v, attention output and MLP
    hidden."""
    cfg = cell.cfg
    d_in, _, _ = mamba2_dims(cfg)
    per_row = (cfg.shared_attn_every * 2 * d_in
               + 2 * cfg.n_heads * cfg.hd + 2 * cfg.n_kv_heads * cfg.hd + cfg.d_ff)
    return cell.mdef.n_slots * sum(ofl.split_rows(ln, a) * C.B * per_row
                                   for ln, a in zip(cell.sched.lengths, cell.alphas))


@pytest.mark.parametrize("plan", list(PLANS))
def test_train_step_matches_the_reference(plan):
    ref = C.jax_train(ARCH)
    assert ref["lengths"] == (128, 128, 128)
    cell = C.port_cell(ARCH, **PLANS[plan])
    assert cell.mdef.n_slots == 3
    if plan == "d":
        assert (cell.plan.offload, cell.plan.remat, cell.plan.prefetch) == (True, "sppo", "ahead")
        cell = dataclasses.replace(cell, alphas=(0.6, 1.0, 0.0))
    params = params_from_numpy(ref["params"], dtype=torch.float32, device="cpu")
    assert set(params["globals"]["shared"]) == {"ln1", "ln2", "attn", "mlp"}
    tokens, labels = torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["labels"])
    hostmem.reset_counts()
    loss, grads = runner.loss_and_grads(cell, params, tokens, labels)
    copied = hostmem.counts()
    n_bytes = hybrid_offload_elems(cell) * 4
    assert copied["d2h_bytes"] == copied["h2d_bytes"] == n_bytes
    assert (n_bytes > 0) == (plan == "d")
    # the ghost mixer's leaves get exact zeros
    assert all((g == 0).all() for g in (grads["stages"][2]["mamba"]["mix"]["in_x"][1],
                                        grads["stages"][2]["mamba"]["mix"]["out"][1]))
    step = runner.make_train_step(cell, lr_kwargs=C.LR)
    new, _, met = step(params, runner.init_opt_state(cell, params), tokens, labels)
    C.check_step(ARCH, cell, loss, grads, dict(loss=met["loss"], params=new))


def test_static_serving_matches_the_reference():
    ref = C.jax_serve(ARCH)
    got = C.port_serve(ref, ARCH)
    np.testing.assert_array_equal(got["tokens"], ref["tokens"])

    def close(a, want, what):
        err = np.abs(a - want).max()
        assert err <= 1e-4 * max(np.abs(want).max(), 1.0), f"{what}: {err}"

    close(got["last"], ref["last"], "last hidden")
    rs = ref["state"]
    for j, s in enumerate(got["state"]):
        for name in ("k", "v"):
            close(getattr(s["kv"], name).numpy(), getattr(rs["shared_kv"], name)[0, j],
                  f"slot {j} shared {name}")
        np.testing.assert_array_equal(s["kv"].pos.numpy(), rs["shared_kv"].pos[0, j])
        for i, st in enumerate(s["mamba"]):
            for name in ("ssm", "conv"):
                close(getattr(st, name).numpy(), getattr(rs["mamba"], name)[0, j, i],
                      f"slot {j} mixer {i} {name}")


def test_serve_and_train_clis_take_zamba():
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompt-len", "128",
                      "--batch", "2", "--decode-steps", "2"])
    tokens = np.asarray(out["tokens"])
    assert tokens.shape == (2, 2) and ((tokens >= 0) & (tokens < 256)).all()
    hist = train.main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq", "256",
                       "--batch", "2", "--n-chunks", "2", "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)


def test_hybrid_stack_needs_the_globals():
    mdef = build_model(C.tcfg(ARCH))
    stage = mdef.init_stage_params(torch.Generator(), torch.float32, "cpu")
    state = mdef.init_state(1, 8, torch.float32, "cpu")
    q_pos = torch.arange(8, dtype=torch.int32)
    meta = ChunkMeta(q_pos=q_pos, cache_off=0, kv_view=8, rope=runner._rope(mdef.cfg, q_pos))
    with pytest.raises(ValueError, match="needs the globals"):
        mdef.stage_apply(stage, state, torch.zeros(1, 8, mdef.cfg.d_model), meta)


@pytest.mark.parametrize("arch", [ARCH])
def test_params_and_markers_match_the_reference_leaf_by_leaf(arch):
    C.check_params_and_markers(arch)


@pytest.mark.parametrize("arch", [ARCH])
def test_costmodel_ssm_branches_match_the_reference(arch):
    C.check_costmodel(arch)
