"""The port's VLM family, llama-3.2-vision-11b (a gated cross-attention
layer over stub patch embeddings after every 5 self-attention layers),
against the JAX reference, on the CPU, at fp32.

The reduced config of tests/_torch_xattn_cases.py: one group of 5 self
layers and the cross layer, a context of 8 patches, the cross gates set to
0.5 and -0.3 in the numpy tree both packages load (at their init of 0 the
cross layer adds nothing).  What is held, and how:

- ``attention.cross_attention`` over ``make_cross_kv``'s K/V (a context
  with PAD rows past its 8 patches): output and K/V within 2e-5, the
  gradients of x, the context and every ``xattn`` leaf within 1e-4 x max
  |reference|;
- the train step at S 384 in 3 chunks under remat "none", plan (b) and
  plan (d) (every chunk but the last offloading rows): the loss, the
  gradient of every leaf (``xattn``, the gates and the self stack's
  included) and the parameters after one AdamW step; D2H = H2D at the
  closed form of the VLM's tag shapes (the cross layer's q, output and MLP
  hidden beside the self layers');
- static serving: prefill with the context and 4 greedy decode steps, the
  tokens equal, the last hidden state, every self cache and the cross K/V
  within 1e-4 x max;
- the CLIs with ``--arch llama-3.2-vision-11b --reduced --device cpu``;
  the full model's 8 groups; the gates at the reference's init leave the
  cross leaves without gradient;
- the parameters' shapes, fp32 leaves and markers leaf by leaf, the cost
  model's terms equal to the reference's (a VLM layer priced as a dense
  one, PERF.md §7);
- what is refused: sp > 1 and pp > 1 (NotImplementedError naming ROADMAP
  Queue 1 item 7), the paged engine (ValueError).
"""
import pytest
import torch

import _torch_xattn_cases as C
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.core import tree
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build_model
from repro_torch.parallel import runner

import _torch_cpu  # noqa: F401,E402  (one torch thread a test process)

ARCH = C.VLM


def test_cross_attention_and_its_kv_match_the_reference():
    C.check_cross_attention(ARCH)


@pytest.mark.parametrize("plan", list(C.PLANS))
def test_train_step_matches_the_reference(plan):
    C.run_train_step(ARCH, plan)


def test_static_serving_matches_the_reference():
    C.check_serving(ARCH)


def test_serve_and_train_clis_take_the_vlm():
    C.check_clis(ARCH)


def test_full_model_groups_and_shapes():
    """llama-3.2-vision-11b builds ⌈40 / 5⌉ = 8 groups, each 5 self layers
    stacked [5, ...] and one cross layer (the reference's 11.5 B
    parameters with the 8 cross layers), its cross gates 0 and fp32 at
    init; it resolves train, prefill and decode cells at sp = pp = 1."""
    mdef = build_model(ARCH)
    assert mdef.n_slots == 8
    stage = mdef.init_stage_params(torch.Generator(), device="meta")
    s0 = stage[0]
    assert tuple(s0["self"]["mlp"]["w1"].shape) == (5, 4096, 14336)
    assert tuple(s0["xattn"]["wk"].shape) == (4096, 1024)
    n = sum(t.numel() for t in tree.leaves(stage))
    n += sum(t.numel() for t in tree.leaves(mdef.init_globals(torch.Generator(),
                                                              device="meta")))
    assert 11.4e9 < n < 11.6e9, n
    small = build_model(C.tcfg(ARCH)).init_stage_params(torch.Generator(), torch.bfloat16,
                                                         "cpu")
    for name in C.GATES:
        assert small[0][name].dtype == torch.float32 and float(small[0][name]) == 0.0
    for kind in ("train", "prefill", "decode"):
        cell = runner.resolve_cell(ARCH, ShapeConfig("c", 8192, 1, kind), overrides=dict(pp=1, dp=1))
        assert (cell.plan.sp, cell.plan.pp, cell.mdef.n_context()) == (1, 1, 1600)


def test_gates_at_init_switch_the_cross_layer_off():
    """At the reference's init (both cross gates 0) the cross layer adds
    nothing: its ``xattn`` and ``xmlp`` leaves get exactly zero gradient,
    the loss does not see the context.  Why the parity tests set them."""
    cell = C.port_cell(ARCH, offload=False, remat="none")
    params = serve.build_params(cell, "cpu", seed=0)
    ref = C.jax_train(ARCH)
    tokens, labels = torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["labels"])
    ctxt = torch.from_numpy(ref["context"])
    loss, grads = runner.loss_and_grads(cell, params, tokens, labels, context=ctxt)
    loss2, _ = runner.loss_and_grads(cell, params, tokens, labels, context=2 * ctxt)
    assert float(loss) == float(loss2)
    for path, g in tree.items(grads["stages"][0]):
        if path.startswith(("xattn", "xmlp")):
            assert (g == 0).all(), path
    assert float(grads["stages"][0]["xgate_attn"]) != 0.0


@pytest.mark.parametrize("arch", [ARCH])
def test_params_and_markers_match_the_reference_leaf_by_leaf(arch):
    C.check_params_and_markers(arch)


@pytest.mark.parametrize("arch", [ARCH])
def test_costmodel_matches_the_reference(arch):
    C.check_costmodel(arch)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_vlm_refuses_what_later_slices_bring(kind):
    """sp > 1 and pp > 1 raise NotImplementedError naming ROADMAP Queue 1
    item 7; the paged engine raises ValueError, as the reference asserts."""
    C.check_refusals(ARCH, kind)


def test_cross_attention_refuses_the_model_axis():
    """The context sharded over the model axis is a later slice."""
    import types

    from repro_torch.models import attention as A

    cfg = C.tcfg(ARCH)
    ctx = types.SimpleNamespace(sp=2)
    p = build_model(cfg).init_stage_params(torch.Generator(), torch.float32, "cpu")[0]["xattn"]
    x = torch.zeros((1, 4, cfg.d_model))
    for fn in (lambda: A.make_cross_kv(x, p, cfg, 4, ctx=ctx),
               lambda: A.cross_attention(x, p, cfg, None, ctx=ctx)):
        with pytest.raises(NotImplementedError, match="item 7"):
            fn()


def test_run_pipeline_needs_the_context():
    cell = C.port_cell(ARCH, offload=False, remat="none")
    params = serve.build_params(cell, "cpu", seed=0)
    tokens = torch.zeros((C.B, C.S), dtype=torch.int64)
    with pytest.raises(ValueError, match="context"):
        runner.loss_and_grads(cell, params, tokens, tokens)
    assert get_config(ARCH).cross_attn.every == 5
