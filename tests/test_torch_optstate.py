"""AdamW's moments in host memory and the compressed host channels' codec,
in the port against the JAX reference, on the CPU (DESIGN.md §11, §14).

- The codec (``runtime/hostmem.py``): on the same numpy input, payload and
  scale equal the reference's bit for bit; round trips within ``ROW_TOL``;
  constant and zero rows; the int8 transport view; an unknown codec.  The
  one departure: a row whose scale is subnormal (float32's least normal
  value, 1.1754944e-38, is the explicit case) comes back as zeros from the
  reference, whose XLA CPU backend flushes the scale to zero, and within
  ``ROW_TOL`` from the port.  Fixed parametrized cases, no hypothesis.
- The moment and codec terms of ``core/costmodel.py`` equal the
  reference's on the same inputs; full-depth qwen2-7b's moment bytes come
  from the closed forms over meta-device shapes, never allocated.
- ``optim/adamw.py`` with the moments in host memory: offload on ≡ off
  bitwise after three steps, clip active and inactive, and ≡ the
  reference's offloaded update at 1e-6
  (tests/test_opt_offload.py::test_offload_identity_after_three_steps at
  pp = 1); the compressed moments' residency and drift at the reference's
  bounds (tests/test_offload_quant.py::test_compressed_moments_residency_and_drift)
  and against the reference's compressed update; the copies' bytes
  against the closed forms; what raises
  (test_moments_dtype_requires_explicit_offload).
- The train CLI's four moment and codec flags run on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core import costmodel as jcm
from repro.models.model_zoo import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.runtime import hostmem as jhostmem
from repro_torch.configs.base import get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import tree
from repro_torch.launch import train
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw
from repro_torch.runtime import hostmem

# the reference's pinned codec resolutions (tests/test_offload_quant.py)
ROW_TOL = {"fp8": 0.07, "int8": 0.01}
LEAST_NORMAL = float(np.finfo(np.float32).tiny)   # 1.1754944e-38
CODECS = ["fp8", "int8"]


def _bits(payload, codec):
    """A payload's bytes as numpy, from either framework."""
    if isinstance(payload, torch.Tensor):
        return payload.view(torch.int8).numpy()
    return np.asarray(payload).view(np.int8)


def _codec_inputs():
    rng = np.random.default_rng(0)
    decades = (10.0 ** np.arange(-3, 3).repeat(4))[:, None]
    mixed = rng.standard_normal((5, 9)).astype(np.float32)
    mixed[1], mixed[3] = 0.0, 3.5
    return {"decades": (rng.standard_normal((24, 64)) * decades).astype(np.float32),
            "heads": rng.standard_normal((2, 7, 4, 16)).astype(np.float32),
            "large": (rng.standard_normal((3, 33)) * 1e4).astype(np.float32),
            "mixed": mixed,
            "scalar": np.array(-2.5, np.float32)}


# ---------------------------------------------------------------------------
# the codec's primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(_codec_inputs()))
@pytest.mark.parametrize("codec", CODECS)
def test_codec_payload_and_scale_equal_reference_bitwise(codec, case, dtype):
    x = _codec_inputs()[case]
    jp, js = jhostmem.quantize(jnp.asarray(x, dtype), codec)
    tp, ts = hostmem.quantize(torch.from_numpy(x.copy()).to(getattr(torch, dtype)), codec)
    assert tp.dtype == hostmem.codec_wire_dtype(codec) and ts.dtype == torch.float32
    assert tuple(ts.shape) == np.shape(js) == (x.shape[:-1] + (1,) if x.ndim else ())
    np.testing.assert_array_equal(_bits(tp, codec), _bits(jp, codec))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = hostmem.dequantize(tp, ts, codec, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jhostmem.dequantize(jp, js, codec, jnp.float32)))


@pytest.mark.parametrize("codec", CODECS)
def test_codec_round_trip_within_row_resolution(codec):
    """Per-row error within the codec's resolution across 6 decades of row
    magnitude (tests/test_offload_quant.py's case)."""
    x = torch.from_numpy(_codec_inputs()["decades"])
    p, s = hostmem.quantize(x, codec)
    y = hostmem.dequantize(p, s, codec, torch.float32)
    err = (x - y).abs().amax(dim=-1)
    amax = x.abs().amax(dim=-1)
    assert bool((err <= ROW_TOL[codec] * amax).all()), (err / amax)
    assert s.shape == (24, 1)


@pytest.mark.parametrize("rows", [1, 6])
@pytest.mark.parametrize("val", [0.0, -0.0, 1.0, -3.5, 447.9, 448.0, -448.0, 2.5e-8,
                                 1e-30, LEAST_NORMAL, -LEAST_NORMAL])
@pytest.mark.parametrize("codec", CODECS)
def test_codec_degenerate_constant_rows(codec, val, rows):
    """Constant rows, zero ones included, survive the round trip: no NaN or
    inf, zeros exact with scale 1.0, constants within ROW_TOL.  Where the
    scale (|val| / qmax) is a normal float the payload and scale are the
    reference's bit for bit; where it is subnormal (``LEAST_NORMAL``: 2.6e-41
    for fp8, 9.3e-41 for int8) the reference flushes it to zero and returns
    zeros, and the port still returns the row within ROW_TOL."""
    x = np.full((rows, 16), val, np.float32)
    p, s = hostmem.quantize(torch.from_numpy(x), codec)
    y = hostmem.dequantize(p, s, codec, torch.float32).numpy()
    assert np.isfinite(y).all()
    if val == 0.0:
        assert (y == 0.0).all() and (s == 1.0).all()
    else:
        assert (np.abs(y - val) <= ROW_TOL[codec] * abs(val)).all(), (y[0, 0], val)
    scale = abs(val) / {"fp8": 448.0, "int8": 127.0}[codec]
    if scale == 0.0 or scale >= LEAST_NORMAL:
        jp, js = jhostmem.quantize(jnp.asarray(x), codec)
        np.testing.assert_array_equal(_bits(p, codec), _bits(jp, codec))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_codec_zero_rows_exact_among_live_rows():
    x = torch.stack([torch.zeros(8), torch.ones(8) * 3.5, torch.zeros(8),
                     torch.linspace(-2.0, 2.0, 8)])
    for codec in CODECS:
        p, s = hostmem.quantize(x, codec)
        y = hostmem.dequantize(p, s, codec, torch.float32)
        assert (y[0] == 0).all() and (y[2] == 0).all(), codec
        assert (y[1] != 0).any()


def test_transport_views_round_trip_bits():
    """int8 crosses the link as the reference's fp8 byte container, bit for
    bit both ways; an fp8 payload passes through, and its bytes survive an
    int8 view too."""
    p = torch.arange(-128, 128, dtype=torch.int8).reshape(16, 16)
    t = hostmem.to_transport(p, "int8")
    assert t.dtype == torch.float8_e4m3fn and t.shape == p.shape
    back = hostmem.from_transport(t, "int8")
    assert back.dtype == torch.int8 and torch.equal(back, p)
    np.testing.assert_array_equal(
        _bits(t, "int8"), _bits(jhostmem.to_transport(jnp.asarray(p.numpy()), "int8"), "int8"))
    f = torch.arange(-128, 128, dtype=torch.int8).view(torch.float8_e4m3fn)
    assert hostmem.to_transport(f, "fp8") is f and hostmem.from_transport(f, "fp8") is f
    assert torch.equal(f.view(torch.int8).view(torch.float8_e4m3fn).view(torch.int8),
                       f.view(torch.int8))


def test_unknown_codec_rejected():
    with pytest.raises(ValueError, match="unknown offload codec"):
        hostmem.codec_wire_dtype("fp4")
    with pytest.raises(ValueError, match="unknown offload codec"):
        cm.codec_itemsize("fp4")


# ---------------------------------------------------------------------------
# the cost model's moment and codec terms
# ---------------------------------------------------------------------------

SHAPES = [(16, 32), (32,), (), (3, 4, 5), (3584, 512)]


@pytest.mark.parametrize("arch", ["qwen2-7b", "sppo-gpt-7b"])
def test_costmodel_terms_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cm.SCALE_ITEMSIZE == jcm.SCALE_ITEMSIZE
    assert cm.tagged_scale_elems_per_token(cfg) == jcm.tagged_scale_elems_per_token(jcfg)
    lengths = (2560, 2048, 1920, 1664)
    for codec in ("none", "fp8", "int8"):
        assert cm.codec_itemsize(codec) == jcm.codec_itemsize(codec)
        assert cm.offload_wire_ratio(codec) == jcm.offload_wire_ratio(codec)
        for kw in (dict(batch=1, pp=1, sp=1), dict(batch=4, pp=1, sp=1, grad_accum=2)):
            assert (cm.chunk_scale_bytes(cfg, lengths, offload_dtype=codec, **kw)
                    == jcm.chunk_scale_bytes(jcfg, lengths, offload_dtype=codec, **kw))
        assert (cm.moment_bytes_from_shapes(SHAPES, "float32", codec)
                == jcm.moment_bytes_from_shapes(SHAPES, "float32", codec))
        for row_len in (1, 1024, 3584):
            assert (cm.moment_wire_bytes_per_param("float32", codec, row_len=row_len)
                    == jcm.moment_wire_bytes_per_param("float32", codec, row_len=row_len))
    assert cm.moment_bytes_per_param() == jcm.moment_bytes_per_param("float32") == 8.0
    assert cm.opt_state_bytes(12345) == jcm.opt_state_bytes(12345, "float32")


def _full_depth_shapes():
    """qwen2-7b's parameter shapes at its 28 layers, from the meta device:
    nothing allocated."""
    mdef = build_model(get_config("qwen2-7b"))
    gen = torch.Generator()
    params = {"stages": mdef.init_stage_params(gen, device="meta"),
              "globals": mdef.init_globals(gen, device="meta")}
    return [tuple(t.shape) for t in tree.leaves(params)]


def test_full_depth_moment_bytes_from_the_closed_forms():
    """The host memory qwen2-7b's moments need at 28 layers and published
    widths (vocab padded to 153600): 61.1 GB fp32, 15.3 GB under a codec
    (scales under 0.1 GB); the reference's closed form on the same shapes
    says the same."""
    shapes = _full_depth_shapes()
    n = sum(int(np.prod(s)) for s in shapes)
    assert 7.6e9 < n < 7.7e9
    raw = cm.moment_bytes_from_shapes(shapes)
    assert raw == cm.opt_state_bytes(n) == jcm.moment_bytes_from_shapes(shapes, "float32")
    assert 61.0e9 < raw < 61.2e9
    for codec in CODECS:
        comp = cm.moment_bytes_from_shapes(shapes, "float32", codec)
        assert comp == jcm.moment_bytes_from_shapes(shapes, "float32", codec)
        assert 0 < comp - 2 * n < 0.1e9 and 15.2e9 < comp < 15.4e9


# ---------------------------------------------------------------------------
# moments in host memory: offload on ≡ off, and ≡ the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _stage_params():
    """The reference test's parameters: reduced sppo-gpt-7b's stage tree at
    pp = 1 (stacked slot dim), fp32, as numpy."""
    mdef = jbuild_model(jget_config("sppo-gpt-7b").reduced())
    stage = mdef.init_stage_params(jax.random.PRNGKey(0), 0, 1, jnp.float32)
    return jax.tree_util.tree_map(lambda a: np.asarray(a[None]), stage)


def _grads(params, scale, seed=3):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32), params)


def _to_torch(np_tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), np_tree)


@pytest.mark.parametrize("clip_active", [True, False])
def test_offload_identity_after_three_steps(clip_active):
    """Three updates with the moments in host memory equal three with them
    on the device bitwise (parameters, m and v), and the reference's
    offloaded update at 1e-6, clip active (gradients x 1e3) and inactive
    (x 1e-4)."""
    params = _stage_params()
    grads = _grads(params, 1e3 if clip_active else 1e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jadamw.init_state(jp, jnp.float32, offload_moments=True)
    jg = jax.tree_util.tree_map(jnp.asarray, grads)
    p_on, p_off, g = _to_torch(params), _to_torch(params), _to_torch(grads)
    s_on = adamw.init_state(p_on, offload_moments=True)
    s_off = adamw.init_state(p_off)
    assert s_on.host is not None and s_off.host is None
    for _ in range(3):
        jp, js, jm = jadamw.apply_update(jp, jg, js, lr=1e-3, offload_moments=True)
        p_on, s_on, m_on = adamw.apply_update(p_on, g, s_on, lr=1e-3, offload_moments=True)
        p_off, s_off, _ = adamw.apply_update(p_off, g, s_off, lr=1e-3)
    assert int(s_on.step) == int(s_off.step) == int(js.step) == 3
    assert (float(jm["grad_norm"]) > 1.0) == clip_active
    for on, off, ref in zip(tree.leaves([p_on, s_on.m, s_on.v]),
                            tree.leaves([p_off, s_off.m, s_off.v]),
                            jax.tree_util.tree_leaves([jp, js.m, js.v])):
        assert torch.equal(on, off)
        np.testing.assert_allclose(on.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


def _tiny_params():
    """tests/test_offload_quant.py::_tiny_params, as numpy."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(3), 3)
    return {"w": np.asarray(jax.random.normal(k1, (16, 32), jnp.float32) * 0.1),
            "o": np.asarray(jax.random.normal(k2, (32, 16), jnp.float32) * 0.1),
            "b": np.asarray(jax.random.normal(k3, (32,), jnp.float32) * 0.1)}


def _tiny_grads(params):
    """The reference test's gradients: one normal draw per leaf shape."""
    return {k: np.asarray(jax.random.normal(jax.random.PRNGKey(9), p.shape, jnp.float32))
            for k, p in params.items()}


def _run_port(params, grads, moments_dtype, steps=2, offload=True):
    p = _to_torch(params)
    g = _to_torch(grads)
    state = adamw.init_state(p, offload_moments=offload, moments_dtype=moments_dtype)
    outs = []
    for _ in range(steps):
        p, state, _ = adamw.apply_update(p, g, state, lr=1e-2, offload_moments=offload,
                                         moments_dtype=moments_dtype)
        outs.append({k: v.clone() for k, v in p.items()})
    return outs, state


def _flat(p):
    return np.concatenate([np.asarray(p[k], np.float64).ravel() for k in sorted(p)])


@pytest.mark.parametrize("codec,tol", [("fp8", 1e-2), ("int8", 3e-2)])
def test_compressed_moments_residency_and_drift(codec, tol):
    """The reference test on the port: host leaves are (payload, scale)
    pairs in the wire dtype; step 1 equals the raw update at 1e-6 (zero
    moments dequantize to zero); the step-2 parameters, the first that read
    quantized moments back, drift from the raw ones within the codec's
    bound and not zero.  And the port's compressed run equals the
    reference's: the same payloads and scales at step 1, the step-2
    parameters within 1e-6."""
    params, grads = _tiny_params(), _tiny_grads(_tiny_params())
    (p1_c, p2_c), state_c = _run_port(params, grads, codec)
    (p1_r, p2_r), _ = _run_port(params, grads, "none")
    for k in params:
        np.testing.assert_allclose(p1_c[k].numpy(), p1_r[k].numpy(), rtol=0, atol=1e-6)
    drift = np.linalg.norm(_flat(p2_c) - _flat(p2_r)) / np.linalg.norm(_flat(p2_r))
    assert 0.0 < drift <= tol, (codec, drift)
    wire = hostmem.codec_wire_dtype(codec)
    for entries in (state_c.m, state_c.v):
        for k, p in params.items():
            payload, scale = entries[k]
            assert payload.dtype == wire and payload.shape == p.shape
            assert scale.dtype == torch.float32 and scale.shape == p.shape[:-1] + (1,)
    assert len(tree.leaves(state_c.m)) == 2 * len(params)
    # the reference's compressed run
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jg = {k: jnp.asarray(v) for k, v in grads.items()}
    js = jadamw.init_state(jp, jnp.float32, offload_moments=True, moments_dtype=codec)
    for step in range(2):
        jp, js, _ = jadamw.apply_update(jp, jg, js, lr=1e-2, offload_moments=True,
                                        moments_mode="explicit", moments_dtype=codec)
        want = p1_c if step == 0 else p2_c
        for k in params:
            np.testing.assert_allclose(want[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6)
    for entries, jentries in ((state_c.m, js.m), (state_c.v, js.v)):
        for k in params:
            (tp, ts), (jpay, jsc) = entries[k], jentries[k]
            np.testing.assert_array_equal(_bits(tp, codec), _bits(jpay, codec))
            np.testing.assert_allclose(ts.numpy(), np.asarray(jsc), rtol=1e-6, atol=0)


@pytest.mark.parametrize("codec", ["none", "fp8", "int8"])
def test_moment_bytes_and_copies_match_the_closed_form(codec):
    """Host-resident moment bytes (payload and scales, or fp32) equal the
    cost model's closed form over the same shapes; one update copies them
    each way exactly, one H2D and one D2H per host tensor."""
    params = _tiny_params()
    p = _to_torch(params)
    state = adamw.init_state(p, offload_moments=True, moments_dtype=codec)
    held = sum(t.numel() * t.element_size() for t in tree.leaves([state.m, state.v]))
    want = cm.moment_bytes_from_shapes([v.shape for v in params.values()], "float32", codec)
    assert held == want
    hostmem.reset_counts()
    adamw.apply_update(p, _to_torch(_tiny_grads(params)), state, lr=1e-2,
                       offload_moments=True, moments_dtype=codec)
    c = hostmem.counts()
    n_host = len(tree.leaves([state.m, state.v]))
    assert c["moment_h2d_bytes"] == c["moment_d2h_bytes"] == want
    assert c["moment_h2d"] == c["moment_d2h"] == n_host
    assert c["d2h"] == c["h2d"] == 0          # the rows' counters stay apart


def test_moments_dtype_requires_explicit_offload():
    """A codec needs the moments in host memory, and ``moments_mode="xla"``
    (the reference's placement through XLA shardings) is refused, in
    ``init_state``, ``apply_update`` and ``resolve_cell``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.parallel import runner

    p = _to_torch(_tiny_params())
    with pytest.raises(ValueError, match="requires offload_moments"):
        adamw.init_state(p, offload_moments=False, moments_dtype="fp8")
    state = adamw.init_state(p, offload_moments=True, moments_dtype="fp8")
    with pytest.raises(ValueError, match="'xla'"):
        adamw.apply_update(p, p, state, lr=1e-3, offload_moments=True, moments_mode="xla",
                           moments_dtype="fp8")
    cfg = get_config("qwen2-7b").reduced()
    shape = ShapeConfig("t", 256, 2, "train")
    with pytest.raises(ValueError, match="'xla'"):
        runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, offload_moments=True,
                                                       moments_mode="xla"))
    # the plan's own validation (an assert, as the reference's) or resolve_cell
    with pytest.raises((AssertionError, ValueError), match="requires offload_moments"):
        runner.resolve_cell(cfg, shape, overrides=dict(pp=1, dp=1, moments_dtype="int8"))
    with pytest.raises(ValueError, match="compressed residency"):
        runner.resolve_cell(cfg, ShapeConfig("d", 256, 2, "decode"),
                            overrides=dict(pp=1, dp=1, offload=False, offload_dtype="fp8"))


def test_host_moments_are_born_on_the_host_in_one_buffer():
    """Every offloaded moment is a view of one host buffer (CPU memory: on
    the CPU nothing is page-locked), zeros, fp32 or the codec's pair."""
    p = _to_torch(_stage_params())
    for codec in ("none", "fp8"):
        state = adamw.init_state(p, offload_moments=True, moments_dtype=codec)
        base = state.host.tensor
        lo, hi = base.data_ptr(), base.data_ptr() + base.numel()
        for t in tree.leaves([state.m, state.v]):
            assert t.device.type == "cpu" and lo <= t.data_ptr() < hi
            assert (t.data_ptr() - lo) % hostmem.ALIGN == 0
        payloads = tree.leaves([state.m, state.v])[::1 if codec == "none" else 2]
        assert all(not t.float().any() for t in payloads)
        if codec != "none":
            assert all((s == 1.0).all() for s in tree.leaves([state.m, state.v])[1::2])


# ---------------------------------------------------------------------------
# the train CLI's flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--offload-moments"],
    ["--offload-moments", "--moments-mode", "explicit", "--moments-dtype", "fp8"],
    ["--offload-moments", "--moments-dtype", "int8", "--offload-dtype", "int8"],
    ["--offload-dtype", "fp8"]])
def test_cli_moment_and_codec_flags_train_on_cpu(flags):
    hostmem.reset_counts()
    hist = train.main(["--reduced", "--steps", "8", "--seq", "512", "--batch", "4",
                       "--n-chunks", "4", "--device", "cpu", "--log-every", "4", *flags])
    losses = [r["loss"] for r in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.1
    c = hostmem.counts()
    assert (c["moment_d2h"] > 0) == ("--offload-moments" in flags)
    assert c["d2h_bytes"] == c["h2d_bytes"] > 0


def test_cli_refuses_xla_moments_mode():
    with pytest.raises(ValueError, match="'xla'"):
        train.main(["--reduced", "--steps", "1", "--device", "cpu", "--offload-moments",
                    "--moments-mode", "xla"])


def test_train_reports_host_moment_bytes():
    cfg = dataclasses.replace(get_config("qwen2-7b").reduced(), n_layers=1)
    out = train.train(cfg, steps=1, seq=256, batch=2, device="cpu",
                      overrides=dict(offload_moments=True, moments_dtype="int8"))
    shapes = [tuple(t.shape) for t in tree.leaves(
        {"stages": build_model(cfg).init_stage_params(torch.Generator(), device="meta"),
         "globals": build_model(cfg).init_globals(torch.Generator(), device="meta")})]
    assert out["host_moment_bytes"] == cm.moment_bytes_from_shapes(shapes, "float32", "int8")
