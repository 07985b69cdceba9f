"""The int8 walk microbenchmark's port (``tools/torch_int8_walk_microbench.py``)
against the Pallas tool (``tools/int8_walk_microbench.py``): each variant's
plain PyTorch version against the tool's kernel body, wrapped here in a
``pl.pallas_call(..., interpret=True)`` with the tool's block specs, at 64
rows x 2 tiles x 3 layers of 256 x 256, on the same numpy-seeded inputs.

Tolerances: ``int8raw`` is integers all the way: equal. ``int8s`` and
``int8`` take exact integer products and the same fp32 operations: 1e-5 of
the output's scale (XLA may contract ``acc * s + b`` into one fused
multiply-add, and one quantized activation may then flip by 1 in a later
layer: 1/127 of one term of a 256-term sum). ``bf16`` rounds activations to
bf16 between layers on both sides and sums in another order: 1e-2 of scale."""

import functools
import importlib.util
import os

import numpy as np
import pytest

pytest.importorskip("jax")

import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, TILES, LAYERS = 64, 2, 3


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    return _load("int8_walk_microbench"), _load("torch_int8_walk_microbench")


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(TILES * ROWS, 256)).astype(np.float32)
    ws = [(rng.normal(size=(256, 256)) * 0.06).astype(np.float32)
          for _ in range(LAYERS)]
    bs = [(rng.normal(size=256) * 0.05).astype(np.float32)
          for _ in range(LAYERS)]
    return x, ws, bs


def _jax_variant(jt, kind, x, ws, bs, carry):
    """The Pallas tool's kernel body of ``kind`` in interpret mode, with the
    tool's own argument preparation and block specs (its ``_run``)."""
    D = jt.D
    ws = [jnp.asarray(w) for w in ws]
    bs = [jnp.asarray(b)[None] for b in bs]
    const, row = (lambda t: (0, 0)), (lambda t: (t, 0))
    specs = ([pl.BlockSpec((ROWS, D), row)]
             + [pl.BlockSpec((D, D), const)] * LAYERS
             + [pl.BlockSpec((1, D), const)] * LAYERS)
    if kind == "bf16":
        args = [w.astype(jnp.bfloat16) for w in ws] + bs
        body = jt._bf16_kernel
    else:
        scales = [jnp.max(jnp.abs(w), axis=0, keepdims=True) / 127.0
                  for w in ws]
        wq = [jnp.clip(jnp.round(w / s), -127, 127).astype(jnp.int8)
              for w, s in zip(ws, scales)]
        args = wq + scales + bs
        body = {"int8": jt._int8_kernel, "int8s": jt._int8s_kernel,
                "int8raw": jt._int8raw_kernel}[kind]
        specs = specs + [pl.BlockSpec((1, D), const)] * LAYERS
    out = pl.pallas_call(
        functools.partial(body, layers=LAYERS), grid=(TILES,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] + specs,
        out_specs=pl.BlockSpec((ROWS, D), row),
        out_shape=jax.ShapeDtypeStruct((TILES * ROWS, D), jnp.float32),
        interpret=True,
    )(jnp.full((1, 1), carry, jnp.float32), jnp.asarray(x), *args)
    return np.asarray(out)


@pytest.mark.parametrize("kind,tol", [("bf16", 1e-2), ("int8", 1e-5),
                                      ("int8s", 1e-5), ("int8raw", 0.0)])
def test_plain_variant_matches_pallas_body(tools, inputs, kind, tol):
    jt, tt = tools
    x, ws, bs = inputs
    # int8raw truncates its input to int8: give it a range worth truncating
    scale = 40.0 if kind == "int8raw" else 1.0
    want = _jax_variant(jt, kind, x * scale, ws, bs, 0.25)
    calls = tt.walk_bench_plain.calls
    got = tt.int8_walk_bench(kind, torch.as_tensor(x * scale),
                             [torch.as_tensor(w) for w in ws],
                             [torch.as_tensor(b) for b in bs], 0.25)
    assert tt.walk_bench_plain.calls == calls + 1        # CPU: plain version
    got = got.numpy()
    assert got.shape == want.shape == (TILES * ROWS, 256)
    assert np.abs(want).max() > 0 and np.ptp(want) > 0
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (kind, err)


def test_weight_quantization_matches_the_tool(tools, inputs):
    """Per-output-channel int8 weights: equal integers, scales to 1e-7."""
    _, tt = tools
    _, ws, _ = inputs
    wq, scales = tt.quantize_weights([torch.as_tensor(w) for w in ws])
    for w, q, s in zip(ws, wq, scales):
        js = np.abs(w).max(axis=0, keepdims=True) / np.float32(127.0)
        np.testing.assert_allclose(s.numpy(), js[0], rtol=1e-7)
        np.testing.assert_array_equal(
            q.numpy(), np.clip(np.round(w / js), -127, 127).astype(np.int8))
        assert q.dtype == torch.int8 and int(q.abs().max()) == 127


def test_kinds_differ_and_wrapper_checks_its_arguments(tools, inputs):
    """The four variants are four functions; an unknown kind raises; the
    timing entry point refuses the CPU (its numbers are the card's)."""
    _, tt = tools
    x, ws, bs = inputs
    t = lambda a: torch.as_tensor(a)
    outs = {k: tt.int8_walk_bench(k, t(x), [t(w) for w in ws],
                                  [t(b) for b in bs]) for k in tt.KINDS}
    for a in tt.KINDS:
        assert torch.isfinite(outs[a]).all()
        for b in tt.KINDS:
            if a < b:
                assert not torch.equal(outs[a], outs[b]), (a, b)
    # the two real quantized walks against bf16: inside int8's distance
    # (5 % of scale)
    ref = outs["bf16"]
    for k in ("int8", "int8s"):
        assert float((outs[k] - ref).abs().max()) <= 0.05 * float(ref.abs().max())
    with pytest.raises(ValueError, match="kind"):
        tt.int8_walk_bench("fp8", t(x), ws, bs)
    with pytest.raises(SystemExit):
        tt.run(device="cpu")
    assert tt.int8_walk_bench.launches == 0
