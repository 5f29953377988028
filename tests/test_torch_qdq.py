"""Port parity of the fused fake quantization (kernels #1 ``qdq_row`` and
#2 ``qdq_scaled``, ``kernels/ops.fused_fake_quant``), the same numpy inputs
through the JAX package and ``repro_torch`` on the CPU, where the wrappers
run their plain versions.

* Plain #1/#2 against ``repro.kernels.ref.qdq_row_ref`` /
  ``qdq_scaled_ref`` run eagerly (``jax.disable_jit()``): bit for bit, with
  exact x.5 ties and all-zero rows planted.
* ``fused_fake_quant`` against the eager JAX oracle -- ``qdq_row_ref`` for
  per-token specs, ``repro.kernels.ops.fused_fake_quant(interpret=True)``
  under ``disable_jit`` for per-channel and per-tensor ones: bit for bit.
  (The Pallas per-token kernel, even eager in interpret mode, divides its
  scale by qmax with another rounding: its values sit an ulp of the scale
  off its own reference.)
* ``fused_fake_quant`` against the jitted interpret-mode JAX composite:
  XLA's compiled division moves scales by an ulp and so, rarely, a payload
  by one step (an exact x.5 tie that rounds the other way).  Limits from
  readings on this tree (rows {1, 7, 300} x F {5, 768, 3072} x bits {4,
  8}): every element within one payload step of the JAX value, plus at the
  bf16 carrier half a bf16 ulp of each side (readings: at most 1.0 step at
  float32, 1.02 at bfloat16), and at float32 a payload step apart on at
  most 1e-5 of the elements (readings 1.1e-6 per token, 4.3e-6 per
  channel, 0 per tensor).
* The eligibility rule equals JAX's on the same specs.
* A fake-quant Fig-1 linear with ``g8t``, ``g8n``, ``g8c`` and ``gx8t``
  against JAX's ``quantized_linear`` VJP with ``REPRO_FUSED_FQ=1`` (the
  Pallas route): within 1e-5 of the largest magnitude (float32 matmuls sum
  in another order, and the jitted kernel's ulp-of-scale moves values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.qconfig import parse_recipe as jparse_recipe
from repro.core.qconfig import parse_spec as jparse_spec
from repro.core.qlinear import quantized_linear as j_qlinear
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core.qconfig import Granularity, parse_recipe, parse_spec
from repro_torch.core.qlinear import _train_fake_quant, quantized_linear
from repro_torch.core.quantizer import fake_quant_nograd
from repro_torch.kernels import qdq_row, qdq_scaled
from repro_torch.kernels.ops import (fused_fake_quant,
                                     fused_fake_quant_eligible)
from repro_torch.kernels.qdq import qdq_row_plain, qdq_scaled_plain

ROWS, FEATS, BITS = (1, 7, 300), (5, 768, 3072), (4, 8)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def planted(rows, f, bits, seed):
    """float32 (rows, f) values with row 0 at absmax qmax (a per-row scale
    of exactly 1) holding exact x.5 ties of both signs, and row 1 all zero
    (when there is one)."""
    qmax = 2 ** (bits - 1) - 1
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, f) * 0.02).astype(np.float32)
    ties = [qmax, 0.5, 1.5, 2.5, -2.5, -0.5, -3.5, 4.5]
    x[0, :min(f, 8)] = ties[:min(f, 8)]
    if rows > 1:
        x[1] = 0.0
    return x


def pair(x, dtype):
    tdt, jdt = DTYPES[dtype]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def as_f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("rows,f", [(r, f) for r in ROWS for f in FEATS])
def test_plain_qdq_row_bit_exact(rows, f, bits, dtype):
    xt, xj = pair(planted(rows, f, bits, seed=rows + f), dtype)
    with jax.disable_jit():
        want = as_f32(jref.qdq_row_ref(xj, bits))
    got = qdq_row(xt, bits)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), want)
    if rows > 1:
        assert not bool(got[1].any())          # the all-zero row stays zero


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("rows,f", [(7, 5), (300, 768), (1, 3072)])
def test_plain_qdq_scaled_bit_exact(rows, f, bits, per_channel, dtype):
    xt, xj = pair(planted(rows, f, bits, seed=rows * f), dtype)
    rng = np.random.RandomState(f)
    scale = rng.uniform(1e-4, 2e-3, (1, f if per_channel else 1)
                        ).astype(np.float32)
    scale[0, 0] = 1.0                            # the planted ties
    with jax.disable_jit():
        want = as_f32(jref.qdq_scaled_ref(xj, jnp.asarray(scale), bits))
    got = qdq_scaled(xt, torch.from_numpy(scale), bits)
    np.testing.assert_array_equal(got.float().numpy(), want)


GRANS = {"t": Granularity.PER_TOKEN, "c": Granularity.PER_CHANNEL,
         "n": Granularity.PER_TENSOR}


def _eager_oracle(xj, spec_text):
    jspec = jparse_spec(spec_text)
    with jax.disable_jit():
        if spec_text.endswith("t"):
            return as_f32(jref.qdq_row_ref(xj, jspec.bits))
        return as_f32(jops.fused_fake_quant(xj, jspec, interpret=True))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("gran", list(GRANS))
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("rows,f", [(7, 5), (300, 768), (1, 3072),
                                    (300, 3072)])
def test_fused_fake_quant_matches_eager_oracle(rows, f, bits, gran, dtype):
    spec_text = f"{bits}{gran}"
    xt, xj = pair(planted(rows, f, bits, seed=rows + 3 * f), dtype)
    got = fused_fake_quant(xt, parse_spec(spec_text))
    np.testing.assert_array_equal(got.float().numpy(),
                                  _eager_oracle(xj, spec_text))
    # and the same values as the port's own fake_quant_nograd
    assert torch.equal(got, fake_quant_nograd(xt, parse_spec(spec_text)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("gran", list(GRANS))
@pytest.mark.parametrize("bits", BITS)
def test_fused_fake_quant_near_jitted_interpret_kernel(bits, gran, dtype):
    """Readings and limits in the module docstring."""
    qmax = 2 ** (bits - 1) - 1
    axes = {"t": (1,), "c": (0,), "n": (0, 1)}[gran]
    flips = total = 0
    for rows in ROWS:
        for f in FEATS:
            x = planted(rows, f, bits, seed=rows * 7 + f)
            xt, xj = pair(x, dtype)
            jspec = jparse_spec(f"{bits}{gran}")
            want = as_f32(jops.fused_fake_quant(xj, jspec, interpret=True))
            got = fused_fake_quant(xt, parse_spec(f"{bits}{gran}"))
            got = got.float().numpy()
            xf = xt.float().numpy()
            s = np.maximum(np.abs(xf).max(axis=axes, keepdims=True),
                           1e-12) / qmax
            d = np.abs(got - want)
            tol = s * (1 + 1e-6)
            if dtype == "bfloat16":
                # each side rounds q * s to bf16: half an ulp, 2**-8 of it
                tol = tol + (np.abs(want) + np.abs(got)) * 2.0 ** -8
            assert (d <= tol).all(), (rows, f, float((d / s).max()))
            flips += int((d > 0.5 * s).sum())
            total += d.size
    if dtype == "float32":
        assert flips <= 1e-5 * total, flips / total


SPECS = ["8t", "8c", "8n", "4t", "4c", "8c-b128", "8t-asym", "8c-sqrt",
         "8t-sr", "16t", "8c-asym-b128-sqrt", "2n"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_eligibility_equals_jax(spec, ndim):
    shape = (2, 3, 4)[-ndim:]
    got = fused_fake_quant_eligible(parse_spec(spec), torch.zeros(shape))
    want = jops.fused_fake_quant_eligible(jparse_spec(spec),
                                          jnp.zeros(shape))
    assert got == want
    assert fused_fake_quant_eligible(None, torch.zeros(shape)) is False


def test_train_fake_quant_routes_by_eligibility(monkeypatch):
    """Eligible specs go through the fused path, the rest through
    fake_quant_nograd (the reference's routing, with the device deciding
    which version of the kernels runs)."""
    calls = []
    import repro_torch.core.qlinear as ql
    real = ql.fused_fake_quant
    monkeypatch.setattr(ql, "fused_fake_quant",
                        lambda x, s: calls.append(s) or real(x, s))
    x = torch.randn(4, 6)
    _train_fake_quant(x, parse_spec("8t"))
    _train_fake_quant(x, parse_spec("8c-b128"))
    _train_fake_quant(x[0], parse_spec("8t"))
    assert calls == [parse_spec("8t")]


FIG1 = ["w8c,a8t,g8t", "w8c,a8t,g8n", "w8c,a8t,g8c", "w8c,a8t,g8t,gx8t"]


@pytest.mark.parametrize("recipe", FIG1)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_fake_quant_linear_matches_jax_fused_route(recipe, dtype,
                                                   monkeypatch):
    monkeypatch.setenv("REPRO_FUSED_FQ", "1")
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(5)
    x = rng.randn(2, 33, 96).astype(np.float32)
    w = (rng.randn(96, 80) * 0.1).astype(np.float32)
    g = (rng.randn(2, 33, 80) * 0.01).astype(np.float32)
    jrec, trec = jparse_recipe(recipe), parse_recipe(recipe)
    y_j, vjp = jax.vjp(lambda a, b: j_qlinear(a, b, jrec),
                       jnp.asarray(x, jdt), jnp.asarray(w, jdt))
    dx_j, dw_j = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    wt = torch.from_numpy(w).to(tdt).requires_grad_(True)
    y_t = quantized_linear(xt, wt, trec)
    y_t.backward(torch.from_numpy(g).to(tdt))
    # bf16 carrier: the matmuls round their outputs to bf16 in both
    # packages, a step of 2**-8 relative
    lim = 1e-5 if dtype == "float32" else 2.0 ** -7
    for t, j in ((y_t, y_j), (xt.grad, dx_j), (wt.grad, dw_j)):
        a = t.detach().float().numpy().astype(np.float64)
        b = as_f32(j).astype(np.float64)
        assert np.abs(a - b).max() <= lim * np.abs(b).max(), recipe
