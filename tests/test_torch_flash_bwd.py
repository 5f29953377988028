"""The flash backward's pieces on the CPU: the exact three-term bfloat16
split that the tensor-core backward (``csrc/flash_bwd_sm90.cuh``) feeds its
wgmma with, the plain backward whose products are summed in float64 (the
function phase 13 of ``chip_smoke.py`` holds the kernels to) against
``jax.grad`` of the JAX custom VJP in Pallas interpret mode, and the
wrappers' fixed rule for which library a CUDA call launches.

Tolerances: the split bit for bit (its terms are bf16 values that sum to
x exactly while |x| >= 2**-110, at most 2**-134 off below, and each product
of a term with a bf16 value is exact in fp32); the plain backward within
1e-4 of ``jax.grad`` at float32 (``tests/test_torch_flash.py``'s) and
within ``chip_smoke.FLASH_BF16`` at bfloat16, except for dq's row 0 under
the causal mask, which is rounding noise in both (see
``test_plain_backward_meets_jax``).
"""
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jfa

from repro_torch.kernels import _build
from repro_torch.kernels import flash_attn as fa

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (limits and helpers; imports no torch)

TINY = 2.0 ** -110     # below it bf16's subnormal step drops bits
SUB_HALF = 2.0 ** -134  # half of bf16's subnormal step
BF16_MAX = float(torch.finfo(torch.bfloat16).max)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several pytest workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _values(kind: str, seed: int) -> torch.Tensor:
    """float32 values of the kind the backward splits: p = exp(s - lse) in
    [0, 1], ds of either sign spread over fp32's exponents up to 2**100,
    and the edges (0, -0, values next to 2**-110 and the subnormals, +-bf16's
    largest value, +-inf, NaN)."""
    rng = np.random.RandomState(seed)
    if kind == "p":
        x = np.exp(-np.abs(rng.standard_normal(4096)) * rng.choice(
            [1.0, 10.0, 80.0], 4096))
        x[:8] = [1.0, 0.0, 0.5, 1.0 - 2.0 ** -24, 2.0 ** -100, 2.0 ** -120,
                 1e-38, 1e-45]
    elif kind == "ds":
        x = rng.standard_normal(4096) * np.exp2(rng.randint(-140, 100, 4096))
    else:
        x = np.array([0.0, -0.0, TINY, -TINY, TINY * 1.5, -TINY * 0.75,
                      2.0 ** -126, 2.0 ** -149, -2.0 ** -140, BF16_MAX,
                      -BF16_MAX, 1.0, -1.0 / 3.0, np.inf, -np.inf, np.nan])
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


@pytest.mark.parametrize("kind,seed", [("p", 0), ("p", 1), ("ds", 2),
                                       ("ds", 3), ("edges", 4)])
def test_bf16_terms_sum_to_x(kind, seed):
    """hi, mid and lo are bf16 values; where |x| >= 2**-110 they sum to x
    exactly in fp32, below it they miss x by at most 2**-134; a non-finite
    x stays in hi with mid = lo = 0."""
    x = _values(kind, seed)
    terms = fa.bf16_terms(x)
    assert len(terms) == 3
    for t in terms:
        assert t.dtype == torch.float32
        torch.testing.assert_close(t, t.bfloat16().float(), rtol=0, atol=0,
                                   equal_nan=True)
    hi, mid, lo = terms
    finite = x.isfinite()
    assert torch.equal(hi[~finite].isnan(), x[~finite].isnan())
    assert torch.equal(hi[x.isinf()], x[x.isinf()])
    assert bool((mid[~finite] == 0).all()) and bool((lo[~finite] == 0).all())
    total = (hi + mid + lo)[finite]
    xf = x[finite]
    exact = xf.abs() >= TINY
    assert torch.equal(total[exact], xf[exact])
    if bool((~exact).any()):
        assert float((total - xf)[~exact].abs().max()) <= SUB_HALF
    if kind != "edges":
        assert int(exact.sum()) > 3000


def test_bf16_q_terms_is_bf16_terms_of_the_scaled_q():
    """The forward's split of q * scale is :func:`bf16_terms` where the
    scale is not a power of two."""
    q = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (64, 48)).astype(np.float32)).bfloat16()
    x = q.float() * torch.tensor(1.0 / math.sqrt(48), dtype=torch.float32)
    for a, b in zip(fa.bf16_q_terms(q, 48), fa.bf16_terms(x)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind,seed", [("p", 6), ("ds", 7)])
def test_term_products_are_exact(kind, seed):
    """Each product of a term with a bf16 value (dO, q or k) is exact in
    fp32 while it stays in fp32's normal range, and sum_terms sum_k term_k
    * d_k is p . d (or ds . d) exactly: both sums taken exactly
    (``math.fsum``) round to the same float64.  ds is drawn over 2**-90 to
    2**20 here, so that every product of its terms stays normal."""
    x = _values(kind, seed)[:64 * 64].reshape(64, 64)
    if kind == "ds":
        rng = np.random.RandomState(seed)
        x = torch.from_numpy((rng.standard_normal((64, 64)) * np.exp2(
            rng.randint(-90, 20, (64, 64)))).astype(np.float32))
    d = torch.from_numpy(np.random.RandomState(seed + 10).standard_normal(
        (64, 64)).astype(np.float32)).bfloat16().double()
    terms = [t.reshape(64, 64).double() for t in fa.bf16_terms(x)]
    for t in terms:
        prod = t * d
        assert torch.equal(prod.float().double(), prod)
    for row in range(64):
        split = math.fsum(float(v) for t in terms for v in t[row] * d[:, row])
        whole = math.fsum(float(v) for v in x[row].double() * d[:, row])
        assert split == whole, row


# ---------------------------------------------------------------------------
# the float64-summed plain backward against jax.grad
# ---------------------------------------------------------------------------

def _jax_grads(arrays, w, dtype, causal):
    """``jax.grad`` of the JAX flash attention, and the forward's (o, lse)
    that its backward reads (``_fa_fwd``'s residuals: ``_fwd_with_lse``
    with the same blocks)."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)

    def loss(a, b, c):
        o = jfa.flash_attention(a, b, c, causal, 0, 64, 64, True)
        return jnp.sum(o.astype(jnp.float32) * w)
    grads = [torch.from_numpy(np.asarray(g.astype(jnp.float32))).to(tdt)
             for g in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    o, lse = jfa._fwd_with_lse(jq, jk, jv, causal, 0, 64, 64, True)
    return grads, (torch.from_numpy(np.asarray(o.astype(jnp.float32))).to(tdt),
                   torch.from_numpy(np.asarray(lse)))


def _plain_grads(arrays, w, dtype, causal, sum_dtype, fwd):
    """The port's backward as ``_FlashAttention.backward`` runs it (delta
    = sum(g * o) in fp32, g the cotangent in the carrier) on the forward's
    ``fwd`` = (o, lse), through the plain versions with their products
    summed in ``sum_dtype``."""
    tdt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    o, lse = fwd
    g = torch.from_numpy(w).to(tdt)
    delta = (g.float() * o.float()).sum(-1)
    kw = dict(causal=causal, sum_dtype=sum_dtype)
    dk, dv = fa.flash_attention_bwd_dkdv_plain(q, k, v, g, lse, delta, **kw)
    dq = fa.flash_attention_bwd_dq_plain(q, k, v, g, lse, delta, **kw)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 128, 64), (1, 64, 64, 160),
                                   (1, 64, 64, 256), (1, 64, 16, 64)])
def test_plain_backward_meets_jax(dtype, causal, shape):
    """The plain backward with float64 sums (its default) against
    ``jax.grad`` of the JAX flash attention, both on the JAX forward's o and
    lse: within 1e-4 at float32, within ``FLASH_BF16`` at bfloat16; at hd
    64 and at the wide tensor-core backward's head dims 160 and 256 (one
    head of 64 rows), and at hd 64 with 64 query rows over 16 keys (the
    encoder-decoder's cross-attention: Sq > Skv).  (On each package's own forward the two o differ in
    a few bf16 elements -- the scores summed in float64 and in fp32 round
    p to bf16 apart now and then -- and delta = sum(g * o) carries that
    into dk: 2.1e-4 at hd 256 over 64 rows.)  Under the
    causal mask query row 0 sees key 0 alone, so o_0 = v_0 and dp_00 -
    delta_0 vanishes in exact arithmetic: dq's row 0 is the rounding noise
    of two sums of the same products in both packages (float64 sums make
    the port's exactly 0, JAX's fp32 ones leave up to a few ulp), so at
    bfloat16 it is held to that noise level instead, and the other rows to
    ``FLASH_BF16``."""
    bh, sq, skv, d = shape
    rng = np.random.RandomState(11)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((bh, sq, d), (bh, skv, d), (bh, skv, d))]
    w = np.random.RandomState(12).standard_normal((bh, sq, d)).astype(
        np.float32)
    want, fwd = _jax_grads(arrays, w, dtype, causal)
    got = _plain_grads(arrays, w, dtype, causal, torch.float64, fwd)
    if dtype == "float32":
        for name, g, j in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), j.numpy(), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
        return
    lim = chip_smoke.FLASH_BF16
    rows = slice(1, None) if causal else slice(None)
    for name, g, j in (("dq", got[0][:, rows], want[0][:, rows]),
                       ("dk", got[1], want[1]), ("dv", got[2], want[2])):
        rel, over = chip_smoke._bf16_distance(torch, g, j)
        assert rel <= lim["rel_l2"] and over <= lim["over_ulp"], \
            (name, rel, over)
    if causal:
        scale = float(want[0].float().abs().max())
        for t in (got[0], want[0]):
            assert float(t[:, 0].float().abs().max()) <= 1e-5 * scale


def test_cpu_wrappers_keep_fp32_sums():
    """On CPU tensors the wrappers run the plain backward with fp32 sums
    (``CPU_SUM_DTYPE``), the reference's own; the float64 default differs
    from it only by summation order."""
    gen = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn((2, 96, 32), generator=gen).bfloat16()
                   for _ in range(4))
    o, lse = fa.flash_attention_fwd_lse(q, k, v)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    f32 = dict(sum_dtype=torch.float32)
    assert fa.CPU_SUM_DTYPE == torch.float32
    assert torch.equal(fa.flash_attention_bwd_dq(*args),
                       fa.flash_attention_bwd_dq_plain(*args, **f32))
    for a, b in zip(fa.flash_attention_bwd_dkdv(*args),
                    fa.flash_attention_bwd_dkdv_plain(*args, **f32)):
        assert torch.equal(a, b)
    for a, b in zip(fa.flash_attention_bwd_dkdv_plain(*args),
                    fa.flash_attention_bwd_dkdv_plain(*args, **f32)):
        rel, _ = chip_smoke._bf16_distance(torch, a, b)
        assert rel <= chip_smoke.FLASH_BF16["rel_l2"]


# ---------------------------------------------------------------------------
# which library a CUDA call launches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", range(16, 257, 16))
def test_bwd_library_rule(dtype, d):
    """bfloat16 takes a tensor-core backward at every head dim the wrappers
    admit: ``flash_bwd_sm90`` up to 128, ``flash_bwd_sm90_wide`` at
    144-256; float32 the CUDA-core kernels."""
    if dtype == torch.float32:
        want = "flash_attn"
    else:
        want = "flash_bwd_sm90" if d <= 128 else "flash_bwd_sm90_wide"
    assert fa.bwd_library(dtype, d) == want
    assert fa.FLASH_BWD_SM90_NARROW_MAX_HEAD_DIM == 128
    assert fa.FLASH_BWD_SM90_MAX_HEAD_DIM == fa.FLASH_MAX_HEAD_DIM == 256


class _FakeLib:
    """Records the C entry point a launch calls and its arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, entry):
        return lambda *args: self.calls.append((entry, args)) or 0


@pytest.mark.parametrize("which", ["dkdv", "dq"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 112),
                                     (torch.bfloat16, 160),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 64)])
def test_launch_reaches_the_routed_library(which, dtype, d, monkeypatch):
    """``_launch_bwd`` loads the library ``bwd_library`` names and calls its
    entry point with the arguments ``_build.SIGNATURES`` declares: the
    tensor-core entries (``flash_bwd_sm90`` up to hd 128,
    ``flash_bwd_sm90_wide`` at 160 and 256) take no dtype code, the
    CUDA-core ones do."""
    libs = {}

    def load(name):
        return libs.setdefault(name, _FakeLib())
    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    q, k, v, do = (torch.zeros((2, 40, d), dtype=dtype) for _ in range(4))
    lse = delta = torch.zeros((2, 40))
    outs = (torch.zeros_like(k), torch.zeros_like(v)) if which == "dkdv" \
        else (torch.zeros_like(q),)
    fa._launch_bwd(which, q, k, v, do, lse, delta, outs, True, 0)
    name = fa.bwd_library(dtype, d)
    assert list(libs) == [name]
    (entry, args), = libs[name].calls
    prefix = {"flash_bwd_sm90": "repro_flash_bwd_sm90_",
              "flash_bwd_sm90_wide": "repro_flash_bwd_sm90_wide_",
              "flash_attn": "repro_flash_attn_bwd_"}[name]
    assert name == ("flash_attn" if dtype == torch.float32
                    else "flash_bwd_sm90" if d <= 128
                    else "flash_bwd_sm90_wide")
    assert entry == prefix + which
    assert len(args) == len(_build.SIGNATURES[name][entry])
    n_ptr = 6 + len(outs)
    assert list(args[n_ptr:n_ptr + 4]) == [2, 40, 40, d]
    assert args[n_ptr + 4] == pytest.approx(1.0 / math.sqrt(d))
    if name == "flash_attn":
        assert args[-2] == (1 if dtype == torch.bfloat16 else 0)


def test_the_library_is_declared():
    """``flash_bwd_sm90`` and ``flash_bwd_sm90_wide`` are libraries of their
    own, built from their sources with the others (both include
    ``flash_bwd_sm90.cuh``, which every library's cache key hashes): their
    entry points and the exported head-dim limits."""
    for name, limit in (("flash_bwd_sm90", "repro_flash_bwd_max_head_dim"),
                        ("flash_bwd_sm90_wide",
                         "repro_flash_bwd_sm90_wide_max_head_dim")):
        sig = _build.SIGNATURES[name]
        prefix = f"repro_{name}_"
        assert set(sig) == {prefix + "dkdv", prefix + "dq", limit}
        assert sig[limit] == []
        assert sig[prefix + "dkdv"] == \
            _build.SIGNATURES["flash_bwd_sm90"]["repro_flash_bwd_sm90_dkdv"]
        assert (_build.CSRC / f"{name}.cu").is_file()
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "flash_bwd_sm90.cuh"' in src
        for entry in sig:
            assert f'extern "C" int {entry}(' in src
    assert (_build.CSRC / "flash_bwd_sm90.cuh").is_file()
