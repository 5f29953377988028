"""Port parity of the serving model: the GPT-2 decoder's prefill and
decode against the JAX package's fused int8-KV path
(``REPRO_FUSED_DECODE=1``, Pallas in interpret mode), on the same
parameters carried across with ``params_from_jax``.

Oracle: the JAX fused path.  Its kernels keep dequantized K/V in fp32, as
the port's do; the JAX dequantize-on-read branch rounds them to the carrier
and is an oracle at float32 only (ROADMAP, the carrier-precision finding).

Tolerances.  float32 carrier: logits within 1e-3 (measured ~2e-7: fp32
sums in another order) and cache payloads within one int8 step.
bfloat16 carrier: XLA evaluates the bf16 tanh-GELU op by op in bf16 while
``F.gelu`` computes in fp32 and rounds once, so about a third of the GELU
outputs differ by one bf16 ulp; from layer 1 on the int8 activation and KV
codecs turn those into whole-step payload flips.  So at bf16 the layer-0
caches (before any GELU) must match bit for bit and the logits within 0.25
(0.08-0.09 with this test's inputs, on logits of magnitude ~0.9).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.infer.prepare import prepare_params as jprepare

from repro_torch.infer.prepare import prepare_params

from test_torch_engine import POLICY, pair

BF16_LOGIT_BOUND = 0.25


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_decode_match_jax_fused(dtype, monkeypatch):
    """W8A8 prepared weights + int8 KV on gpt2-mini: a 2 x 12 prompt into a
    16-row cache, then one decode step at per-slot (B,) positions."""
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair(dtype)
    jp = jprepare(jcfg, jparams, POLICY)
    tp = prepare_params(tcfg, tparams, POLICY)
    prompt = np.random.RandomState(1).randint(0, jcfg.vocab_size, (2, 12))
    jl, jst = jmodel.prefill(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                             policy=POLICY, max_seq=16)
    tl, tst = tmodel.prefill(tp, torch.from_numpy(prompt), policy=POLICY,
                             max_seq=16)
    toks, pos = [[5], [7]], np.asarray([12, 12], np.int32)
    jd, jst = jmodel.decode(jp, jst, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(pos), policy=POLICY)
    td, tst = tmodel.decode(tp, tst, torch.tensor(toks),
                            torch.from_numpy(pos), policy=POLICY)
    logits = [(jl, tl), (jd, td)]
    bound = 1e-3 if dtype == "float32" else BF16_LOGIT_BOUND
    for jl, tl in logits:
        real = slice(0, jcfg.vocab_size)
        d = np.abs(tl.numpy()[:, real] - np.asarray(jl)[:, real]).max()
        assert d <= bound, (dtype, d)
        assert np.isfinite(tl.numpy()[:, real]).all()
    for name in ("k", "v"):
        j = np.asarray(jst["caches"][name]).astype(np.int32)
        t = tst["caches"][name].numpy().astype(np.int32)
        if dtype == "float32":
            assert np.abs(t - j).max() <= 1, name
        else:
            np.testing.assert_array_equal(t[0], j[0])


def test_init_params_follow_the_reference():
    """``init_params`` draws every leaf with the JAX init's kind and scale,
    the reference's fan-in rule included (``shape[0]``, the layer dim of a
    stacked block weight): same tree and shapes, ones and zeros exact, and
    each random leaf's standard deviation within 5% of the JAX one's."""
    jcfg, jmodel, jparams, tcfg, tmodel, _ = pair("float32")
    tparams = tmodel.init_params(torch.Generator().manual_seed(0),
                                 device="cpu")

    def walk(j, t, path):
        assert set(j) == set(t), path
        for k in j:
            if isinstance(j[k], dict):
                walk(j[k], t[k], f"{path}.{k}")
                continue
            a, b = np.asarray(j[k]), t[k].numpy()
            assert a.shape == b.shape, (path, k)
            if a.std() == 0:
                np.testing.assert_array_equal(b, a)
            else:
                assert abs(b.std() / a.std() - 1) < 0.05, (path, k)
    walk(jparams, tparams, "")
