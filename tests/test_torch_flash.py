"""Port parity of the fp flash attention (#7-#10) and of the model's
``attention_impl="flash_pallas"`` path against the JAX package, on the
CPU: the port's wrappers run their plain versions there, the JAX kernels
run in Pallas interpret mode with blocks of 64 rows.

Tolerances: the forward within 2e-5 at float32 and 2e-2 at bfloat16 (the
reference's own, ``tests/test_flash_attn.py``), the LSE rows within 2e-5;
the gradients of ``flash_attention`` within 1e-4 of ``jax.grad`` of the
JAX custom VJP.  The two compute one function with fp32 sums in another
order.  At bfloat16, with the JAX kernel's key blocks as wide as the
port's tiles (64 rows at d = 64), the output and the gradients also lie
within ``chip_smoke.FLASH_BF16`` of JAX's, and a control that moves one
rounding of p lies outside it.  GPT-2 mini at the float32 carrier, true fan-in weights
(``test_torch_train_step.true_fan_in``): ``*=fp`` train loss within 1e-5
and gradients within 1e-4 relative L2, fp-KV prefill logits within 1e-5;
the paper recipe's train steps within ``QUANT_LINEARS``, the limits of the
port's train-step parity under the reference's attention.
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.kernels import flash_attn as jfa
from repro.models import build_model as jbuild
from repro.models.attention import _flash_path_ok

from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.kernels import flash_attn as fa
from repro_torch.models import build_model, params_from_jax
from repro_torch.models.common import tree_flatten, tree_unflatten

from test_torch_train_step import (QUANT_LINEARS, assert_within, readings,
                                   rel_l2, true_fan_in)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (limits and helpers; imports no torch)

#: the sweep of tests/test_flash_attn.py: (bh, sq, skv, d, causal)
SWEEP = [(4, 128, 128, 64, True), (2, 256, 256, 32, True),
         (2, 128, 256, 64, True), (3, 64, 64, 128, False),
         (1, 100, 100, 64, True), (2, 192, 192, 64, True)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several pytest workers at once."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _qkv(bh, sq, skv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((bh, sq, d)).astype(np.float32),
            rng.standard_normal((bh, skv, d)).astype(np.float32),
            rng.standard_normal((bh, skv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same numpy arrays as JAX and torch tensors of ``dtype``."""
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("bh,sq,skv,d,causal", SWEEP)
def test_forward_matches_jax(bh, sq, skv, d, causal):
    """#7 against ``flash_attention_fwd`` and #8 (output and LSE rows)
    against ``_fwd_with_lse``, float32."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(bh, sq, skv, d), "float32")
    off = skv - sq if causal else 0
    want = jfa.flash_attention_fwd(jq, jk, jv, causal=causal, q_offset=off,
                                   block_q=64, block_k=64, interpret=True)
    got = fa.flash_attention_fwd(q, k, v, causal=causal, q_offset=off)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)
    jo, jlse = jfa._fwd_with_lse(jq, jk, jv, causal, off, 64, 64, True)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal, q_offset=off)
    assert torch.equal(o, got)
    np.testing.assert_allclose(_f32(o), _f32(jo), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)


def _within_bf16(got, want):
    """Whether ``chip_smoke.FLASH_BF16`` holds two bfloat16 tensors close."""
    rel, over = chip_smoke._bf16_distance(torch, got, want)
    lim = chip_smoke.FLASH_BF16
    return rel <= lim["rel_l2"] and over <= lim["over_ulp"], (rel, over)


def _outside_bf16(got, want):
    """Whether both of ``chip_smoke.FLASH_BF16``'s distances exceed their
    limits."""
    rel, over = chip_smoke._bf16_distance(torch, got, want)
    lim = chip_smoke.FLASH_BF16
    return rel > lim["rel_l2"] and over > lim["over_ulp"], (rel, over)


@pytest.mark.parametrize("causal", [True, False])
def test_forward_bf16_matches_jax(causal):
    """At the bfloat16 carrier p is rounded to bf16 before the P.V product
    in both, against the running max of 64-key tiles; within 2e-2 and
    within ``FLASH_BF16``.  The plain forward with p left unrounded, and
    with p rounded against the row's final max, lie outside it."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 128, 128, 64, seed=1),
                                    "bfloat16")
    jo, jlse = jfa._fwd_with_lse(jq, jk, jv, causal, 0, 64, 64, True)
    o, lse = fa.flash_attention_fwd_lse(q, k, v, causal=causal)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(o), _f32(jo), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                               atol=2e-5)
    jo = torch.tensor(_f32(jo)).bfloat16()
    ok, dist = _within_bf16(o, jo)
    assert ok, dist
    unrounded = fa.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                             causal=causal).bfloat16()
    whole_row = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                             block_k=128)
    for ctrl in (unrounded, whole_row):
        ok, dist = _outside_bf16(ctrl, jo)
        assert ok, dist


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_bf16_match_jax(causal):
    """At the bfloat16 carrier the backward keeps p in fp32 in both: dq, dk
    and dv within ``FLASH_BF16`` of ``jax.grad``; dv from p rounded to bf16
    lies outside it."""
    arrays = _qkv(2, 128, 128, 64, seed=4)
    w = np.random.RandomState(5).standard_normal((2, 128, 64)).astype(
        np.float32)
    (jq, jk, jv), (q, k, v) = _both(arrays, "bfloat16")

    def loss(a, b, c):
        o = jfa.flash_attention(a, b, c, causal, 0, 64, 64, True)
        return jnp.sum(o.astype(jnp.float32) * w)
    want = [torch.tensor(_f32(g)).bfloat16()
            for g in jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)]
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*leaves, causal, 0)
    got = torch.autograd.grad((o.float() * torch.from_numpy(w)).sum(), leaves)
    for name, g, j in zip("qkv", got, want):
        ok, dist = _within_bf16(g, j)
        assert ok, (f"d{name}", dist)
    do = torch.from_numpy(w).bfloat16()
    o, lse = fa.flash_attention_fwd_lse(q.detach(), k.detach(), v.detach(),
                                        causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    p, _ = fa._bwd_plain(q.detach(), k.detach(), v.detach(), do, lse, delta,
                         causal, 0)
    dv = torch.einsum("bqk,bqd->bkd", p.bfloat16().float(),
                      do.float()).bfloat16()
    ok, dist = _outside_bf16(dv, want[2])
    assert ok, dist


@pytest.mark.parametrize("bh,sq,skv,d,causal", [
    (2, 64, 64, 32, True), (2, 64, 64, 32, False), (2, 96, 128, 64, True)])
def test_gradients_match_jax(bh, sq, skv, d, causal):
    """``flash_attention``'s backward (#9/#10, plain on the CPU) against
    ``jax.grad`` of the JAX custom VJP, for sum(o * w)."""
    arrays = _qkv(bh, sq, skv, d, seed=2)
    w = np.random.RandomState(3).standard_normal((bh, sq, d)).astype(
        np.float32)
    off = skv - sq if causal else 0
    (jq, jk, jv), (q, k, v) = _both(arrays, "float32")

    def loss(a, b, c):
        return jnp.sum(jfa.flash_attention(a, b, c, causal, off, 64, 64, True)
                       * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    o = fa.flash_attention(*leaves, causal, off)
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), leaves)
    for name, g, j in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4, err_msg=f"d{name}")


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(1, 8, 24)
    with pytest.raises(ValueError, match="multiples of 16 from 16 to 256"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 272)
    with pytest.raises(ValueError, match="to 256"):
        fa.flash_attention_fwd_lse(q, q, q)
    q = torch.zeros(1, 8, 32, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention_fwd(q, q, q)
    q = torch.zeros(1, 8, 32)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_fwd(q, torch.zeros(1, 32, 8).transpose(1, 2), q)


BF16_MAX = float(torch.finfo(torch.bfloat16).max)


@pytest.mark.parametrize("d", range(16, 257, 16))
def test_bf16_q_terms_sum_to_the_scaled_q(d):
    """The bf16 forward feeds the tensor cores x = fl(q * scale) as one
    bf16 term (power-of-two scale) or three (``bf16_q_terms``, the kernel's
    formula), so that every score product stays exact in fp32.  Each term
    is a bf16 value, and they sum to x exactly in fp32 over numpy-seeded q
    spread over bf16's exponents, +-max bf16 and the values next to the
    subnormals included; below 2**-126 (one term) or 2**-110 (three) they
    miss x by at most half of bf16's subnormal step, 2**-134.  An inf
    stays an inf."""
    rng = np.random.RandomState(d)
    spread = (rng.standard_normal(4096)
              * np.exp2(rng.randint(-133, 127, 4096))).astype(np.float32)
    tiny = np.float32(2.0 ** -126)
    special = np.array([BF16_MAX, -BF16_MAX, tiny, -tiny, tiny * 1.0078125,
                        tiny * 0.9921875, -tiny * 0.5, 2.0 ** -133, 0.0,
                        2.0 ** -105, -(2.0 ** -104) * 1.5, 1.0, -3.0],
                       dtype=np.float32)
    q = torch.from_numpy(np.concatenate([spread, special])).bfloat16()
    terms = fa.bf16_q_terms(q, d)
    x = q.float() * torch.tensor(1.0 / np.sqrt(d), dtype=torch.float32)
    assert len(terms) == (1 if d in (16, 64, 256) else 3)
    for t in terms:
        assert torch.equal(t, t.bfloat16().float())
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    exact = x.abs() >= (2.0 ** -126 if len(terms) == 1 else 2.0 ** -110)
    assert int(exact.sum()) > 3000
    assert torch.equal(total[exact], x[exact])
    assert float((total - x)[~exact].abs().max()) <= 2.0 ** -134
    inf = fa.bf16_q_terms(torch.tensor([float("inf")]).bfloat16(), d)
    assert inf[0].item() == float("inf")
    assert all(t.item() == 0.0 for t in inf[1:])


# ---------------------------------------------------------------------------
# GPT-2 mini under attention_impl="flash_pallas"
# ---------------------------------------------------------------------------

def _mini(impl="flash_pallas"):
    """(jax cfg, jax model, torch cfg, torch model, jax params, torch
    params) for gpt2-mini at float32, the JAX init at the true fan-in."""
    kw = dict(dtype="float32", attention_impl=impl)
    jcfg = dataclasses.replace(jsmoke("gpt2-small"), **kw)
    tcfg = dataclasses.replace(tsmoke("gpt2-small"), **kw)
    jmodel = jbuild(jcfg)
    jparams = true_fan_in(jmodel.init_params(jax.random.PRNGKey(0)),
                          jcfg.n_layers)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jmodel, tcfg, build_model(tcfg), jparams, tparams


def test_train_loss_and_grads_match_jax():
    """``*=fp``: the port's train loss and gradients with the flash path
    against the JAX model's with the same setting."""
    jcfg, jmodel, tcfg, tmodel, jparams, tparams = _mini()
    toks = np.random.RandomState(4).randint(0, jcfg.vocab_size, (2, 65))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, {"tokens": jnp.asarray(toks)},
                                    policy="*=fp"), has_aux=True)(jparams)
    leaves, struct = tree_flatten(tparams)
    leaves = [t.requires_grad_(True) for t in leaves]
    tl, _ = tmodel.train_loss(tree_unflatten(struct, leaves),
                              {"tokens": torch.from_numpy(toks)},
                              policy="*=fp")
    tg = torch.autograd.grad(tl, leaves)
    assert abs(tl.item() - float(jl)) <= 1e-5
    got = [g.numpy() for g in tg]
    want = tree_flatten(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jg), tcfg, device="cpu"))[0]
    assert rel_l2(got, [w.numpy() for w in want]) <= 1e-4


def test_paper_recipe_train_steps_match_jax():
    """Two train steps of the paper recipe with the flash path, the port's
    against the JAX package's, within the limits the quantized recipes
    meet under the reference's attention."""
    assert_within(readings("paper", "float32", attention_impl="flash_pallas"),
                  QUANT_LINEARS, "paper, flash_pallas")


def test_fp_cache_prefill_matches_jax():
    """An fp-KV prefill (no ``kv_cache`` role) under flash: a 2 x 20 prompt
    into a 32-row cache, logits within 1e-5 of JAX's."""
    jcfg, jmodel, _, tmodel, jparams, tparams = _mini()
    toks = np.random.RandomState(5).randint(0, jcfg.vocab_size, (2, 20))
    jl, _ = jmodel.prefill(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                           policy="*=fp", max_seq=32)
    tl, st = tmodel.prefill(tparams, torch.from_numpy(toks), policy="*=fp",
                            max_seq=32)
    real = slice(0, jcfg.vocab_size)
    assert np.abs(tl.numpy()[:, real] - np.asarray(jl)[:, real]).max() <= 1e-5
    assert st["caches"]["k"].dtype == torch.float32


class _Recorder:
    """Counts the calls of the plain flash versions (the CPU's kernels)."""

    def __init__(self, monkeypatch):
        self.calls = {}
        for name in ("flash_attention_fwd_lse_plain",
                     "flash_attention_bwd_dkdv_plain",
                     "flash_attention_bwd_dq_plain"):
            fn = getattr(fa, name)
            monkeypatch.setattr(fa, name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def call(*a, **kw):
            self.calls[name] = self.calls.get(name, 0) + 1
            return fn(*a, **kw)
        return call

    def take(self):
        out, self.calls = self.calls, {}
        return out


@pytest.mark.parametrize("impl", ["flash_pallas", "xla"])
def test_flash_branch_taken_where_the_reference_takes_it(impl, monkeypatch):
    """Training and the unpacked fp-cache prefill run the flash kernels
    (one forward per layer; in the backward one #9 and one #10 per layer,
    and the forward again, which the layer's recomputation runs under the
    config's default ``remat``); decode steps, int8 caches and packed
    prefills never do -- the reference's ``_flash_path_ok`` decides the
    same for each."""
    assert _flash_path_ok("flash_pallas", 64, {"kind": "causal"})
    assert not _flash_path_ok("flash_pallas", 1, {"kind": "causal"})
    assert not _flash_path_ok("flash_pallas", 64, jnp.ones((1, 64, 64), bool))
    assert not _flash_path_ok("xla", 64, {"kind": "causal"})
    _, _, tcfg, tmodel, _, tparams = _mini(impl)
    n = tcfg.n_layers if impl == "flash_pallas" else 0
    rec = _Recorder(monkeypatch)
    toks = torch.from_numpy(np.random.RandomState(6).randint(
        0, tcfg.vocab_size, (2, 17)))
    leaves, struct = tree_flatten(tparams)
    leaves = [t.requires_grad_(True) for t in leaves]
    loss, _ = tmodel.train_loss(tree_unflatten(struct, leaves),
                                {"tokens": toks}, policy="*=fp")
    assert rec.take() == ({"flash_attention_fwd_lse_plain": n} if n else {})
    torch.autograd.grad(loss, leaves)
    assert tcfg.remat
    assert rec.take() == ({"flash_attention_fwd_lse_plain": n,
                           "flash_attention_bwd_dkdv_plain": n,
                           "flash_attention_bwd_dq_plain": n} if n else {})
    # fp cache: the unpacked prefill takes the flash forward, decode not
    _, st = tmodel.prefill(tparams, toks[:, :8], policy="*=fp", max_seq=16)
    assert rec.take() == ({"flash_attention_fwd_lse_plain": n} if n else {})
    tmodel.decode(tparams, st, toks[:, 8:9],
                  torch.full((2,), 8, dtype=torch.int32), policy="*=fp")
    assert rec.take() == {}
    # a packed prefill (segment mask) and an int8 cache keep their paths
    segs = torch.tensor([[0] * 4 + [1] * 4, [0] * 8])
    tmodel.prefill(tparams, toks[:, :8], policy="*=fp", max_seq=16,
                   segments=segs,
                   last_pos=torch.tensor([[0, 3], [0, 7], [1, 7]]))
    tmodel.prefill(tparams, toks[:, :8], policy="kv_cache=a8t,*=w8c",
                   max_seq=16)
    assert rec.take() == {}
