"""``moe_apply``'s gradients against ``jax.grad`` of the reference's, on
the smoke configs of both MoE models at the float32 carrier (layer 0's
leaves carried across with ``params_from_jax``; inputs and the output
cotangent from numpy with a seed; the JAX side's Pallas kernels in
interpret mode): the gradients of x, ``w_router``, ``w_gate``, ``w_up``
and ``w_down`` of sum(y * dy) + aux + z.

Tolerance: each gradient within 1e-5 relative to its largest entry, under
the fp policy and under W8A8G8 on the int8 route (the experts on the
expert-batched #3, #4 and #5, here their plain versions).  Readings on
this tree: 1.0e-7 to 9.1e-7 (the router's softmax and logsumexp, SiLU and
the fp32 router matmul round differently in XLA and PyTorch; the int8
payloads agree).  Also with capacity drops (a capacity factor of 1.0) and
through the chunked dispatch (``MAX_DISPATCH_TOKENS`` patched small in
both modules, no JAX file edited).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe

from repro_torch.models import moe
from test_torch_moe import ARCHS, _moe_inputs, layer0, pair

W8A8G8 = "*=w8c+a8t+g8t@int8_pallas"
POLICIES = {"fp": None, "w8a8g8": W8A8G8}
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def grads_pair(name, policy, b=2, s=12, **kw):
    """{leaf: (port gradient, JAX gradient)} of sum(y * dy) + aux + z, x
    included, for layer 0 of ``name``'s smoke config."""
    jcfg, jparams, tcfg, tparams = pair(name, **kw)
    jp, tp = layer0(jparams), layer0(tparams)
    x = _moe_inputs(tcfg, b, s, 5)
    dy = np.random.RandomState(9).randn(*x.shape).astype(np.float32)

    def jf(p, xx):
        y, aux, z = jmoe.moe_apply(p, xx, jcfg, policy=policy, layer=0,
                                   n_layers=jcfg.n_layers)
        return jnp.sum(y * dy) + aux + z
    jg_p, jg_x = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))
    tpp = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux, z = moe.moe_apply(tpp, tx, tcfg, policy=policy, layer=0,
                              n_layers=tcfg.n_layers)
    loss = (y * torch.from_numpy(dy)).sum() + aux + z
    got = torch.autograd.grad(loss, [tx, *tpp.values()])
    want = [jg_x] + [jg_p[k] for k in tpp]
    return {k: (g.numpy(), np.asarray(j))
            for k, g, j in zip(["x", *tpp], got, want)}


def assert_close(pairs):
    assert set(pairs) == {"x", "w_router", "w_gate", "w_up", "w_down"}
    for k, (got, want) in pairs.items():
        assert np.isfinite(got).all(), k
        scale = np.abs(want).max()
        assert scale > 0, k
        assert np.abs(got - want).max() <= TOL * scale, (
            k, np.abs(got - want).max() / scale)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_gradients_match_jax(name, policy):
    assert_close(grads_pair(name, POLICIES[policy]))


@pytest.mark.parametrize("name", ARCHS)
def test_moe_apply_gradients_with_drops_match_jax(name):
    """A capacity factor of 1.0 drops pairs: a dropped pair's token gets no
    gradient through that expert, in both packages."""
    _, _, tcfg, tparams = pair(name, capacity_factor=1.0)
    x = torch.from_numpy(_moe_inputs(tcfg, 2, 12, 5)).reshape(24, -1)
    top_e = moe._route(x, layer0(tparams)["w_router"], tcfg,
                       moe.as_policy(None), moe.LinearCtx("router", 0, 2))[1]
    keep = moe._dispatch_indices(top_e, tcfg.n_experts,
                                 moe._capacity(24, tcfg), tcfg.top_k)[1]
    assert not bool(keep.all())
    assert_close(grads_pair(name, W8A8G8, capacity_factor=1.0))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_moe_chunked_gradients_match_jax(monkeypatch, policy):
    """2 x 24 tokens in dispatch chunks of 16 (the bound 32 halved until
    it divides 48), each with its own capacity, in both packages."""
    monkeypatch.setattr(jmoe, "MAX_DISPATCH_TOKENS", 32)
    monkeypatch.setattr(moe, "MAX_DISPATCH_TOKENS", 32)
    assert moe.dispatch_chunk(48) == 16
    assert_close(grads_pair("granite-moe-3b-a800m", POLICIES[policy], s=24,
                            capacity_factor=1.0))
