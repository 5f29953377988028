"""Port parity: the integer codec, the policy string codec and prepared
weights of ``repro_torch`` against the JAX package, on the same numpy
inputs.  Payloads and scales of the nearest-rounding codec must match bit
for bit (both frameworks round half to even)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import qpolicy as jpol
from repro.core.qconfig import (Granularity as JGran, QuantSpec as JSpec,
                                parse_recipe as jparse_recipe)
from repro.core.qlinear import (int8_backend_supported as j_int8_ok,
                                int8_decode_attn_supported as j_kv_ok)
from repro.core.quantizer import (dequantize_int as jdequant,
                                  fake_quant_nograd as jfq,
                                  quantize_int as jquant)
from repro.infer.prepare import prepare_params as jprepare
from repro.models import build_model as jbuild

from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core import qpolicy as tpol
from repro_torch.core.qadam import QState
from repro_torch.core.qconfig import (Granularity, QuantSpec,
                                      parse_recipe)
from repro_torch.core.quantizer import (dequantize_int, fake_quant_nograd,
                                        quantize_int)
from repro_torch.infer.prepare import params_nbytes, prepare_params
from repro_torch.models import params_from_jax

GRANS = ["per_token", "per_channel", "per_tensor"]


def _inputs(seed, shape=(6, 40)):
    """Random values plus exact half-step points, where half-to-even
    rounding is what decides the payload."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) * 3).astype(np.float32)
    x.reshape(-1)[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 127.0, -127.0]
    return x


@pytest.mark.parametrize("gran", GRANS)
@pytest.mark.parametrize("symmetric", [True, False])
def test_quantize_int_bit_exact(gran, symmetric):
    x = _inputs(0)
    jq, js, jz = jquant(jnp.asarray(x), JSpec(8, JGran(gran),
                                              symmetric=symmetric))
    tq, ts, tz = quantize_int(torch.from_numpy(x),
                              QuantSpec(8, Granularity(gran),
                                        symmetric=symmetric))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(
        dequantize_int(tq, ts, tz).numpy(),
        np.asarray(jdequant(jq, js, jz, JSpec(8, JGran(gran),
                                              symmetric=symmetric))))


@pytest.mark.parametrize("gran", GRANS)
def test_fake_quant_bit_exact(gran):
    x = _inputs(1, (3, 5, 16))
    j = jfq(jnp.asarray(x), JSpec(8, JGran(gran)))
    t = fake_quant_nograd(torch.from_numpy(x), QuantSpec(8, Granularity(gran)))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


POLICIES = [
    "kv_cache=a8t,*=w8c+a8t@int8_pallas",
    "kv_cache=a8t,*=w8c",
    "*=w8c+a8t",
    "block[0:2].*=fp,*=w8c+a8t@int8_pallas",
    "embed=w8c,mlp_down=w8n+a8n,*=paper",
    "kv_cache=a8n,*=fp",
    "*=fp",
]
ROLE_SITES = [(r, l) for r in ("embed", "lm_head", "attn_qkv", "attn_out",
                               "mlp_up", "mlp_down", "kv_cache")
              for l in (None, 0, 1, 3)]


def _backend(name):
    return tpol.BACKEND_ALIASES.get(name, name)


@pytest.mark.parametrize("text", POLICIES)
def test_policy_strings_parse_the_same(text):
    jp, tp = jpol.parse_policy(text), tpol.parse_policy(text)
    assert tp.describe() == jp.describe().replace("int8_pallas", "int8_cuda")
    for role, layer in ROLE_SITES:
        jr, tr = jp.resolve(role, layer, 4), tp.resolve(role, layer, 4)
        jd = None if jr.recipe is None else jr.recipe.describe_compact()
        td = None if tr.recipe is None else tr.recipe.describe_compact()
        assert (td, tr.backend) == (jd, _backend(jr.backend)), (role, layer)
        assert tpol.int8_backend_supported(tr.recipe) == j_int8_ok(jr.recipe)
    jk, tk = jp.kv_spec(), tp.kv_spec()
    assert (None if tk is None else tk.describe()) == \
        (None if jk is None else jk.describe())
    if jk is not None:
        assert tpol.int8_decode_attn_supported(tk) == j_kv_ok(jk)
    jb, jcaps = jp.decode_attn_backend()
    tb, tcaps = tp.decode_attn_backend()
    assert (tb, tcaps) == (_backend(jb), jcaps)


@pytest.mark.parametrize("text", ["w8c,a8t", "w8c,a8t,g8t,m1:4c",
                                  "w4n-asym,a8t-sr", "fp", "w8c,emb"])
def test_recipe_codec_round_trips_the_same(text):
    j, t = jparse_recipe(text), parse_recipe(text)
    assert t.describe_compact() == j.describe_compact()
    assert t.describe() == j.describe()
    assert parse_recipe(t.describe_compact()) == t


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown kernel backend"):
        tpol.parse_policy("*=w8c@int8_tpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["kv_cache=a8t,*=w8c+a8t@int8_pallas",
                                    "block[0:2].*=fp,*=w8n+a8t"])
def test_prepare_params_bit_exact(dtype, policy):
    """Prepared payloads and fp32 scales equal the JAX package's, leaf for
    leaf: the carrier-cast weight is quantized, per-channel scales reduce
    over the input axis, and depth-banded roles stay raw in both."""
    jcfg = dataclasses.replace(get_smoke_config("gpt2-small"), dtype=dtype)
    tcfg = dataclasses.replace(tsmoke("gpt2-small"), dtype=dtype)
    jparams = jbuild(jcfg).init_params(jax.random.PRNGKey(3))
    jprep = jprepare(jcfg, jparams, policy)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    tprep = prepare_params(tcfg, tparams, policy)
    n_q = 0
    for mod in ("attn", "mlp"):
        for name, jleaf in jprep["blocks"][mod].items():
            tleaf = tprep["blocks"][mod][name]
            assert isinstance(tleaf, QState) == isinstance(jleaf, jpol.QState)
            if isinstance(tleaf, QState):
                n_q += 1
                np.testing.assert_array_equal(tleaf.q.numpy(),
                                              np.asarray(jleaf.q))
                np.testing.assert_array_equal(tleaf.scale.numpy(),
                                              np.asarray(jleaf.scale))
                assert tleaf.scale.dtype == torch.float32
    assert n_q == (6 if "w8c" in policy else 0)
    assert params_nbytes(tprep) < params_nbytes(tparams) or n_q == 0
