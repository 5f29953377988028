"""The encoder-decoder family (seamless-m4t) served, against the JAX
package (its training: ``test_torch_encdec_train.py``), on the
seamless smoke config (2 encoder + 2 decoder layers, d_model 64, 4 heads of
16, vocab 512): parameters carried across from the JAX init
(``params_from_jax``) at the true fan-in scale (``chip_smoke.true_fan_in``,
each stack from its own depth), numpy inputs from a seed, the int8
kernels' plain versions here and Pallas in interpret mode on the JAX side,
float32 carrier.

* The config field for field, ``param_count()`` 877,031,424 at full size,
  and the parameter tree of the reference's ``encdec_spec``.
* ``encode`` under fp linears and under ``TRAIN_POLICY``'s linears
  (``*=w8c+a8t+g8t``, #3's plain version): within 1e-5 of the output's
  largest entry.
* ``encdec_prefill``'s logits within 1e-4 of their largest entry and
  ``greedy_generate``'s tokens equal to the JAX ``greedy_generate``'s
  (the scheduler-free loop; with and without an eos), under fp and under
  the W8A8 serving linears.
* The loader's frames bit-equal to the reference's.
* What stays decoder-only raises: the engine refuses the family with
  ``ValueError``; bucketed prefill, pages and an int8 KV cache raise
  ``NotImplementedError``, as in the reference.
"""
import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jconfig
from repro.configs import get_smoke_config as jsmoke
from repro.data import Loader as JLoader
from repro.data import SyntheticCorpus as JCorpus
from repro.models import build_model as jbuild
from repro.models.encdec import encode as jencode
from repro.train.serve import greedy_generate as jgreedy

from repro_torch.configs import ArchConfig, get_config, get_smoke_config
from repro_torch.data import Loader, SyntheticCorpus
from repro_torch.infer import Engine
from repro_torch.models import build_model, enc_len_for, params_from_jax
from repro_torch.models.encdec import encode
from repro_torch.train import greedy_generate

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (constants and helpers; imports no torch)

NAME = "seamless-m4t-medium"
#: the train policy's linears (the moment codecs play no part in a loss)
G8 = "*=w8c+a8t+g8t@int8_pallas"
W8A8 = "*=w8c+a8t@int8_pallas"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def pair(**kw):
    """(JAX cfg, JAX model, JAX params, port cfg, port model, port params):
    the smoke config at float32, the JAX init (seed 0) at the true fan-in
    scale, carried across."""
    jcfg = dataclasses.replace(jsmoke(NAME), dtype="float32", **kw)
    tcfg = dataclasses.replace(get_smoke_config(NAME), dtype="float32", **kw)
    jmodel, tmodel = jbuild(jcfg), build_model(tcfg)
    jparams = chip_smoke.true_fan_in(
        jmodel.init_params(jax.random.PRNGKey(0)), jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def batch(cfg, b=2, s=32, seed=0):
    rs = np.random.RandomState(seed)
    return {"frames": (rs.randn(b, enc_len_for(cfg, s), cfg.d_model)
                       * 0.1).astype(np.float32),
            "tokens": rs.randint(0, cfg.vocab_size, (b, s + 1)
                                 ).astype(np.int32)}


def _flat(tree, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{path}{k}."))
        else:
            out[path + k] = v
    return out


def _torch_batch(bt):
    return {k: torch.from_numpy(v) for k, v in bt.items()}


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    """The port's config is the JAX one field for field; full size has the
    reference's 877,031,424 parameters."""
    jcfg = jsmoke(NAME) if smoke else jconfig(NAME)
    tcfg = get_smoke_config(NAME) if smoke else get_config(NAME)
    assert tcfg == ArchConfig(**{f.name: getattr(jcfg, f.name)
                                 for f in dataclasses.fields(ArchConfig)})
    assert tcfg.param_count() == jcfg.param_count()
    if not smoke:
        assert tcfg.param_count() == 877_031_424


def test_param_tree_matches_reference():
    """Every leaf of the reference's ``encdec_spec`` with its shape (the
    carry-across checks both), and the port's own draw has the same tree
    with the reference's init kinds: zero biases, unit LayerNorm scales,
    the embedding at std 0.02."""
    *_, tcfg, tmodel, tparams = pair()
    own = tmodel.init_params(torch.Generator().manual_seed(0), device="cpu")
    flat, ref = _flat(own), _flat(tparams)
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    assert flat["enc_blocks.attn.wq"].shape == (2, 64, 64)
    assert flat["dec_blocks.cross_attn.bo"].shape == (2, 64)
    assert torch.equal(flat["dec_blocks.ln3.scale"], torch.ones(2, 64))
    assert torch.equal(flat["enc_blocks.mlp.b_fc1"], torch.zeros(2, 128))
    assert abs(flat["embed"].std().item() - 0.02) < 2e-3


@pytest.mark.parametrize("policy", [None, G8])
def test_encode_matches_jax(policy):
    """The encoder alone (bidirectional self-attention, frame_proj): within
    1e-5 of the output's largest entry."""
    jcfg, _, jparams, tcfg, _, tparams = pair()
    frames = batch(jcfg)["frames"]
    want = np.asarray(jencode(jparams, jnp.asarray(frames), jcfg,
                              policy=policy))
    with torch.no_grad():
        got = encode(tparams, torch.from_numpy(frames), tcfg,
                     policy=policy).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("policy", [None, W8A8])
def test_prefill_logits_match_jax(policy):
    """``encdec_prefill``: the last column's logits within 1e-4 of their
    largest entry; the self caches and the cross K/V have the reference's
    shapes."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair()
    bt = batch(jcfg, s=12)
    prompt = {"frames": bt["frames"], "tokens": bt["tokens"][:, :12]}
    jl, jst = jmodel.prefill(jparams, {k: jnp.asarray(v)
                                       for k, v in prompt.items()},
                             policy=policy, max_seq=20)
    with torch.no_grad():
        tl, tst = tmodel.prefill(tparams, _torch_batch(prompt),
                                 policy=policy, max_seq=20)
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 1e-4 * np.abs(jl).max()
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            assert tuple(tst[part][kv].shape) == jst[part][kv].shape
            want = np.asarray(jst[part][kv])
            assert np.abs(tst[part][kv].numpy() - want).max() <= \
                1e-5 * np.abs(want).max()


@pytest.mark.parametrize("policy,eos", [(None, None), (W8A8, None),
                                        (None, 7)])
def test_greedy_generate_matches_jax(policy, eos):
    """``greedy_generate`` routes the family to the scheduler-free loop and
    emits the JAX ``greedy_generate``'s tokens (with an eos: the done mask
    before emission, every later token the eos)."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair()
    bt = batch(jcfg, s=8, seed=3)
    prompt = {"frames": bt["frames"], "tokens": bt["tokens"][:, :8]}
    if eos is not None:
        # an eos the first step emits in one row
        lg, _ = jmodel.prefill(jparams, {k: jnp.asarray(v)
                                         for k, v in prompt.items()})
        eos = int(np.argmax(np.asarray(lg)[0]))
    want = np.asarray(jgreedy(jmodel, jparams, {k: jnp.asarray(v) for k, v
                                                in prompt.items()}, 6,
                              recipe=policy, eos_id=eos))
    got = greedy_generate(tmodel, tparams, prompt, 6, policy=policy,
                          eos_id=eos, device="cpu")
    assert got.dtype == np.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)
    if eos is not None:
        assert (got[0] == eos).all()


@pytest.mark.parametrize("step", [0, 3])
def test_loader_frames_bit_equal(step):
    """The loader's encdec batches: frames (B, seq // 4, d) float32 and
    tokens (B, seq + 1), bit for bit the reference loader's."""
    tcfg, jcfg = get_smoke_config(NAME), jsmoke(NAME)
    t = Loader(SyntheticCorpus(tcfg.vocab_size, seed=7), tcfg, batch_size=4,
               seq_len=64).peek(step)
    j = JLoader(JCorpus(jcfg.vocab_size, seed=7), jcfg, batch_size=4,
                seq_len=64).peek(step)
    assert set(t) == set(j) == {"frames", "tokens"}
    assert t["frames"].dtype == np.float32 and t["frames"].shape == (4, 16,
                                                                     64)
    for k in t:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])


def test_decoder_only_options_raise():
    """As the reference: the engine refuses the family (``ValueError``);
    bucketed prefill, a page table and an int8 KV cache are decoder-only
    (``NotImplementedError``)."""
    *_, tcfg, tmodel, tparams = pair()
    with pytest.raises(ValueError, match="greedy_generate"):
        Engine(tmodel, tparams, None, device="cpu")
    bt = _torch_batch(batch(tcfg, s=8))
    prompt = {"frames": bt["frames"], "tokens": bt["tokens"][:, :8]}
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tmodel.prefill(tparams, prompt, last_pos=torch.zeros(2).long())
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tmodel.prefill(tparams, prompt, segments=torch.zeros((2, 8)))
    with torch.no_grad():
        _, st = tmodel.prefill(tparams, prompt, max_seq=10)
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tmodel.decode(tparams, st, prompt["tokens"][:, :1],
                      torch.full((2,), 8), page_table=torch.zeros((2, 1)))
    with pytest.raises(NotImplementedError, match="decoder-only"):
        tmodel.init_decode_state(2, 10, 4, policy="kv_cache=a8t,*=w8c",
                                 device="cpu")
    st = tmodel.init_decode_state(2, 10, 4, device="cpu")
    assert tuple(st["self"]["k"].shape) == (2, 2, 10, 4, 16)
    assert tuple(st["cross"]["v"].shape) == (2, 2, 4, 4, 16)
