"""The encoder-decoder family (seamless-m4t) trained, against the JAX
package, on the seamless smoke config (2 + 2 layers, d_model 64) with the
inputs and weights of ``test_torch_encdec.py`` (``pair``, ``batch``).

* ``encdec_loss`` and its gradients, under fp linears (JAX jitted) and,
  JAX run eagerly (op by op, as the port rounds), under
  ``TRAIN_POLICY``'s linears (``*=w8c+a8t+g8t``, #3, #4 and #5's plain
  versions): the loss within 1e-5 relative (readings at batch seeds 0-3:
  0 to 6.2e-6).  Under fp linears every gradient leaf within 1e-4 in
  relative L2 (the limit of ``test_torch_llama.py``'s loss test; readings
  1.6e-7 to 1.8e-6).  Under the int8 linears each leaf within 5e-2 and
  all of them together within 2e-2 (readings at seeds 0-3: the worst leaf
  4.5e-4 to 1.8e-2, together 6.1e-5 to 9.2e-3): the forward is bit for
  bit the eager JAX one, but the fp backwards part by an ulp, and a
  per-token gradient payload that lands on the other side of a rounding
  boundary moves its row's gradient (the SSM family's finding); the
  encoder's leaves, reached through every decoder layer's
  cross-attention, collect the most.  The cross-attention's key bias has
  a gradient of zero in exact arithmetic (it shifts every score of a
  query alike): in both packages it is rounding noise, held below 1e-6 of
  the loss's largest leaf gradient instead.
* Under ``attention_impl="flash_pallas"`` (the encoder's and the
  cross-attention's flash calls non-causal, the cross one at Sq > Skv;
  the plain versions here, the JAX flash attention in interpret mode
  there), fp linears: the limits of fp linears above.
* ``remat`` on and off: loss and every gradient bit-identical.
* The launcher's smoke run on the CPU, which checkpoints on a preemption
  and resumes.
* The launches ``chip_smoke.py`` pins for phases 27b and 28a, counted at
  the smoke size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models import build_model
from repro_torch.models.common import tree_flatten, tree_unflatten
from repro_torch.train import greedy_generate
from test_torch_encdec import (G8, NAME, _flat, _torch_batch, batch,
                               chip_smoke, pair)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("policy,impl", [(None, "xla"), (G8, "xla"),
                                         (None, "flash_pallas")])
def test_loss_and_grads_match_jax(policy, impl):
    """``encdec_loss`` and its gradients (JAX eagerly) within the limits of
    the module docstring."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair(attention_impl=impl)
    bt = batch(jcfg)
    vg = jax.value_and_grad(
        lambda p: jmodel.train_loss(p, {k: jnp.asarray(v) for k, v in
                                        bt.items()}, policy=policy),
        has_aux=True)
    # fp linears jitted (quicker; XLA's fusions move fp sums by an ulp or
    # so); the int8 route eagerly, where a jitted quantizer would flip
    # payloads against the port's op-by-op rounding
    (jce, _), jg = (jax.jit(vg) if policy is None else vg)(jparams)
    leaves = _flat(tparams)
    for t in leaves.values():
        t.requires_grad_()
    ce, metrics = tmodel.train_loss(tparams, _torch_batch(bt), policy=policy)
    ce.backward()
    assert set(metrics) == {"ce", "loss"}
    assert abs(ce.item() - float(jce)) <= 1e-5 * abs(float(jce))
    jflat = {k: np.asarray(v, np.float64) for k, v in _flat(jg).items()}
    assert set(jflat) == set(leaves)
    top = max(np.linalg.norm(w) for w in jflat.values())
    num = den = 0.0
    for k, t in leaves.items():
        g, w = t.grad.numpy().astype(np.float64), jflat[k]
        if k.endswith("cross_attn.bk"):
            # zero in exact arithmetic: both are rounding noise
            assert max(np.linalg.norm(g), np.linalg.norm(w)) <= 1e-6 * top
            continue
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= (1e-4 if policy is None else 5e-2), (k, rel)
        num += np.square(g - w).sum()
        den += np.square(w).sum()
    assert np.sqrt(num / den) <= (1e-4 if policy is None else 2e-2)


def test_remat_on_and_off_bit_identical():
    """Each encoder and decoder block one checkpoint under ``remat``: the
    loss and every gradient bit for bit as without it (int8 linears)."""
    *_, tcfg, tmodel, tparams = pair()
    bt = _torch_batch(batch(tcfg))
    runs = []
    for remat in (True, False):
        model = build_model(dataclasses.replace(tcfg, remat=remat))
        leaves, _ = tree_flatten(tparams)
        leaves = [t.detach().clone().requires_grad_() for t in leaves]
        p = tree_unflatten(tree_flatten(tparams)[1], leaves)
        ce, _ = model.train_loss(p, bt, policy=G8)
        runs.append((ce.detach(), torch.autograd.grad(ce, leaves)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_launcher_trains_and_checkpoints(tmp_path, capsys):
    """``--arch seamless-m4t-medium --smoke`` on the CPU: a finite ce, a
    preemption checkpoint (``sigterm_run@1``) and a second run that resumes
    from it."""
    from repro_torch.launch import train as launcher
    argv = ["--arch", NAME, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--state-storage", "int",
            "--policy", "*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt"
            "@int8_cuda", "--ckpt", str(tmp_path)]
    launcher.main(argv + ["--fault", "sigterm_run@1"])
    out = capsys.readouterr().out
    assert "arch=seamless-smoke" in out and "remat=layer+ce" in out
    rows = [ln for ln in out.splitlines() if ln.startswith("step ")]
    assert len(rows) == 1 and np.isfinite(float(rows[0].split("ce=")[1]
                                                .split()[0]))
    assert "'saves': 1" in out and "'preempted': True" in out
    assert any(tmp_path.iterdir())
    # the second run resumes after step 1: it logs no step-1 row
    launcher.main(argv)
    out = capsys.readouterr().out
    assert "train-path:" in out and "step     1" not in out


class _Counted:
    """Counts the calls of the int8 and flash kernel wrappers (on CPU
    tensors they run their plain versions) by ``chip_smoke``'s counter
    names, and the flash calls by (kernel, mask, Sq, Skv) as
    ``chip_smoke.flash_calls_recorded`` tallies them on the card."""

    FLASH = {"flash_attention_fwd": "#7", "flash_attention_fwd_lse": "#8",
             "flash_attention_bwd_dkdv": "#9", "flash_attention_bwd_dq": "#10"}

    def __init__(self, monkeypatch):
        import repro_torch.kernels.flash_attn as fa
        import repro_torch.kernels.ops as ops
        import repro_torch.models.attention as attention
        self.counts, self.calls = {}, {}
        for name in ("int8_matmul", "int8_quant_matmul", "int8_matmul_nt",
                     "int8_matmul_tn"):
            counter = "int8_matmul" if name == "int8_quant_matmul" else name
            monkeypatch.setattr(ops, name,
                                self._wrap(counter, getattr(ops, name)))
        for name, tag in self.FLASH.items():
            fn = self._wrap(name, getattr(fa, name), tag)
            monkeypatch.setattr(fa, name, fn)
            if hasattr(attention, name):
                monkeypatch.setattr(attention, name, fn)

    def _wrap(self, counter, fn, tag=None):
        def call(*a, **kw):
            self.counts[counter] = self.counts.get(counter, 0) + 1
            if tag is not None:
                key = (tag, "causal" if kw.get("causal", True) else "full",
                       a[0].shape[1], a[1].shape[1])
                self.calls[key] = self.calls.get(key, 0) + 1
            return fn(*a, **kw)
        return call


def test_launches_match_chip_smoke(monkeypatch):
    """The launches ``chip_smoke.py`` pins for phases 27b and 28a, checked
    at the smoke size on the CPU by counting the wrappers' calls:
    ``greedy_generate`` (one prefill, ``new`` decode steps) runs
    ``seamless_serve_launches``' #3 and #7 calls, and one train step's
    forward and backward ``train_launches``' #3-#5 and #8-#10 with the
    flash calls of ``seamless_train_calls`` (non-causal on the encoder and
    the cross-attention)."""
    from repro_torch.train.step import value_and_grad
    *_, tcfg, _, tparams = pair(attention_impl="flash_pallas")
    cfg = dataclasses.replace(tcfg, dtype="bfloat16")
    model = build_model(cfg)
    bt = batch(cfg, s=32, seed=4)
    prompt = {"frames": bt["frames"], "tokens": bt["tokens"][:, :8]}
    rec = _Counted(monkeypatch)
    greedy_generate(model, tparams, prompt, 4,
                    policy="*=w8c+a8t@int8_cuda", device="cpu")
    counts, calls = chip_smoke.seamless_serve_launches(
        cfg, bt["frames"].shape[1], 8, 4)
    assert rec.counts == {k: v for k, v in counts.items() if v}
    assert rec.calls == calls
    rec.counts, rec.calls = {}, {}
    value_and_grad(model, chip_smoke.TRAIN_POLICY, tparams, _torch_batch(bt))
    want = {k: v for k, v in chip_smoke.train_launches(cfg).items()
            if v and k != "fused_adamw_leaves"}
    assert rec.counts == want
    assert rec.calls == chip_smoke.seamless_train_calls(
        cfg, 32, bt["frames"].shape[1])
