"""Port parity of the serving engine: the continuous-batching engine's
greedy tokens against the JAX ``Engine`` on its fused int8-KV path
(``REPRO_FUSED_DECODE=1``, Pallas in interpret mode), the freed-slot edge,
and the port's boundary rules (no JAX import, no silent CPU run).  The
model-level logits and caches are held against JAX in test_torch_model.py.
"""
import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.infer import Engine as JEngine, Request as JRequest
from repro.models import build_model as jbuild

from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.infer import Engine, Request, SamplingParams, sample
from repro_torch.models import build_model, params_from_jax

REPO = pathlib.Path(__file__).resolve().parents[1]

#: the serving slice's policy; ``int8_pallas`` names the same kernels in
#: both packages
POLICY = "kv_cache=a8t,*=w8c+a8t@int8_pallas"


def pair(dtype, seed=0):
    """(jax cfg, jax model, jax params, torch cfg, torch model, torch
    params on the CPU) for gpt2-mini at carrier ``dtype``."""
    jcfg = dataclasses.replace(get_smoke_config("gpt2-small"), dtype=dtype)
    tcfg = dataclasses.replace(tsmoke("gpt2-small"), dtype=dtype)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, build_model(tcfg), tparams


@pytest.mark.parametrize("policy", ["kv_cache=a8t,*=w8c", POLICY])
def test_engine_greedy_tokens_match_jax(policy, monkeypatch):
    """Continuous batching on the fused path (the fixture of
    test_decode_attn.py::test_engine_slot_turnover_fused): ragged prompts,
    more requests than slots, slot reuse mid-run -- greedy tokens equal to
    the JAX Engine's."""
    monkeypatch.setenv("REPRO_FUSED_DECODE", "1")
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = pair("float32")
    prompts = ([1, 2, 3], [4, 5], [6, 7, 8, 9], [2, 2], [3, 1, 4])
    jeng = JEngine(jmodel, jparams, policy, max_slots=2, max_seq=24)
    teng = Engine(tmodel, tparams, policy, max_slots=2, max_seq=24,
                  device="cpu")
    outs = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        ids = [eng.submit(req(tokens=list(t), max_new_tokens=4))
               for t in prompts]
        res = {r.request_id: r.tokens for r in eng.run()}
        assert sorted(res) == sorted(ids)
        outs.append(res)
    assert outs[0] == outs[1]
    assert teng.path_summary() == (
        "weights=prepared-int8(plain) kv=int8-fused" if "int8" in policy
        else "weights=prepared-int8(dequant) kv=int8-fused")


def test_engine_freed_slot_at_max_seq_is_inert():
    """A request that exhausts its cache rows leaves its slot at pos ==
    max_seq; that slot keeps riding the batched step (the decode kernel's
    clamped write, the clamped position embedding) without disturbing the
    slot next to it."""
    _, _, _, tcfg, tmodel, tparams = pair("float32")
    prompts = [[1, 2, 3, 4, 5, 6], [7, 8]]
    alone = Engine(tmodel, tparams, POLICY, max_slots=2, max_seq=8,
                   device="cpu").generate([prompts[1]], max_new_tokens=5)
    eng = Engine(tmodel, tparams, POLICY, max_slots=2, max_seq=8,
                 device="cpu")
    long_id = eng.submit(Request(tokens=prompts[0], max_new_tokens=10))
    short_id = eng.submit(Request(tokens=prompts[1], max_new_tokens=5))
    res = {r.request_id: r for r in eng.run()}
    assert res[long_id].finish_reason == "length"
    # the prefill's token, then the steps writing rows 6 and 7: full
    assert len(res[long_id].tokens) == 3
    assert res[short_id].tokens == list(alone[0])


def test_import_leaves_jax_out():
    code = ("import sys; import repro_torch, repro_torch.infer, "
            "repro_torch.infer.pages, repro_torch.infer.scheduler, "
            "repro_torch.infer.resilience, "
            "repro_torch.kernels, repro_torch.models, repro_torch.optim, "
            "repro_torch.train, repro_torch.data, "
            "repro_torch.launch.train, repro_torch.core.qlinear; "
            "print('jax' in sys.modules, "
            "any(m == 'repro' or m.startswith('repro.') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["False", "False"]


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_import_no_jax_or_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), (f, mod)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, _, tcfg, tmodel, tparams = pair("float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(tmodel, tparams, POLICY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(torch.Generator().manual_seed(0))
    eng = Engine(tmodel, tparams, POLICY, device="cpu")
    assert eng.path_summary() == "weights=prepared-int8(plain) kv=int8-fused"


def test_sampling():
    """Greedy is the argmax; the truncations keep the top-1 token; draws
    repeat under a seeded generator; bad parameters are refused."""
    logits = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    assert torch.equal(sample(logits, SamplingParams()), greedy)
    for sp in (SamplingParams(temperature=0.7, top_k=1),
               SamplingParams(temperature=1.3, top_p=1e-6)):
        assert torch.equal(sample(logits, sp, torch.Generator()), greedy)
    sp = SamplingParams(temperature=1.0, top_k=5, top_p=0.9)
    draws = [sample(logits, sp, torch.Generator().manual_seed(3))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    top5 = torch.topk(logits, 5, dim=-1).indices
    assert all(int(t) in top5[i] for i, t in enumerate(draws[0]))
    for bad in ({"temperature": -1.0}, {"top_k": -1}, {"top_p": 0.0}):
        with pytest.raises(ValueError):
            SamplingParams(**bad)


def test_engine_eos_stops_and_is_dropped():
    """An eos token ends the request and is not part of its tokens -- the
    first sampled token (from the prefill logits) included."""
    _, _, _, tcfg, tmodel, tparams = pair("float32")
    kw = dict(max_slots=2, max_seq=16, device="cpu")
    toks = Engine(tmodel, tparams, POLICY, **kw).generate([[1, 2, 3]], 3)[0]
    for stop_at in range(3):
        eng = Engine(tmodel, tparams, POLICY, **kw)
        eng.submit(Request(tokens=[1, 2, 3], max_new_tokens=3,
                           eos_id=int(toks[stop_at])))
        (res,) = eng.run()
        first = list(toks).index(toks[stop_at])
        assert res.finish_reason == "eos"
        assert res.tokens == list(toks[:first])
