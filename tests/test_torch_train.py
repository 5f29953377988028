"""Port parity of the training slice, module by module: the same numpy
inputs through the JAX package and ``repro_torch`` on the CPU.

* ``int8_matmul_nt`` / ``int8_matmul_tn``: the plain versions (what the
  wrappers run on CPU tensors) against ``repro.kernels.ops.int8_bwd_dx`` /
  ``int8_bwd_dw`` with the Pallas kernels in interpret mode -- bit for bit
  (exact integer sums, the same IEEE divisions and epilogue order);
* ``fused_adamw_blocks``: the plain version against the JAX kernel in
  interpret mode, and ``adamw_update``'s fused and loop paths against the
  JAX package's (``REPRO_FUSED_ADAM`` pinned, as tests/test_opt_update.py
  does).  Limits: params within 1e-6 of each leaf's largest magnitude,
  int8 payloads and zero points at most one codec step apart, scales within
  1e-6 relative.  Why not bit for bit: XLA's CPU backend contracts
  ``b1 * m + (1 - b1) * g`` and ``p - lr * u`` into FMAs (one rounding,
  where the kernel's source and the port round twice), and the reference
  loop rounds ``1 - b1`` in Python float64 where the kernel subtracts in
  float32 -- an ulp of a moment that can move a payload across a rounding
  boundary.  Readings on this tree: params at most 6.4e-8, scales 3.5e-7;
* the Fig-1 linears (``core/qlinear``): y, dx and dW against ``jax.vjp`` of
  the policy's linear -- bit for bit where every matmul is an int8 kernel,
  within 1e-5 of the largest magnitude where a float32 matmul sums in
  another order (readings at most 4.0e-7);
* the moment codecs and the train-state carriers, bit for bit; the
  synthetic corpus, token for token; the launcher's ``train-path:`` line,
  string for string.

The whole train step is held against JAX in test_torch_train_step.py; the
CUDA kernels against these plain versions in test_torch_cuda.py.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jsmoke
from repro.core import qadam as jqadam
from repro.core.quantizer import quantize_int as j_quantize
from repro.core.qconfig import get_recipe as jget_recipe
from repro.core.qconfig import parse_recipe as jparse_recipe
from repro.core.qconfig import parse_spec as jparse_spec
from repro.core.qpolicy import LinearCtx as JCtx
from repro.core.qpolicy import parse_policy as jparse_policy
from repro.data import Loader as JLoader, SyntheticCorpus as JCorpus
from repro.kernels import opt_update as jopt_update
from repro.kernels.ops import int8_bwd_dw as j_dw, int8_bwd_dx as j_dx
from repro.models import build_model as jbuild
from repro.optim import OptConfig as JOpt
from repro.optim import adamw_update as j_adamw
from repro.optim import init_adam_state as j_init_adam
from repro.train import init_train_state as j_init_train
from repro.train.step import train_path_summary as j_summary

from repro_torch.configs import get_smoke_config as tsmoke
from repro_torch.core import qadam
from repro_torch.core.qconfig import (QuantSpec, RoundMode, get_recipe,
                                      parse_recipe, parse_spec)
from repro_torch.core.qlinear import _train_fake_quant
from repro_torch.core.qpolicy import LinearCtx, parse_policy
from repro_torch.core.quantizer import quantize_int
from repro_torch.data import Loader, SyntheticCorpus
from repro_torch.kernels import opt_update
from repro_torch.kernels.ops import int8_bwd_dw, int8_bwd_dx
from repro_torch.launch import train as launcher
from repro_torch.models import (build_model, opt_state_from_jax,
                                train_state_from_jax, train_state_to_numpy)
from repro_torch.optim import OptConfig, adamw_update
from repro_torch.train import make_train_step

REPO = pathlib.Path(__file__).resolve().parents[1]
#: the slice's main policy (``int8_pallas`` names the same kernels in both
#: packages) and the two others that share its modules
MAIN = "*=w8c+a8t+g8t+m1:8c-b128+m2:8c-asym-b128-sqrt@int8_pallas"
INT8_FWD = "*=w8c+a8t@int8_pallas"
CODECS = ["m1:8c-b128,m2:8c-asym-b128-sqrt", "m1:8c-b128,m2:8c-b128"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs several pytest workers at once,
    and torch's default of one thread per core oversubscribes the CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jt(x):
    return np.asarray(x)


def rel_max(a, b) -> float:
    """max |a - b| over the largest magnitude of b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# ---------------------------------------------------------------------------
# int8 backward kernels (plain versions) against the Pallas kernels
# ---------------------------------------------------------------------------

#: (M tokens, N out features, K in features): gpt2-mini's three linears at
#: 2 x 64 tokens, and a ragged shape off every tile multiple
BWD_SHAPES = [(128, 128, 128), (128, 512, 128), (128, 128, 512),
              (33, 257, 90)]


@pytest.mark.parametrize("m,n,k", BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_bwd_plain_bit_exact(m, n, k, dtype):
    rng = np.random.RandomState(m + n + k)
    g = (rng.randn(m, n) * 0.01).astype(np.float32)
    wq = rng.randint(-128, 128, (k, n)).astype(np.int8)
    ws = rng.uniform(1e-3, 0.1, (1, n)).astype(np.float32)
    xq = rng.randint(-128, 128, (m, k)).astype(np.int8)
    xs = rng.uniform(1e-3, 0.1, (m, 1)).astype(np.float32)
    # exact ties, where half-to-even decides the payload: row 0 (dx) and
    # column 6 (dW) get a scale of exactly 127 / 127 = 1 and x.5 values
    ties = [0.5, 1.5, 2.5, -2.5, -0.5]
    ws[0, :8], xs[:8] = 1.0, 1.0
    g[0, :8] = [127.0, *ties[:4], 0.0, 127.0, -3.5]
    g[1:8, 6] = [*ties, -1.5, 4.5]
    g[3], g[:, 5] = 0.0, 0.0            # an all-zero row and column
    jg = jnp.asarray(g).astype(getattr(jnp, dtype))
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jdx = j_dx(jg, jnp.asarray(wq), jnp.asarray(ws), interpret=True)
    tdx = int8_bwd_dx(tg, torch.from_numpy(wq), torch.from_numpy(ws))
    assert tdx.dtype == tg.dtype and tuple(tdx.shape) == (m, k)
    np.testing.assert_array_equal(tdx.float().numpy(),
                                  jt(jdx.astype(jnp.float32)))
    jdw = j_dw(jnp.asarray(xq), jnp.asarray(xs), jg, out_dtype=jg.dtype,
               interpret=True)
    tdw = int8_bwd_dw(torch.from_numpy(xq), torch.from_numpy(xs), tg,
                      out_dtype=tg.dtype)
    np.testing.assert_array_equal(tdw.float().numpy(),
                                  jt(jdw.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_bit_exact(dtype):
    """The spec-driven int8 linear (quantize both operands, then the int8
    matmul): bit for bit ``repro.kernels.ops.int8_linear``."""
    from repro.core.qconfig import (Granularity as JGran,
                                    QuantSpec as JSpec)
    from repro.kernels.ops import int8_linear as j_linear
    from repro_torch.core.qconfig import Granularity
    from repro_torch.kernels.ops import int8_linear
    rng = np.random.RandomState(5)
    x = rng.randn(2, 33, 96).astype(np.float32)
    w = (rng.randn(96, 80) * 0.1).astype(np.float32)
    for a, wg in (("per_token", "per_channel"), ("per_tensor", "per_tensor")):
        j = j_linear(jnp.asarray(x).astype(getattr(jnp, dtype)),
                     jnp.asarray(w).astype(getattr(jnp, dtype)),
                     JSpec(8, JGran(a)), JSpec(8, JGran(wg)), interpret=True)
        t = int8_linear(torch.from_numpy(x).to(getattr(torch, dtype)),
                        torch.from_numpy(w).to(getattr(torch, dtype)),
                        QuantSpec(8, Granularity(a)),
                        QuantSpec(8, Granularity(wg)))
        np.testing.assert_array_equal(t.float().numpy(),
                                      jt(j.astype(jnp.float32)))


# ---------------------------------------------------------------------------
# fused AdamW
# ---------------------------------------------------------------------------

def assert_moments_close(t, j):
    """A port moment against a JAX one: QStates within one codec step
    (payload and zero point) and 1e-6 relative (scale); fp moments within
    1e-6 of their largest magnitude."""
    if isinstance(j, tuple):
        assert isinstance(t, tuple)
        dq = np.abs(t[0].numpy().astype(np.int32) - jt(j[0]).astype(np.int32))
        assert dq.max() <= 1
        s_t, s_j = t[1].numpy(), jt(j[1])
        assert (np.abs(s_t - s_j) <= 1e-6 * np.abs(s_j)).all()
        assert np.abs(t[2].numpy() - jt(j[2])).max() <= 1
    else:
        assert rel_max(t.numpy(), jt(j)) <= 1e-6


@pytest.mark.parametrize("codec", CODECS)
def test_fused_adamw_plain_matches_jax_kernel(codec):
    """One fused step over a 512 x 128 bucket whose last 40 rows are the
    optimizer's zero padding."""
    jr, tr = jparse_recipe(codec), parse_recipe(codec)
    rng = np.random.RandomState(len(codec))
    rows, bs, pad = 512, 128, 40
    g = (rng.randn(rows, bs) * 1e-2).astype(np.float32)
    p = rng.randn(rows, bs).astype(np.float32)
    m1 = (rng.randn(rows, bs) * 1e-3).astype(np.float32)
    m2 = (rng.rand(rows, bs) * 1e-5).astype(np.float32)
    if tr.adam_m2.sqrt_domain:
        m2 = np.sqrt(m2)
    state = [jt(a).copy() for a in (*j_quantize(jnp.asarray(m1), jr.adam_m1),
                                    *j_quantize(jnp.asarray(m2), jr.adam_m2))]
    bucket = [g, p] + state
    for a in bucket:
        a[rows - pad:] = 0
    sc = np.array([0.7, 1e-3, 0.9, 0.95, 1e-8, 0.1, 1 - 0.9 ** 3,
                   1 - 0.95 ** 3], np.float32)
    jp, jm1, jm2, jsum = jopt_update.fused_adamw_blocks(
        *(jnp.asarray(a) for a in bucket), jnp.asarray(sc),
        m1_codec=jopt_update.codec_of(jr.adam_m1),
        m2_codec=jopt_update.codec_of(jr.adam_m2), weight_decay=True,
        block_rows=256, interpret=True)
    tp, tm1, tm2, tsum = opt_update.fused_adamw_blocks(
        *(torch.from_numpy(a.copy()) for a in bucket), torch.from_numpy(sc),
        m1_codec=opt_update.codec_of(tr.adam_m1),
        m2_codec=opt_update.codec_of(tr.adam_m2), weight_decay=True)
    assert rel_max(tp.numpy(), jt(jp)) <= 1e-6
    for t, j in ((tm1, jm1), (tm2, jm2)):
        assert_moments_close(t, j)
    np.testing.assert_array_equal(tp.numpy()[rows - pad:], 0.0)
    assert abs(float(tsum) - float(jsum)) <= 1e-5 * float(jsum)


def _opt_params(rng):
    """A bucket whose rows end in padding (9100 % 128 != 0; 136 rows padded
    to 256), plus the loop's leaves: a 1-D bias and a leaf under
    MIN_QUANT_SIZE."""
    return {"w_ragged": rng.randn(130, 70).astype(np.float32),
            "w_aligned": rng.randn(64, 128).astype(np.float32),
            "bias": rng.randn(128).astype(np.float32),
            "tiny": rng.randn(8, 8).astype(np.float32)}


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("port_fused,jax_fused", [(True, True),
                                                  (False, False),
                                                  (True, False)])
def test_adamw_update_matches_jax(codec, port_fused, jax_fused, monkeypatch):
    """One step of ``adamw_update`` from a state with non-zero int8 moments
    (the JAX loop's first step), int storage: port fused (the kernel's
    plain version) or loop against JAX fused (interpret) or loop."""
    monkeypatch.setenv("REPRO_FUSED_ADAM", "0")
    jr, tr = jparse_recipe(codec), parse_recipe(codec)
    rng = np.random.RandomState(7)
    params = _opt_params(rng)
    grads = [{k: (rng.randn(*v.shape) * 0.1).astype(np.float32)
              for k, v in params.items()} for _ in range(2)]
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=10 ** 6,
              weight_decay=0.1, grad_clip=1.0, state_storage="int")
    jcfg, tcfg = JOpt(**kw), OptConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = j_init_adam(jp, jr, jcfg)
    jp, jst, _ = j_adamw(jp, {k: jnp.asarray(v) for k, v in grads[0].items()},
                         jst, jcfg, jr)
    tp = {k: torch.from_numpy(jt(v).copy()) for k, v in jp.items()}
    tst = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, jst),
                             device="cpu")
    monkeypatch.setenv("REPRO_FUSED_ADAM", "1" if jax_fused else "0")
    jp2, jst2, jstats = j_adamw(
        jp, {k: jnp.asarray(v) for k, v in grads[1].items()}, jst, jcfg, jr)
    tp2, tst2, tstats = adamw_update(
        tp, {k: torch.from_numpy(v) for k, v in grads[1].items()}, tst, tcfg,
        tr, fused=port_fused)
    for k in params:
        assert rel_max(tp2[k].numpy(), jt(jp2[k])) <= 1e-6, k
        assert_moments_close(tst2.m1[k], jst2.m1[k])
        assert_moments_close(tst2.m2[k], jst2.m2[k])
    assert int(tst2.step) == int(jst2.step) == 2
    for name in ("lr", "grad_norm", "update_norm"):
        assert abs(float(tstats[name]) - float(jstats[name])) <= \
            1e-5 * abs(float(jstats[name])), name


@pytest.mark.parametrize("device,jax_fused", [(None, "1"), ("cuda", "1"),
                                              ("cpu", "0")])
@pytest.mark.parametrize("storage", ["int", "fake"])
def test_train_path_summary_names_the_default_opt_path(device, jax_fused,
                                                       storage, monkeypatch):
    """The summary's ``opt=`` segment is the path ``adamw_update`` takes by
    default on the device (the card unless told otherwise): the JAX line
    with its fused kernel on (the card) or off (the CPU)."""
    from repro_torch.optim.adamw import fused_default
    from repro_torch.train import train_path_summary
    monkeypatch.setenv("REPRO_FUSED_ADAM", jax_fused)
    kw = {} if device is None else {"device": device}
    got = train_path_summary(MAIN.replace("int8_pallas", "int8_cuda"), 4,
                             OptConfig(state_storage=storage), **kw)
    want = j_summary(jparse_policy(MAIN), 4, JOpt(state_storage=storage))
    assert got == want.replace("int8_pallas", "int8_cuda")
    fused = fused_default(parse_policy(MAIN), OptConfig(state_storage=storage),
                          torch.device(device or "cuda"))
    assert ("opt=int8-fused" in got) == fused == (storage == "int"
                                                  and jax_fused == "1")


# ---------------------------------------------------------------------------
# Fig-1 linears against jax.vjp
# ---------------------------------------------------------------------------

#: (policy, bit-exact?): every matmul an int8 kernel, or a float32 matmul
#: somewhere (forward or backward) that sums in another order
LINEAR_POLICIES = [
    ("*=w8c+a8t+g8t@int8_pallas", True),    # int8 forward and backward
    (INT8_FWD, False),                      # int8 forward, reference VJP
    ("paper", False),                       # fake quant (the paper)
    ("*=w8c+a8t+g8t", False),               # fake quant, G on the dW path
    ("*=w8c-asym+a8t+g8t+gx8t", False),     # fp residual, dx ablation
]


def _policy_pair(text):
    if "=" in text:
        return jparse_policy(text), parse_policy(text)
    return jget_recipe(text), get_recipe(text)


@pytest.mark.parametrize("policy,exact", LINEAR_POLICIES)
def test_qlinear_matches_jax_vjp(policy, exact):
    from repro.core.qpolicy import as_policy as j_as_policy
    from repro_torch.core.qpolicy import as_policy
    jp, tp = _policy_pair(policy)
    jp, tp = j_as_policy(jp), as_policy(tp)
    rng = np.random.RandomState(3)
    x = rng.randn(2, 33, 96).astype(np.float32)
    w = (rng.randn(96, 80) * 0.1).astype(np.float32)
    g = (rng.randn(2, 33, 80) * 0.01).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a, b: jp.linear(JCtx("mlp_up"), a, b),
                       jnp.asarray(x), jnp.asarray(w))
    dx_j, dw_j = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y_t = tp.linear(LinearCtx("mlp_up"), xt, wt)
    y_t.backward(torch.from_numpy(g))
    pairs = [(y_t.detach(), y_j), (xt.grad, dx_j), (wt.grad, dw_j)]
    int8_fwd = "int8" in policy
    for i, (t, j) in enumerate(pairs):
        if exact or (i == 0 and int8_fwd):
            np.testing.assert_array_equal(t.numpy(), jt(j))
        else:
            assert rel_max(t.numpy(), jt(j)) <= 1e-5, (policy, i)


# ---------------------------------------------------------------------------
# codecs, state carriers, data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["8c-b128", "8c-asym-b128-sqrt", "8c-asym-b64",
                                  "4c", "8t-asym", "8n-b128-sqrt"])
@pytest.mark.parametrize("storage", ["int", "fake"])
@pytest.mark.parametrize("shape", [(130, 70), (64, 128)])
def test_moment_codec_bit_exact(spec, storage, shape):
    rng = np.random.RandomState(sum(shape))
    v = (rng.randn(*shape) * 1e-3).astype(np.float32)
    if "sqrt" in spec:
        v = np.abs(v) ** 2
    v.reshape(-1)[:4] = [0.0, 1e-3, -1e-3, 5e-4]
    js, ts = jparse_spec(spec), parse_spec(spec)
    je = jqadam.encode(jnp.asarray(v), js, storage)
    te = qadam.encode(torch.from_numpy(v), ts, storage)
    if storage == "int":
        assert isinstance(te, qadam.QState)
        for a, b in zip(te, je):
            np.testing.assert_array_equal(a.numpy(), jt(b))
    else:
        np.testing.assert_array_equal(te.numpy(), jt(je))
    np.testing.assert_array_equal(
        qadam.decode(te, ts, shape).numpy(),
        jt(jqadam.decode(je, js, shape)))


def test_train_state_round_trips():
    """A JAX train state (gpt2-mini, the main policy, int moments) carried
    into the port and back, leaf for leaf."""
    jcfg, tcfg = jsmoke("gpt2-small"), tsmoke("gpt2-small")
    jst = j_init_train(jbuild(jcfg), jax.random.PRNGKey(1),
                       jparse_policy(MAIN), JOpt(state_storage="int"))
    np_state = jax.tree_util.tree_map(np.asarray, jst)
    tst = train_state_from_jax(np_state, tcfg, device="cpu")
    assert isinstance(tst.opt.m1["blocks"]["attn"]["wq"], qadam.QState)
    assert not isinstance(tst.opt.m1["final_norm"]["scale"], qadam.QState)
    back = train_state_to_numpy(tst)
    a, b = jax.tree_util.tree_leaves(np_state), jax.tree_util.tree_leaves(back)
    assert len(a) == len(b) > 50
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_loader_tokens_match_jax():
    jcfg, tcfg = jsmoke("gpt2-small"), tsmoke("gpt2-small")
    for split in ("train", "valid"):
        jl = JLoader(JCorpus(jcfg.vocab_size, seed=7), jcfg, batch_size=4,
                     seq_len=40, split=split)
        tl = Loader(SyntheticCorpus(tcfg.vocab_size, seed=7), tcfg,
                    batch_size=4, seq_len=40, split=split)
        for _ in range(3):
            np.testing.assert_array_equal(next(tl)["tokens"],
                                          next(jl)["tokens"])
    assert tl.state_dict() == {"step": 3}


# ---------------------------------------------------------------------------
# the launcher, its guarded path, and the paths that are not ported
# ---------------------------------------------------------------------------

def _launch(args, timeout=300):
    """The port's launcher in a fresh interpreter: its stdout lines, after
    checking that it exited 0 and imported neither JAX nor ``repro``."""
    code = ("import runpy, sys; sys.argv = ['train'] + sys.argv[1:]; "
            "runpy.run_module('repro_torch.launch.train', run_name='__main__'); "
            "print('imports', 'jax' in sys.modules, any(m == 'repro' or "
            "m.startswith('repro.') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code, *args],
                         capture_output=True, text=True, timeout=timeout,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "imports False False"
    return lines[:-1]


LAUNCH = [
    ["--state-storage", "int", "--policy",
     MAIN.replace("int8_pallas", "int8_cuda")],
    ["--recipe", "paper"],
    ["--policy", INT8_FWD.replace("int8_pallas", "int8_cuda")],
]


@pytest.mark.parametrize("args", LAUNCH)
def test_launcher_trains_on_cpu(args, monkeypatch):
    """``--device cpu --smoke --steps 10`` in a fresh interpreter: the
    reference's rows (the first step and every 10th) with finite ce, no JAX
    or ``repro`` module loaded, and the ``train-path:`` line the JAX
    launcher prints for the same policy, then the port's recomputation
    segments (the smoke config's ``remat``, 8 x 64 tokens: no q-chunks)."""
    lines = _launch(["--arch", "gpt2-small", "--device", "cpu", "--smoke",
                     "--steps", "10", *args])
    steps = [l for l in lines if l.startswith("step ")]
    assert [l.split()[1] for l in steps] == ["1", "10"]
    assert all(np.isfinite(float(l.split("ce=")[1].split()[0])) for l in steps)
    monkeypatch.delenv("REPRO_FUSED_ADAM", raising=False)
    text = args[args.index("--policy") + 1] if "--policy" in args else None
    jrec = (jparse_policy(text.replace("int8_cuda", "int8_pallas")) if text
            else jget_recipe(args[args.index("--recipe") + 1]))
    storage = "int" if "int" in args else "fake"
    want = j_summary(jrec, 4, JOpt(state_storage=storage))
    path = [l for l in lines if l.startswith("train-path: ")]
    assert path == ["train-path: " + want.replace("int8_pallas", "int8_cuda")
                    + " remat=layer+ce attend=dense"]


def _resilience(lines):
    import ast
    row = [l for l in lines if l.startswith("resilience: ")]
    assert len(row) == 1, lines
    return ast.literal_eval(row[0][len("resilience: "):])


SMOKE = ["--arch", "gpt2-small", "--device", "cpu", "--smoke",
         "--state-storage", "int", "--policy",
         MAIN.replace("int8_pallas", "int8_cuda")]


@pytest.mark.parametrize("flag", ["--ckpt", "--sentinel", "--fault"])
def test_launcher_guarded_flags_on_cpu(flag, tmp_path):
    """The reference's guarded-path flags on the smoke config:
    ``--ckpt`` with a SIGTERM after step 1 writes the preemption checkpoint
    and a second run resumes from it (each logs its first step);
    ``--sentinel`` walks the ladder on ``nan_grad@1`` (skips, a rollback
    with nothing to restore, a fallback window that the 10th step's row
    marks ``[fallback]``); ``--fault`` alone poisons step 1 and reports
    it."""
    if flag == "--ckpt":
        ckpt = str(tmp_path / "ckpt")
        first = _launch(SMOKE + ["--steps", "4", "--ckpt", ckpt, "--fault",
                                 "sigterm_run@1"])
        assert "fault-plan: sigterm_run@1" in first
        assert [l.split()[1] for l in first if l.startswith("step ")] == \
            ["1"]
        assert _resilience(first)["preempted"] is True
        assert os.listdir(ckpt) == ["step_0000000002"]
        second = _launch(SMOKE + ["--steps", "4", "--ckpt", ckpt])
        assert [l.split()[1] for l in second if l.startswith("step ")] == \
            ["3"]
    elif flag == "--sentinel":
        lines = _launch(SMOKE + ["--steps", "10", "--sentinel",
                                 "--fallback-steps", "10", "--fault",
                                 "nan_grad@1"])
        rows = [l for l in lines if l.startswith("step ")]
        assert [(l.split()[1], l.endswith("[fallback]")) for l in rows] == \
            [("1", False), ("10", True)]
        res = _resilience(lines)
        assert res["sentinel"]["rollbacks"] == 1
        assert res["sentinel"]["fallback_steps_run"] == 6
        assert res["skipped_batches"] == 3 and res["rollback_failures"] == 1
        assert res["sentinel"]["spike_reasons"] == {"nonfinite-grad": 3}
    else:
        lines = _launch(SMOKE + ["--steps", "2", "--fault", "nan_grad@1"])
        assert "fault-plan: nan_grad@1" in lines
        assert _resilience(lines)["faults_fired"] == ["nan_grad@1"]


@pytest.mark.parametrize("flag", [["--model-parallel", "2"]])
def test_launcher_refuses_flags_not_ported(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launcher.main(["--arch", "gpt2-small", "--smoke", "--device", "cpu",
                       *flag])


def test_launcher_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--arch", "gpt2-small", "--smoke", "--steps", "1"])


def test_paths_not_ported_raise():
    """Stochastic rounding raises, naming its ROADMAP item."""
    spec = QuantSpec(8, round_mode=RoundMode.STOCHASTIC)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        quantize_int(torch.ones(4, 4), spec)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _train_fake_quant(torch.ones(4, 4), spec)


def test_fake_quant_gradients_run_the_qdq_kernels(monkeypatch):
    """A fake-quant linear's G spec goes through kernels #1/#2 (here their
    plain versions, the tensors lying on the CPU), once per backward; a
    tensor on any other device than the CPU or a card is refused, never
    quietly run plain."""
    import repro_torch.kernels.ops as ops
    seen = []
    for name in ("qdq_row", "qdq_scaled"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda x, *a, _r=real, _n=name:
                            seen.append((_n, tuple(x.shape))) or _r(x, *a))
    x = torch.randn(2, 5, 16, requires_grad=True)
    w = torch.randn(16, 8, requires_grad=True)
    for recipe, kernel in (("w8c,a8t,g8t", "qdq_row"),
                           ("w8c,a8t,g8n", "qdq_scaled"),
                           ("w8c,a8t,g8c", "qdq_scaled")):
        seen.clear()
        from repro_torch.core.qlinear import quantized_linear
        quantized_linear(x, w, parse_recipe(recipe)).sum().backward()
        assert seen == [(kernel, (10, 8))], recipe
    from repro_torch.kernels import qdq_row
    with pytest.raises(ValueError, match="unsupported device"):
        qdq_row(torch.ones(4, 4, device="meta"))


def test_train_step_faults_and_health():
    """``faults=`` poisons the planned step and ``health=`` adds the
    sentinel's counters (their values against JAX in
    test_torch_train_system.py)."""
    from repro_torch.train.faults import FaultPlan
    cfg = tsmoke("gpt2-small")
    model = build_model(cfg)
    opt = OptConfig(state_storage="int")
    pol = parse_policy(MAIN.replace("int8_pallas", "int8_cuda"))
    state = train_state_from_jax(
        jax.tree_util.tree_map(np.asarray, j_init_train(
            jbuild(jsmoke("gpt2-small")), jax.random.PRNGKey(0),
            jparse_policy(MAIN), JOpt(state_storage="int"))), cfg,
        device="cpu")
    toks = torch.from_numpy(SyntheticCorpus(cfg.vocab_size, seed=7).batch(
        0, batch_size=2, seq_len=32))
    step = make_train_step(model, pol, opt,
                           faults=FaultPlan.parse("nan_grad@0"), health=True)
    _, m = step(state, {"tokens": toks})
    assert {"grad_sat", "grad_qerr", "grad_norm", "ce"} <= set(m)
    assert np.isnan(float(m["grad_norm"])) and np.isfinite(float(m["ce"]))
