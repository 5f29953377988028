"""Flash attention: over fp K/V for training and the fp-KV prefill, and
causal over the int8 KV cache for the int8-KV prefill of the serving path.

Over fp K/V, in the reference's ``(BH, S, d)`` layout (the ports of
``repro/kernels/flash_attn.py``; each launches a kernel on CUDA tensors --
at bfloat16 the forward ``csrc/flash_fwd_sm90.cu`` and the backward
``csrc/flash_bwd_sm90.cu`` (head dims 16-128) or
``csrc/flash_bwd_sm90_wide.cu`` (144-256), all on the tensor cores; at
float32 ``csrc/flash_attn.cu`` on the CUDA cores -- and runs its
``*_plain`` version on CPU tensors):

* :func:`flash_attention_fwd` -- ``flash_attention_fwd`` (#7);
* :func:`flash_attention_fwd_lse` -- ``_fwd_with_lse`` (#8), the output and
  the log-sum-exp rows;
* :func:`flash_attention_bwd_dkdv` and :func:`flash_attention_bwd_dq` --
  the two ``pallas_call`` of ``_fa_bwd`` (#9, #10);
* :func:`flash_attention` -- the ``flash_attention`` custom VJP as a
  ``torch.autograd.Function``: #8 forward, #9 and #10 backward.

Over the int8 cache: :func:`flash_attention_fwd_q8` (the port of
``flash_attention_fwd_q8``, #11) launches, at bfloat16,
``csrc/flash_q8_sm90.cu`` on the tensor cores and, at float32,
``csrc/flash_attn_q8.cu`` on the CUDA cores (:func:`q8_library`), and runs
:func:`flash_attention_fwd_q8_plain` on CPU tensors.  All three keep the
dequantized K/V and p * g(vs) in fp32, as the JAX kernel does (the
tensor-core kernel feeds fp32 values to the tensor cores as exact bf16
terms, :func:`bf16_terms`).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.int8_matmul import scale_guard

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims of #11's kernels (256 at the power-of-two scale 1/16 only on
#: the tensor-core kernel, which the wrapper always passes; 160, Zamba2's
#: shared block, padded to 192 columns there)
_HEAD_DIMS = (32, 64, 128, 160, 256)
#: head dims of the fp flash kernels: every multiple of 16 up to 256
FLASH_MAX_HEAD_DIM = 256
#: the largest head dim of the tensor-core backward
#: (``csrc/flash_bwd_sm90_wide.cu`` exports it as
#: ``repro_flash_bwd_sm90_wide_max_head_dim``)
FLASH_BWD_SM90_MAX_HEAD_DIM = 256
#: the largest head dim of ``csrc/flash_bwd_sm90.cu`` (exported as
#: ``repro_flash_bwd_max_head_dim``); above it the wide library
FLASH_BWD_SM90_NARROW_MAX_HEAD_DIM = 128


def _check_args(q, kq, causal, q_offset):
    b, sq, h, hd = q.shape
    if kq.dim() != 4 or kq.shape[0] != b or kq.shape[3] != hd:
        raise ValueError(f"flash_attention_fwd_q8: q {tuple(q.shape)} vs "
                         f"kq {tuple(kq.shape)}")
    skv, kh = kq.shape[1], kq.shape[2]
    if h % kh:
        raise ValueError(f"flash_attention_fwd_q8: {h} heads over {kh} kv heads")
    if not causal and skv != q_offset + sq:
        # nothing but the causal mask hides never-written cache rows (their
        # guarded scale-0 / payload-0 entries would otherwise enter the
        # softmax with exp(0) weight and dilute every output)
        raise ValueError(
            f"causal=False requires a fully written cache: Skv={skv} vs "
            f"q_offset+Sq={q_offset + sq}")
    return b, sq, h, hd, skv, kh


def flash_attention_fwd_q8_plain(q: torch.Tensor, kq: torch.Tensor,
                                 ks: torch.Tensor, vq: torch.Tensor,
                                 vs: torch.Tensor, *, causal: bool = True,
                                 q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version: dequantize-in-fp32 scores over the whole
    buffer, masked softmax in fp32, context cast to q's dtype."""
    b, sq, h, hd, skv, kh = _check_args(q, kq, causal, q_offset)
    g = h // kh
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(hd))).reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf, kq.to(torch.float32))
    s = s * scale_guard(ks)[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    if causal:
        qpos = torch.arange(sq, device=q.device) + q_offset
        kpos = torch.arange(skv, device=q.device)
        s = s.masked_fill(kpos[None, :] > qpos[:, None], -1e30)
    p = torch.softmax(s, dim=-1)
    p = p * scale_guard(vs)[..., 0].permute(0, 2, 1)[:, :, None, None, :]
    ctx = torch.einsum("bkgqt,btkd->bqkgd", p, vq.to(torch.float32))
    return ctx.reshape(b, sq, h, hd).to(q.dtype)


def q8_library(dtype: torch.dtype) -> str:
    """The library a CUDA call of #11 launches, by a fixed rule: bfloat16
    takes the tensor-core kernel (``"flash_q8_sm90"``); float32 the
    CUDA-core kernel (``"flash_attn_q8"``: TF32 would drop 13 bits of every
    operand and leave the float32 tolerance)."""
    return "flash_q8_sm90" if dtype == torch.bfloat16 else "flash_attn_q8"


def _check_q8_cuda(q, kq, ks, vq, vs, b, sq, h, hd, skv, kh):
    if q.dtype not in _DTYPE_CODES or hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd_q8: dtype {q.dtype}, head dim "
                         f"{hd} (kernel takes {list(_DTYPE_CODES)} and "
                         f"{_HEAD_DIMS})")
    for name, t, dt, shape in (("q", q, q.dtype, (b, sq, h, hd)),
                               ("kq", kq, torch.int8, (b, skv, kh, hd)),
                               ("vq", vq, torch.int8, (b, skv, kh, hd)),
                               ("ks", ks, torch.float32, (b, skv, kh, 1)),
                               ("vs", vs, torch.float32, (b, skv, kh, 1))):
        if (t.dtype != dt or t.device != q.device or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"flash_attention_fwd_q8: {name} must be a "
                             f"contiguous {dt} {shape} tensor on {q.device}")
    # the bf16 kernel reads q, kq and vq by TMA, which takes 16-byte bases
    for name, t in (("q", q), ("kq", kq), ("vq", vq)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention_fwd_q8: {name} must start on "
                             f"a 16-byte boundary (data_ptr "
                             f"{t.data_ptr():#x})")


def launch_q8(lib_name: str, q: torch.Tensor, kq: torch.Tensor,
              ks: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor, *,
              causal: bool = True, q_offset: int = 0,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """One launch of #11's kernel in the library ``lib_name`` on CUDA
    tensors, counted nowhere: what :func:`flash_attention_fwd_q8` runs, and
    the card's checks' way to time the CUDA-core body at bfloat16
    (``"flash_attn_q8"``) or to read the tensor-core kernel's output before
    its cast (``"flash_q8_sm90"``, ``out_dtype=torch.float32``).  Raises on
    what the kernel does not take and on a CUDA error."""
    b, sq, h, hd, skv, kh = _check_args(q, kq, causal, q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd_q8: unsupported device {q.device}")
    _check_q8_cuda(q, kq, ks, vq, vs, b, sq, h, hd, skv, kh)
    out_dtype = out_dtype or q.dtype
    if lib_name == "flash_q8_sm90" and q.dtype != torch.bfloat16:
        raise ValueError("flash_attention_fwd_q8: the tensor-core kernel "
                         "takes bfloat16 q")
    if lib_name == "flash_attn_q8" and out_dtype != q.dtype:
        raise ValueError("flash_attention_fwd_q8: the CUDA-core kernel "
                         "writes q's dtype")
    out = torch.empty((b, sq, h, hd), dtype=out_dtype, device=q.device)
    lib = _build.load(lib_name)
    entry = (lib.repro_flash_q8_sm90 if lib_name == "flash_q8_sm90"
             else lib.repro_flash_attn_q8)
    rc = entry(_build.ptr(q), _build.ptr(kq), _build.ptr(ks), _build.ptr(vq),
               _build.ptr(vs), _build.ptr(out), b, sq, skv, h, kh, hd,
               1.0 / math.sqrt(hd), int(causal), int(q_offset),
               _DTYPE_CODES[out_dtype], _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_fwd_q8")
    return out


def flash_attention_fwd_q8(q: torch.Tensor, kq: torch.Tensor,
                           ks: torch.Tensor, vq: torch.Tensor,
                           vs: torch.Tensor, *, causal: bool = True,
                           q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); kq/vq: (B, Skv, K, hd) int8; ks/vs: (B, Skv, K, 1)
    fp32 -> (B, Sq, H, hd) in q's dtype.  H % K == 0 (GQA/MQA); causal
    masking makes any never-written cache tail (rows >= q_offset + Sq)
    invisible.  CPU tensors take the plain version; CUDA tensors launch the
    kernel :func:`q8_library` names (hd in 32, 64, 128, 160, 256; q, kq and vq
    on 16-byte boundaries) or raise."""
    b, sq, h, hd, skv, kh = _check_args(q, kq, causal, q_offset)
    if q.device.type == "cpu":
        return flash_attention_fwd_q8_plain(q, kq, ks, vq, vs, causal=causal,
                                            q_offset=q_offset)
    out = launch_q8(q8_library(q.dtype), q, kq, ks, vq, vs, causal=causal,
                    q_offset=q_offset)
    flash_attention_fwd_q8.launches += 1
    return out


flash_attention_fwd_q8.launches = 0


# ---------------------------------------------------------------------------
# fp flash attention (#7-#10)
# ---------------------------------------------------------------------------

def _check_flash(what: str, q, k, v, q_offset: int, extra=()):
    """Shapes, dtypes, devices and contiguity of a fp flash call; ``extra``
    holds (name, tensor, dtype, shape) of the backward's further inputs.
    Returns (BH, Sq, Skv, d)."""
    if q.dim() != 3:
        raise ValueError(f"{what}: q must be (BH, Sq, d), got {tuple(q.shape)}")
    bh, sq, d = q.shape
    if k.dim() != 3 or k.shape[0] != bh or k.shape[2] != d:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    skv = k.shape[1]
    if d % 16 or not 16 <= d <= FLASH_MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d}; the kernels take multiples "
                         f"of 16 from 16 to {FLASH_MAX_HEAD_DIM}")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{what}: dtype {q.dtype} (kernels take "
                         f"{list(_DTYPE_CODES)})")
    if sq < 1 or skv < 1 or q_offset < 0:
        raise ValueError(f"{what}: Sq={sq}, Skv={skv}, q_offset={q_offset}")
    for name, t, dt, shape in (("q", q, q.dtype, (bh, sq, d)),
                               ("k", k, q.dtype, (bh, skv, d)),
                               ("v", v, q.dtype, (bh, skv, d)), *extra):
        if (t.dtype != dt or t.device != q.device or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{what}: {name} must be a contiguous {dt} "
                             f"{shape} tensor on {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {q.device}")
    if q.device.type == "cuda":
        # the bf16 kernels read q, k, v and dO by TMA, which takes 16-byte
        # bases
        for name, t, *_ in (("q", q), ("k", k), ("v", v), *extra):
            if t.data_ptr() % 16:
                raise ValueError(f"{what}: {name} must start on a 16-byte "
                                 f"boundary (data_ptr {t.data_ptr():#x})")
    return bh, sq, skv, d


def _bwd_extra(q, do, lse, delta):
    bh, sq, d = q.shape
    return (("do", do, q.dtype, (bh, sq, d)),
            ("lse", lse, torch.float32, (bh, sq)),
            ("delta", delta, torch.float32, (bh, sq)))


def _causal_keep(sq: int, skv: int, q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) boolean: key position <= q_offset + query position."""
    qpos = torch.arange(sq, device=device) + q_offset
    return torch.arange(skv, device=device)[None, :] <= qpos[:, None]


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def kv_tile(d: int) -> int:
    """Key rows per tile of the forward kernels at head dim ``d`` (``BK`` of
    ``Cfg`` in ``csrc/flash_fwd_sm90.cu``, which exports it as
    ``repro_flash_kv_tile``, and of ``Tiles`` in ``csrc/flash_attn.cu``): 64
    up to d = 128, 32 above.  At bfloat16 it is part of the function: p is
    rounded against the running max of each tile."""
    return 64 if d <= 128 else 32


def bf16_terms(x: torch.Tensor):
    """A float32 tensor as three bfloat16 terms, each as float32: hi =
    bf16(x), mid = bf16(x - hi) and lo = bf16(x - hi - mid), summing to x
    exactly while |x| >= 2**-110 (below, bf16's subnormal step of 2**-133
    drops bits of x, at most 2**-134).  A non-finite hi leaves mid = lo =
    0, so an inf or a NaN stays in hi.  Each product of a term with a bf16
    value is exact in fp32.  ``bf16_terms`` in ``csrc/sm90.cuh`` is the same
    formula: the tensor-core kernels split q (the forward) and p and ds (the
    backward) so."""
    x = x.float()
    hi = x.bfloat16().float()
    r = torch.where(hi.abs() <= torch.finfo(torch.float32).max, x - hi,
                    torch.zeros_like(x))
    mid = r.bfloat16().float()
    return hi, mid, (r - mid).bfloat16().float()


def bf16_q_terms(q: torch.Tensor, d: int):
    """The bfloat16 terms that the bf16 forward feeds the tensor cores in
    place of x = fl(q_f32 * scale), scale = 1/sqrt(d) in float32
    (``split_q`` in ``csrc/flash_fwd_sm90.cu``, the same formula), each as
    float32.  Where the scale is a power of two (d = 16, 64, 256) one term,
    hi = bf16(x), equal to x while |x| >= 2**-126 (below, at most 2**-134
    off); elsewhere :func:`bf16_terms` of x."""
    scale = torch.tensor(_scale(d), dtype=torch.float32)
    x = q.float() * scale
    if math.frexp(scale.item())[0] == 0.5:
        return (x.bfloat16().float(),)
    return bf16_terms(x)


def flash_attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  q_offset: int = 0,
                                  block_k: int | None = None,
                                  score_dtype: torch.dtype = torch.float64):
    """Plain PyTorch version of #8: the scores materialized in fp32 in the
    forward's order (q scaled first, then the product; the products summed
    in ``score_dtype`` and rounded to fp32 -- float64 by default, so the
    scores carry no fp32 summation order of their own), masked with -1e30,
    then the online-softmax recurrence over key tiles of ``block_k`` rows
    (default: the kernel's, :func:`kv_tile`): ``exp(s - m)`` against the
    running max m, rounded to v's type for the P.V product, divided by
    ``max(l, 1e-30)`` after it; lse = m + log(max(l, 1e-30)), fp32.  The
    tile width only moves that rounding of p (at float32 it changes sum
    orders alone); ``block_k >= Skv`` is the reference's ``_ref_attend``,
    which rounds p against the row's final max."""
    _, sq, skv, d = _check_flash("flash_attention_fwd_lse", q, k, v,
                                 q_offset)
    x = q.float() * _scale(d)
    s = torch.einsum("bqd,bkd->bqk", x.to(score_dtype),
                     k.to(score_dtype)).float()
    if causal:
        s = s.masked_fill(~_causal_keep(sq, skv, q_offset, q.device), -1e30)
    bk = block_k or kv_tile(d)
    m = torch.full_like(s[..., :1], -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q, dtype=torch.float32)
    for t0 in range(0, skv, bk):
        st = s[..., t0:t0 + bk]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        e = torch.exp(st - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + e.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bqk,bkd->bqd", e.to(v.dtype).float(), v[:, t0:t0 + bk].float())
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l).to(q.dtype), (m + torch.log(l))[..., 0]


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              q_offset: int = 0,
                              block_k: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of #7: #8's output without the LSE."""
    return flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                         q_offset=q_offset,
                                         block_k=block_k)[0]


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, sum_dtype):
    """einsum of a and b with the products summed in ``sum_dtype`` and the
    sums rounded to fp32."""
    return torch.einsum(eq, a.to(sum_dtype), b.to(sum_dtype)).float()


def _bwd_plain(q, k, v, do, lse, delta, causal, q_offset,
               sum_dtype: torch.dtype = torch.float64):
    """p and ds of the backward, whole-matrix, in #9/#10's order: the
    scale after the product, p = exp(s - lse) in fp32; q.k and dO.v summed
    in ``sum_dtype`` and rounded to fp32."""
    sq, skv, d = q.shape[1], k.shape[1], q.shape[2]
    scale = _scale(d)
    s = scale * _product("bqd,bkd->bqk", q, k, sum_dtype)
    if causal:
        s = s.masked_fill(~_causal_keep(sq, skv, q_offset, q.device), -1e30)
    p = torch.exp(s - lse[..., None])
    dp = _product("bqd,bkd->bqk", do, v, sum_dtype)
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, *,
                                   causal: bool = True, q_offset: int = 0,
                                   sum_dtype: torch.dtype = torch.float64):
    """Plain PyTorch version of #9: dV = p^T dO, dK = ds^T q, in q's type.
    Each of its four products (q.k, dO.v, p^T dO, ds^T q) is summed in
    ``sum_dtype`` and rounded to fp32 -- float64 by default, so that the
    sums carry no fp32 order of their own and the kernels are held to the
    function, not to another fp32 order."""
    _check_flash("flash_attention_bwd_dkdv", q, k, v, q_offset,
                 _bwd_extra(q, do, lse, delta))
    p, ds = _bwd_plain(q, k, v, do, lse, delta, causal, q_offset, sum_dtype)
    dv = _product("bqk,bqd->bkd", p, do, sum_dtype)
    dk = _product("bqk,bqd->bkd", ds, q, sum_dtype)
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *,
                                 causal: bool = True, q_offset: int = 0,
                                 sum_dtype: torch.dtype = torch.float64
                                 ) -> torch.Tensor:
    """Plain PyTorch version of #10: dQ = ds k, in q's type; q.k, dO.v and
    ds k summed in ``sum_dtype`` (as #9's plain version)."""
    _check_flash("flash_attention_bwd_dq", q, k, v, q_offset,
                 _bwd_extra(q, do, lse, delta))
    _, ds = _bwd_plain(q, k, v, do, lse, delta, causal, q_offset, sum_dtype)
    return _product("bqk,bkd->bqd", ds, k, sum_dtype).to(q.dtype)


#: the sums of the plain backward on the CPU path: fp32, the reference's
#: own (its dot_general sums in fp32).  Under the causal mask at q_offset 0
#: query row 0 sees key 0 alone, so dp_00 - delta_0 is zero in exact
#: arithmetic and dq's row 0 is the rounding noise of two sums of the same
#: products; fp32 sums keep that noise equal to JAX's on the CPU, where
#: float64 sums (the plain functions' default) would make it exactly 0.
CPU_SUM_DTYPE = torch.float32


def bwd_library(dtype: torch.dtype, d: int) -> str:
    """The library a CUDA backward call (#9, #10) launches, by a fixed rule:
    bfloat16 takes the tensor-core kernels, at head dims up to
    :data:`FLASH_BWD_SM90_NARROW_MAX_HEAD_DIM` ``"flash_bwd_sm90"`` and
    above it, up to :data:`FLASH_BWD_SM90_MAX_HEAD_DIM`,
    ``"flash_bwd_sm90_wide"`` (its two warpgroups split dK and dV, which
    together take d registers a thread); float32 (TF32 would leave the
    float32 tolerances) takes the CUDA-core kernels (``"flash_attn"``)."""
    if dtype != torch.bfloat16:
        return "flash_attn"
    if d <= FLASH_BWD_SM90_NARROW_MAX_HEAD_DIM:
        return "flash_bwd_sm90"
    return "flash_bwd_sm90_wide"


#: each backward library's prefix of its two entry points
_BWD_ENTRY = {"flash_bwd_sm90": "repro_flash_bwd_sm90_",
              "flash_bwd_sm90_wide": "repro_flash_bwd_sm90_wide_",
              "flash_attn": "repro_flash_attn_bwd_"}


def _launch_bwd(which: str, q, k, v, do, lse, delta, outs, causal,
                q_offset, library: str | None = None):
    """#9 (``which="dkdv"``, outs (dk, dv)) or #10 (``"dq"``, outs (dq,))
    through the library :func:`bwd_library` names, or ``library`` (the
    card's checks time ``flash_attn.cu``'s CUDA-core bodies at bfloat16 so;
    counted nowhere); raises on a CUDA error."""
    bh, sq, skv, d = q.shape[0], q.shape[1], k.shape[1], q.shape[2]
    name = library or bwd_library(q.dtype, d)
    lib = _build.load(name)
    args = [_build.ptr(t) for t in (q, k, v, do, lse, delta, *outs)]
    args += [bh, sq, skv, d, _scale(d), int(causal), int(q_offset)]
    # the CUDA-core entries take a dtype code, the tensor-core ones none
    code = (_DTYPE_CODES[q.dtype],) if name == "flash_attn" else ()
    rc = getattr(lib, _BWD_ENTRY[name] + which)(*args, *code,
                                                _build.stream_of(q))
    _build.check(lib, rc, f"flash_attention_bwd_{which}")


def _launch_fwd(q, k, v, causal, q_offset, with_lse):
    """bfloat16: the tensor-core kernel of ``csrc/flash_fwd_sm90.cu``;
    float32: the CUDA-core kernel of ``csrc/flash_attn.cu``."""
    bh, sq, skv, d = q.shape[0], q.shape[1], k.shape[1], q.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    args = (_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
            _build.ptr(lse) if with_lse else None, bh, sq, skv, d, _scale(d),
            int(causal), int(q_offset))
    if q.dtype == torch.bfloat16:
        lib = _build.load("flash_fwd_sm90")
        rc = lib.repro_flash_fwd_sm90(*args, _build.stream_of(q))
    else:
        lib = _build.load("flash_attn")
        rc = lib.repro_flash_attn_fwd(*args, _DTYPE_CODES[q.dtype],
                                      _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_fwd" + ("_lse" if with_lse else ""))
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """#7: q (BH, Sq, d), k/v (BH, Skv, d) -> o (BH, Sq, d) in q's type;
    causal masking hides keys past ``q_offset`` + the query's position.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``#8``'s body without the LSE store; at bfloat16 the tensor-core one)
    or raise."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal=causal,
                                         q_offset=q_offset)
    _check_flash("flash_attention_fwd", q, k, v, q_offset)
    o, _ = _launch_fwd(q, k, v, causal, q_offset, with_lse=False)
    flash_attention_fwd.launches += 1
    return o


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            q_offset: int = 0):
    """#8: as :func:`flash_attention_fwd`, and the log-sum-exp rows (BH,
    Sq) float32 that the backward reads."""
    if q.device.type == "cpu":
        return flash_attention_fwd_lse_plain(q, k, v, causal=causal,
                                             q_offset=q_offset)
    _check_flash("flash_attention_fwd_lse", q, k, v, q_offset)
    out = _launch_fwd(q, k, v, causal, q_offset, with_lse=True)
    flash_attention_fwd_lse.launches += 1
    return out


def flash_attention_bwd_dkdv(q, k, v, do, lse, delta, *, causal: bool = True,
                             q_offset: int = 0):
    """#9: (dK, dV), each (BH, Skv, d) in q's type, from q, k, v, dO (q's
    type), lse and delta (BH, Sq) float32.  CPU tensors take the plain version
    with fp32 sums (:data:`CPU_SUM_DTYPE`); CUDA tensors launch the kernel
    :func:`bwd_library` names (bfloat16: the tensor cores,
    ``csrc/flash_bwd_sm90.cu`` at d <= 128, ``csrc/flash_bwd_sm90_wide.cu``
    above; float32: ``csrc/flash_attn.cu``) or raise.  A block per key block
    walks the query tiles; no atomics, so a launch repeats its bits."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                              causal=causal,
                                              q_offset=q_offset,
                                              sum_dtype=CPU_SUM_DTYPE)
    _check_flash("flash_attention_bwd_dkdv", q, k, v, q_offset,
                 _bwd_extra(q, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch_bwd("dkdv", q, k, v, do, lse, delta, (dk, dv), causal, q_offset)
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           q_offset: int = 0) -> torch.Tensor:
    """#10: dQ (BH, Sq, d) in q's type from #9's inputs, the kernel chosen
    by the same rule (:func:`bwd_library`); a block per query block walks
    the key tiles."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                            causal=causal, q_offset=q_offset,
                                            sum_dtype=CPU_SUM_DTYPE)
    _check_flash("flash_attention_bwd_dq", q, k, v, q_offset,
                 _bwd_extra(q, do, lse, delta))
    dq = torch.empty_like(q)
    _launch_bwd("dq", q, k, v, do, lse, delta, (dq,), causal, q_offset)
    flash_attention_bwd_dq.launches += 1
    return dq


for _fn in (flash_attention_fwd, flash_attention_fwd_lse,
            flash_attention_bwd_dkdv, flash_attention_bwd_dq):
    _fn.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The reference's ``flash_attention`` custom VJP: the forward saves
    (q, k, v, o, lse) as ``_fa_fwd`` does; the backward computes delta =
    sum(g * o) in fp32 and casts g to q's type as ``_fa_bwd`` does, then
    runs #9 and #10.  The kernels are looked up at call time, so the
    device of the tensors picks kernel or plain version."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset):
        o, lse = flash_attention_fwd_lse(q, k, v, causal=causal,
                                         q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.q_offset = causal, q_offset
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        delta = (g.float() * o.float()).sum(-1)
        do = g.to(q.dtype).contiguous()
        kw = dict(causal=ctx.causal, q_offset=ctx.q_offset)
        dk, dv = flash_attention_bwd_dkdv(q, k, v, do, lse, delta, **kw)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Differentiable flash attention, q (BH, Sq, d) against k/v (BH, Skv,
    d) -> (BH, Sq, d): #8 forward, #9/#10 backward (their plain versions
    on CPU tensors)."""
    return _FlashAttention.apply(q, k, v, causal, q_offset)
