"""Flash attention: over fp K/V for training and the fp-KV prefill, and
causal over the int8 KV cache for the int8-KV prefill of the serving path.

Over fp K/V, in the reference's ``(BH, S, d)`` layout (the ports of
``repro/kernels/flash_attn.py``; each launches ``csrc/flash_attn.cu`` on
CUDA tensors and runs its ``*_plain`` version on CPU tensors):

* :func:`flash_attention_fwd` -- ``flash_attention_fwd`` (#7);
* :func:`flash_attention_fwd_lse` -- ``_fwd_with_lse`` (#8), the output and
  the log-sum-exp rows;
* :func:`flash_attention_bwd_dkdv` and :func:`flash_attention_bwd_dq` --
  the two ``pallas_call`` of ``_fa_bwd`` (#9, #10);
* :func:`flash_attention` -- the ``flash_attention`` custom VJP as a
  ``torch.autograd.Function``: #8 forward, #9 and #10 backward.

Over the int8 cache: :func:`flash_attention_fwd_q8` launches
``csrc/flash_attn_q8.cu`` (the port of ``flash_attention_fwd_q8``, #11) and
runs :func:`flash_attention_fwd_q8_plain` on CPU tensors.  Both keep the
dequantized K/V in fp32, as the JAX kernel does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.int8_matmul import scale_guard

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
#: head dims of the fp flash kernels: every multiple of 16 up to 256
FLASH_MAX_HEAD_DIM = 256


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


def flash_attention_fwd_q8(q: torch.Tensor, kq: torch.Tensor,
                           ks: torch.Tensor, vq: torch.Tensor,
                           vs: torch.Tensor, *, causal: bool = True,
                           q_offset: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); kq/vq: (B, Skv, K, hd) int8; ks/vs: (B, Skv, K, 1)
    fp32 -> (B, Sq, H, hd) in q's dtype.  H % K == 0 (GQA/MQA); causal
    masking makes any never-written cache tail (rows >= q_offset + Sq)
    invisible.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    b, sq, h, hd, skv, kh = _check_args(q, kq, causal, q_offset)
    if q.device.type == "cpu":
        return flash_attention_fwd_q8_plain(q, kq, ks, vq, vs, causal=causal,
                                            q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd_q8: unsupported device {q.device}")
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
    out = torch.empty_like(q)
    lib = _build.load("flash_attn_q8")
    rc = lib.repro_flash_attn_q8(
        _build.ptr(q), _build.ptr(kq), _build.ptr(ks), _build.ptr(vq),
        _build.ptr(vs), _build.ptr(out), b, sq, skv, h, kh, hd,
        1.0 / math.sqrt(hd), int(causal), int(q_offset),
        _DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_fwd_q8")
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
    """Key rows per tile of the forward kernel at head dim ``d``
    (``Tiles<HDP>::BK`` in ``csrc/flash_attn.cu``): 64 up to d = 128, 32
    above."""
    return 64 if d <= 128 else 32


def flash_attention_fwd_lse_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, *, causal: bool = True,
                                  q_offset: int = 0,
                                  block_k: int | None = None):
    """Plain PyTorch version of #8: the scores materialized in fp32 in the
    forward's order (q scaled first, then the product), masked with -1e30,
    then the online-softmax recurrence over key tiles of ``block_k`` rows
    (default: the kernel's, :func:`kv_tile`): ``exp(s - m)`` against the
    running max m, rounded to v's type for the P.V product, divided by
    ``max(l, 1e-30)`` after it; lse = m + log(max(l, 1e-30)), fp32.  The
    tile width only moves that rounding of p (at float32 it changes sum
    orders alone); ``block_k >= Skv`` is the reference's ``_ref_attend``,
    which rounds p against the row's final max."""
    _, sq, skv, d = _check_flash("flash_attention_fwd_lse", q, k, v,
                                 q_offset)
    s = torch.einsum("bqd,bkd->bqk", q.float() * _scale(d), k.float())
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


def _bwd_plain(q, k, v, do, lse, delta, causal, q_offset):
    """p and ds of the backward, whole-matrix, in #9/#10's order: the
    scale after the product, p = exp(s - lse) in fp32."""
    sq, skv, d = q.shape[1], k.shape[1], q.shape[2]
    scale = _scale(d)
    s = scale * torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    if causal:
        s = s.masked_fill(~_causal_keep(sq, skv, q_offset, q.device), -1e30)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqd,bkd->bqk", do.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta, *,
                                   causal: bool = True, q_offset: int = 0):
    """Plain PyTorch version of #9: dV = p^T dO, dK = ds^T q, in q's type."""
    _check_flash("flash_attention_bwd_dkdv", q, k, v, q_offset,
                 _bwd_extra(q, do, lse, delta))
    p, ds = _bwd_plain(q, k, v, do, lse, delta, causal, q_offset)
    dv = torch.einsum("bqk,bqd->bkd", p, do.float())
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    return dk.to(q.dtype), dv.to(q.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, *,
                                 causal: bool = True,
                                 q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of #10: dQ = ds k, in q's type."""
    _check_flash("flash_attention_bwd_dq", q, k, v, q_offset,
                 _bwd_extra(q, do, lse, delta))
    _, ds = _bwd_plain(q, k, v, do, lse, delta, causal, q_offset)
    return torch.einsum("bqk,bkd->bqd", ds, k.float()).to(q.dtype)


def _launch_fwd(q, k, v, causal, q_offset, with_lse):
    bh, sq, skv, d = q.shape[0], q.shape[1], k.shape[1], q.shape[2]
    o = torch.empty_like(q)
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    lib = _build.load("flash_attn")
    rc = lib.repro_flash_attn_fwd(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
        _build.ptr(lse) if with_lse else None, bh, sq, skv, d, _scale(d),
        int(causal), int(q_offset), _DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_fwd" + ("_lse" if with_lse else ""))
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """#7: q (BH, Sq, d), k/v (BH, Skv, d) -> o (BH, Sq, d) in q's type;
    causal masking hides keys past ``q_offset`` + the query's position.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``#8``'s body without the LSE store) or raise."""
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
    type), lse and delta (BH, Sq) float32.  One block per key tile walks
    the query tiles; no atomics, so a launch repeats its bits."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkdv_plain(q, k, v, do, lse, delta,
                                              causal=causal,
                                              q_offset=q_offset)
    bh, sq, skv, d = _check_flash("flash_attention_bwd_dkdv", q, k, v,
                                  q_offset, _bwd_extra(q, do, lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load("flash_attn")
    rc = lib.repro_flash_attn_bwd_dkdv(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(dk), _build.ptr(dv),
        bh, sq, skv, d, _scale(d), int(causal), int(q_offset),
        _DTYPE_CODES[q.dtype], _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_bwd_dkdv")
    flash_attention_bwd_dkdv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           q_offset: int = 0) -> torch.Tensor:
    """#10: dQ (BH, Sq, d) in q's type from #9's inputs; one block per
    query tile walks the key tiles."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta,
                                            causal=causal, q_offset=q_offset)
    bh, sq, skv, d = _check_flash("flash_attention_bwd_dq", q, k, v,
                                  q_offset, _bwd_extra(q, do, lse, delta))
    dq = torch.empty_like(q)
    lib = _build.load("flash_attn")
    rc = lib.repro_flash_attn_bwd_dq(
        _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
        _build.ptr(lse), _build.ptr(delta), _build.ptr(dq), bh, sq, skv, d,
        _scale(d), int(causal), int(q_offset), _DTYPE_CODES[q.dtype],
        _build.stream_of(q))
    _build.check(lib, rc, "flash_attention_bwd_dq")
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
