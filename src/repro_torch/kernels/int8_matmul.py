"""Int8 x int8 -> int32 matmuls with fused dequant epilogues: the three
layouts of a W8A8 linear's training step (paper Fig. 1).

* :func:`int8_matmul`    -- y  = Xq @ Wq   (forward), ``csrc/int8_matmul.cu``
* :func:`int8_matmul_nt` -- dx = Gq @ Wq^T (input gradient)
* :func:`int8_matmul_tn` -- dW = Xq^T @ Gq (weight gradient), both
  ``csrc/int8_matmul_bwd.cu``

(ports of ``repro/kernels/int8_matmul.py``).  Each wrapper launches its
kernel on CUDA tensors and runs its plain version on CPU tensors.  The
forward computes

    y[m, n] = ((float) sum_k x[m, k] * w[k, n]) * g(rs[m]) * g(cs[n])

with an exact integer sum and ``g`` mapping a 0 scale to 1, then casts to
the carrier -- bit for bit ``repro.kernels.ref.int8_matmul_ref``.  Up to
:data:`FWD_GEMV_MAX_M` rows (the decode step) it runs one kernel: a split-K
weight stream reduced in a thread-block cluster; :func:`int8_quant_matmul`
is the same kernel taking the fp activations and quantizing them per token
in its prologue, bit for bit ``quantize_int``.  Above, it transposes the
weight into a K-major payload and multiplies on the int8 tensor cores
(:func:`fwd_route`).  The transposed layouts take the
fp gradient, quantize it once into K-major int8 payloads and multiply those
on the int8 tensor cores (see their docstrings and the stages below); the
wrappers in ``kernels/ops.py`` reduce its scales.  The forward and the
backward share one GEMM (``csrc/gemm_s8.cuh``), with the scale per row,
per column or both.
"""
from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Optional

import torch

from repro_torch.kernels import _build

if TYPE_CHECKING:
    from repro_torch.core.qconfig import QuantSpec

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CARRIERS = tuple(_DTYPE_CODES)


def scale_guard(scale: torch.Tensor) -> torch.Tensor:
    """0-scale padding lanes -> 1.0 (their payloads are 0, so products stay
    0); the counterpart of ``repro.kernels.int8_matmul.scale_guard``."""
    scale = scale.to(torch.float32)
    return torch.where(scale == 0.0, torch.ones_like(scale), scale)


def _check_cuda(what: str, device, tensors) -> None:
    for name, t, dts in tensors:
        if (t.dtype not in dts or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"{' or '.join(map(str, dts))} tensor on "
                             f"{device}, got {t.dtype} on {t.device}")


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      row_scale: torch.Tensor, col_scale: torch.Tensor,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version.  The integer sum is exact: a float32 matmul is
    not at K = 3072 (|sum| <= 128*128*K ~ 5e7 > 2**24), so both devices sum
    in float64, exact below 2**53 (every K up to ``MAX_CONTRACTION``), and
    round the exact sum to float32 as an int32 sum would round (CUDA has no
    integer matmul; the CPU's int32 one is about 10x slower than its
    float64 one at a Yi-6B linear)."""
    acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    acc = acc.to(torch.float32)
    return ((acc * scale_guard(row_scale).reshape(-1, 1))
            * scale_guard(col_scale).reshape(1, -1)).to(out_dtype)


#: the cluster route's kernel (``csrc/int8_matmul.cu:gemv_s8_kernel``): 32
#: output columns a cluster, contraction splits of whole 32-row steps, at
#: most 8 blocks a cluster (the portable size)
GEMV_COLS, GEMV_STEP, GEMV_MAX_SPLITS = 32, 32, 8

#: the most rows the forward's cluster route takes -- one 16-row mma tile,
#: the decode step's 16 slots; more go to the int8 tensor cores.  Readings
#: at M = 16, 17, 32 and 64 (PERF.md) put the crossover between 17 and 32,
#: but no caller brings 17 to 31 rows (prefill and training bring
#: thousands), so the kernel holds one tile
FWD_GEMV_MAX_M = 16


def fwd_route(m: int, n: int, k: int) -> str:
    """The forward's route on the card for an (m, k) x (k, n) call:
    ``"gemv"`` (the decode step, M <= :data:`FWD_GEMV_MAX_M` rows: one
    launch, a split-K weight stream reduced in a thread-block cluster) or
    ``"wgmma"`` (the weight transposed into a K-major payload, then the int8
    tensor-core GEMM with both scales).  Both routes are kernels and give
    the same bits."""
    del n, k  # the crossover is a row count at GPT-2's widths
    return "gemv" if m <= FWD_GEMV_MAX_M else "wgmma"


def gemv_splits(k: int) -> int:
    """The cluster size the route takes for a contraction of k rows: as
    many splits as fill the card at GPT-2's widths, at most
    :data:`GEMV_MAX_SPLITS` and never more than k has 32-row steps."""
    return min(GEMV_MAX_SPLITS, -(-k // GEMV_STEP))


def _check_fwd(x, w, row_scale, col_scale, out_dtype):
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if row_scale.numel() != m or col_scale.numel() != n:
        raise ValueError(f"int8_matmul: scales {tuple(row_scale.shape)}, "
                         f"{tuple(col_scale.shape)} for ({m}, {n}) output")
    if not _on_card("int8_matmul", x):
        return m, n, k
    _check_cuda("int8_matmul", x.device, (
        ("x", x, (torch.int8,)), ("w", w, (torch.int8,)),
        ("row_scale", row_scale, (torch.float32,)),
        ("col_scale", col_scale, (torch.float32,))))
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul: unsupported out_dtype {out_dtype}")
    return m, n, k


def int8_matmul_dp4a(x: torch.Tensor, w: torch.Tensor,
                     row_scale: torch.Tensor, col_scale: torch.Tensor,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """The first CUDA-core (dp4a) kernel at any M, on no route: the
    yardstick the routes are timed against (a stage: no launch count).  CPU
    tensors take :func:`int8_matmul_plain`."""
    m, n, k = _check_fwd(x, w, row_scale, col_scale, out_dtype)
    if not x.is_cuda:
        return int8_matmul_plain(x, w, row_scale, col_scale, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    _run("repro_int8_matmul_dp4a", _build.ptr(x), _build.ptr(w),
         _build.ptr(row_scale), _build.ptr(col_scale), _build.ptr(out), m, n,
         k, _DTYPE_CODES[out_dtype], _build.stream_of(x))
    return out


_X_INT8 = 2          # the kernel's code for int8 activations


def _gemv(x, w, row_scale, col_scale, out_dtype, splits, bits):
    """Launch the cluster kernel on CUDA tensors already checked: x int8
    with ``row_scale`` (the int8 entry) or fp with ``row_scale`` None,
    quantized to ``bits`` in the kernel (the fused entry)."""
    m, k = x.shape
    n = w.shape[1]
    if not 0 < m <= FWD_GEMV_MAX_M:
        raise ValueError(f"int8 gemv: {m} rows outside [1, {FWD_GEMV_MAX_M}]")
    if k > MAX_CONTRACTION:
        raise ValueError(f"int8 gemv: contraction {k} > {MAX_CONTRACTION} "
                         f"(int32 sums)")
    splits = splits or gemv_splits(k)
    if not 0 < splits <= GEMV_MAX_SPLITS:
        raise ValueError(f"int8 gemv: {splits} splits outside "
                         f"[1, {GEMV_MAX_SPLITS}]")
    wk = kmajor_weight(w)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    x_code = _X_INT8 if x.dtype == torch.int8 else _DTYPE_CODES[x.dtype]
    _run("repro_int8_gemv", _build.ptr(x), _build.ptr(wk), _p(row_scale),
         _build.ptr(col_scale), _build.ptr(out), m, n, k, wk.stride(0),
         splits, x_code, _DTYPE_CODES[out_dtype], bits, _build.stream_of(x))
    return out


def int8_matmul_gemv(x: torch.Tensor, w: torch.Tensor,
                     row_scale: torch.Tensor, col_scale: torch.Tensor,
                     out_dtype=torch.bfloat16,
                     splits: Optional[int] = None) -> torch.Tensor:
    """The forward's cluster route (a stage: no launch count): M <=
    :data:`FWD_GEMV_MAX_M`, a cluster of ``splits`` blocks (default
    :func:`gemv_splits`) per 32 output columns, the products by
    ``mma.sync``; every split count gives the same bits.  CPU tensors take
    :func:`int8_matmul_plain`."""
    _check_fwd(x, w, row_scale, col_scale, out_dtype)
    if not x.is_cuda:
        return int8_matmul_plain(x, w, row_scale, col_scale, out_dtype)
    return _gemv(x, w, row_scale, col_scale, out_dtype, splits, 8)


def int8_matmul_wgmma(x: torch.Tensor, w: torch.Tensor,
                      row_scale: torch.Tensor, col_scale: torch.Tensor,
                      out_dtype=torch.bfloat16,
                      splits: Optional[int] = None) -> torch.Tensor:
    """The forward's tensor-core route at any M (a stage: no launch count):
    w transposed into (N, pad16(K)), then the GEMM with both scales, split
    ``splits`` ways (default :func:`gemm_splits`) over the contraction.
    CPU tensors take :func:`int8_matmul_plain`."""
    m, n, k = _check_fwd(x, w, row_scale, col_scale, out_dtype)
    if not x.is_cuda:
        return int8_matmul_plain(x, w, row_scale, col_scale, out_dtype)
    if k > MAX_CONTRACTION:
        raise ValueError(f"int8_matmul: contraction {k} > {MAX_CONTRACTION} "
                         f"(int32 sums)")
    splits = splits or gemm_splits(m, n, k)
    _split_bounds(k, splits)
    xk = kmajor_weight(x)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    wt = torch.empty((n, _pad16(k)), dtype=torch.int8, device=x.device)
    ws = _workspace(splits, m, n, x.device)
    _run("repro_int8_matmul_wgmma", _build.ptr(xk), _build.ptr(w),
         _build.ptr(row_scale), _build.ptr(col_scale), _build.ptr(out),
         _build.ptr(wt), _p(ws), m, n, k, xk.stride(0), splits,
         _DTYPE_CODES[out_dtype], _build.stream_of(x))
    return out


def int8_matmul(x: torch.Tensor, w: torch.Tensor, row_scale: torch.Tensor,
                col_scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x: int8 (M, K); w: int8 (K, N); row_scale fp32 (M, 1) or (M,);
    col_scale fp32 (1, N) or (N,) -> (M, N) ``out_dtype``.

    CPU tensors take :func:`int8_matmul_plain`; CUDA tensors launch the
    kernels of the route :func:`fwd_route` names (any M, N and K up to
    ``MAX_CONTRACTION``) or raise.  A call is one launch on the counter,
    whatever kernels its route runs."""
    m, n, k = _check_fwd(x, w, row_scale, col_scale, out_dtype)
    if not x.is_cuda:
        return int8_matmul_plain(x, w, row_scale, col_scale, out_dtype)
    route = (int8_matmul_gemv if fwd_route(m, n, k) == "gemv"
             else int8_matmul_wgmma)
    out = route(x, w, row_scale, col_scale, out_dtype)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def quant_fwd_eligible(spec: "QuantSpec") -> bool:
    """Does :func:`int8_quant_matmul`'s prologue compute ``quantize_int(x,
    spec)`` exactly?  Per token, symmetric, nearest rounding, no blocks, no
    sqrt domain, 8 bits or fewer."""
    # imported here: repro_torch.core imports the kernels' wrappers
    from repro_torch.core.qconfig import Granularity, RoundMode
    return (spec.granularity is Granularity.PER_TOKEN and spec.symmetric
            and spec.round_mode is RoundMode.NEAREST and spec.block_size == 0
            and not spec.sqrt_domain and spec.bits <= 8)


def takes_quant_fwd(x: torch.Tensor, spec: "QuantSpec", out_dtype) -> bool:
    """Does a linear on the fp activations x (M, K) take the fused entry?
    On the card, a spec it computes exactly, a carrier in and out, and M
    within the cluster route (:func:`fwd_route`)."""
    return (x.is_cuda and quant_fwd_eligible(spec) and x.dtype in _CARRIERS
            and out_dtype in _DTYPE_CODES
            and fwd_route(x.shape[0], 0, x.shape[1]) == "gemv")


def _col_scale(w_scale: torch.Tensor, n: int) -> torch.Tensor:
    """A per-channel (1, N) or per-tensor (1, 1) weight scale as the N
    contiguous float32 the kernels read: the tensor itself where it already
    is that (a prepared weight's scale; no op, so no host time)."""
    if (w_scale.dtype == torch.float32 and w_scale.numel() == n
            and w_scale.is_contiguous()):
        return w_scale
    return w_scale.to(torch.float32).reshape(1, -1).expand(1, n).contiguous()


def int8_quant_matmul_plain(x: torch.Tensor, wq: torch.Tensor,
                            w_scale: torch.Tensor, a_spec: "QuantSpec",
                            out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of :func:`int8_quant_matmul`: ``quantize_int`` of x,
    then :func:`int8_matmul_plain` (``ops.int8_payload_linear``'s
    arithmetic)."""
    from repro_torch.core.quantizer import quantize_int
    xq, scale, _ = quantize_int(x, a_spec)
    return int8_matmul_plain(xq, wq, scale, _col_scale(w_scale, wq.shape[1]),
                             out_dtype)


def int8_quant_matmul(x: torch.Tensor, wq: torch.Tensor,
                      w_scale: torch.Tensor, a_spec: "QuantSpec",
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """The decode linear in one launch: x fp32 / bf16 (M, K), M <=
    :data:`FWD_GEMV_MAX_M`; wq int8 (K, N), w_scale fp32 (1, N) or (1, 1) ->
    (M, N) ``out_dtype``, equal bit for bit to ``quantize_int(x, a_spec)``
    followed by :func:`int8_matmul` (:func:`int8_quant_matmul_plain`).

    The cluster kernel quantizes x per token in its prologue: each block's
    partial row absmax, their max through distributed shared memory, scale =
    max(absmax, 1e-12) / qmax, payload clamp(rint(x / scale)); a NaN or an
    infinity in a row reaches its outputs as in the plain version.  ``a_spec``
    must satisfy :func:`quant_fwd_eligible`, or this raises.  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise.  A call
    adds one to ``int8_matmul.launches``."""
    if not quant_fwd_eligible(a_spec):
        raise ValueError(f"int8_quant_matmul: [{a_spec.describe()}] is not "
                         f"per-token, symmetric, nearest, unblocked <= 8 bits")
    m, k = x.shape
    k2, n = wq.shape
    if k != k2 or w_scale.numel() not in (1, n):
        raise ValueError(f"int8_quant_matmul: x {tuple(x.shape)}, wq "
                         f"{tuple(wq.shape)}, w_scale {tuple(w_scale.shape)}")
    if not _on_card("int8_quant_matmul", x):
        return int8_quant_matmul_plain(x, wq, w_scale, a_spec, out_dtype)
    cs = _col_scale(w_scale, n)
    _check_cuda("int8_quant_matmul", x.device, (
        ("x", x, _CARRIERS), ("wq", wq, (torch.int8,)),
        ("w_scale", cs, (torch.float32,))))
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_quant_matmul: unsupported out_dtype "
                         f"{out_dtype}")
    out = _gemv(x, wq, None, cs, out_dtype, None, a_spec.bits)
    int8_matmul.launches += 1
    return out


def _exact_matmul(a: torch.Tensor, b: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """The exact integer product of two integer-valued tensors, cast to
    ``dtype``: int32 on the CPU, float64 on the card (no CUDA integer
    matmul; float64 is exact below 2**53, float32 only below 2**24)."""
    if a.is_cuda:
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)
                            ).to(dtype)
    return torch.matmul(a.to(torch.int32), b.to(torch.int32)).to(dtype)


def _quant_grad(g: torch.Tensor, fold: torch.Tensor,
                q_scale: torch.Tensor) -> torch.Tensor:
    """The kernels' gradient-quant prologue: clip(round(g * fold / qs)),
    half to even, with IEEE divisions by a tensor (qs already guarded)."""
    h = g.to(torch.float32) * fold
    return torch.clamp(torch.round(h / q_scale), -128, 127)


def int8_matmul_nt_plain(g: torch.Tensor, w: torch.Tensor,
                         fold_scale: torch.Tensor, q_scale: torch.Tensor,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_matmul_nt`."""
    qs = scale_guard(q_scale).reshape(-1, 1)
    hq = _quant_grad(g, fold_scale.to(torch.float32).reshape(1, -1), qs)
    return (_exact_matmul(hq, w.t()) * qs).to(out_dtype)


def int8_matmul_tn_plain(x: torch.Tensor, g: torch.Tensor,
                         fold_scale: torch.Tensor, q_scale: torch.Tensor,
                         out_dtype=torch.float32) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_matmul_tn`."""
    qs = scale_guard(q_scale).reshape(1, -1)
    hq = _quant_grad(g, fold_scale.to(torch.float32).reshape(-1, 1), qs)
    return (_exact_matmul(x.t(), hq) * qs).to(out_dtype)


# ---------------------------------------------------------------------------
# The backward's stages.  On the card each wrapper call runs: a quantize pass
# that writes K-major int8 payloads once (nt: gq = quant_rows_packed; tn: xT
# and gqT = pack_tn), then one int8 tensor-core GEMM of two K-major
# operands with a rank-1 epilogue (int8_gemm_kmajor), split over the
# contraction where the output tiles cannot fill the card
# (int8_gemm_partials + int8_split_reduce).  Each stage
# launches its kernel on CUDA tensors and runs its plain version on CPU
# tensors; the tests hold each kernel to its plain stage and the plain
# stages' composition to int8_matmul_nt_plain / int8_matmul_tn_plain.
# ---------------------------------------------------------------------------

#: contraction bytes per GEMM step, and the longest contraction whose int32
#: sum is exact (|sum| <= 128 * 128 * contraction < 2**31)
GEMM_STEP = 128
MAX_CONTRACTION = 131071


def _pad16(n: int) -> int:
    """Row length in bytes of a packed payload: TMA strides are multiples of
    16 bytes."""
    return n + (-n) % 16


def quant_rows_packed_plain(g: torch.Tensor, fold: torch.Tensor,
                            q_scale: torch.Tensor) -> torch.Tensor:
    """nt's quantize pass: (M, pad16(N)) int8, row m of it
    clip(round(g[m] * fold / g(qs[m]))) and zeros past N."""
    n = g.shape[1]
    hq = _quant_grad(g, fold.to(torch.float32).reshape(1, -1),
                     scale_guard(q_scale).reshape(-1, 1)).to(torch.int8)
    return torch.nn.functional.pad(hq, (0, _pad16(n) - n))


def quant_cols_packed_t_plain(g: torch.Tensor, fold: torch.Tensor,
                              q_scale: torch.Tensor) -> torch.Tensor:
    """tn's gradient pass: (N, pad16(M)) int8, its [n, m] =
    clip(round(g[m, n] * fold[m] / g(qs[n]))) and zeros past M."""
    m = g.shape[0]
    hq = _quant_grad(g, fold.to(torch.float32).reshape(-1, 1),
                     scale_guard(q_scale).reshape(1, -1)).to(torch.int8)
    return torch.nn.functional.pad(hq.t(), (0, _pad16(m) - m)).contiguous()


def transpose_packed_plain(x: torch.Tensor) -> torch.Tensor:
    """tn's activation pass: x (M, K) int8 -> (K, pad16(M)), zeros past M."""
    m = x.shape[0]
    return torch.nn.functional.pad(x.t(), (0, _pad16(m) - m)).contiguous()


def _split_bounds(kc: int, splits: int):
    """The contraction ranges of ``splits`` splits: blocks of whole
    ``GEMM_STEP``-byte steps, none empty (as the kernel cuts them)."""
    steps = -(-kc // GEMM_STEP)
    per = -(-steps // splits) if splits >= 1 else 0
    if per < 1 or -(-steps // per) != splits:
        raise ValueError(f"{splits} splits of a contraction of {kc}")
    return [(s * per * GEMM_STEP, min((s + 1) * per * GEMM_STEP, kc))
            for s in range(splits)]


def _scale_of(scale: torch.Tensor, row_scale: bool) -> torch.Tensor:
    s = scale_guard(scale)
    return s.reshape(-1, 1) if row_scale else s.reshape(1, -1)


def int8_gemm_partials_plain(a: torch.Tensor, b: torch.Tensor, kc: int,
                             splits: int) -> torch.Tensor:
    """Each split's exact int32 sums: (splits, R, C), [s, i, j] = the sum
    of a[i, k] * b[j, k] over split s's contraction range."""
    return torch.stack([
        _exact_matmul(a[:, lo:hi], b[:, lo:hi].t(), torch.float64
                      ).to(torch.int32)
        for lo, hi in _split_bounds(kc, splits)])


def int8_split_reduce_plain(ws: torch.Tensor, scale: torch.Tensor,
                            row_scale: bool,
                            out_dtype=torch.float32) -> torch.Tensor:
    """cast(float(sum of the splits) * g(scale)), the scale per row or per
    column of the (R, C) output."""
    acc = ws.to(torch.int64).sum(dim=0).to(torch.float32)
    return (acc * _scale_of(scale, row_scale)).to(out_dtype)


def int8_gemm_kmajor_plain(a: torch.Tensor, b: torch.Tensor,
                           scale: torch.Tensor, kc: int, row_scale: bool,
                           out_dtype=torch.float32) -> torch.Tensor:
    """C[i, j] = cast(float(sum_{k < kc} a[i, k] * b[j, k]) * g(s)) for two
    K-major int8 operands a (R, >= kc) and b (C, >= kc), s = scale[i]
    (``row_scale``) or scale[j]."""
    return (_exact_matmul(a[:, :kc], b[:, :kc].t())
            * _scale_of(scale, row_scale)).to(out_dtype)


def _dequant_fwd(acc: torch.Tensor, rs: torch.Tensor, cs: torch.Tensor,
                 out_dtype) -> torch.Tensor:
    """The forward's epilogue on an fp32 sum: (acc * g(rs)) * g(cs), two
    roundings in that order, then the cast."""
    return ((acc * _scale_of(rs, True)) * _scale_of(cs, False)).to(out_dtype)


def int8_gemm_fwd_plain(a: torch.Tensor, b: torch.Tensor, rs: torch.Tensor,
                        cs: torch.Tensor, kc: int,
                        out_dtype=torch.bfloat16) -> torch.Tensor:
    """The forward's GEMM of two K-major int8 operands a (R, >= kc) and b
    (C, >= kc): C[i, j] = cast((float(sum_{k < kc} a[i, k] b[j, k]) *
    g(rs[i])) * g(cs[j]))."""
    return _dequant_fwd(_exact_matmul(a[:, :kc], b[:, :kc].t()), rs, cs,
                        out_dtype)


def int8_split_reduce_fwd_plain(ws: torch.Tensor, rs: torch.Tensor,
                                cs: torch.Tensor,
                                out_dtype=torch.bfloat16) -> torch.Tensor:
    """The forward's split reduction: the splits' exact sum, then
    :func:`int8_gemm_fwd_plain`'s epilogue."""
    acc = ws.to(torch.int64).sum(dim=0).to(torch.float32)
    return _dequant_fwd(acc, rs, cs, out_dtype)


_ENTRIES = {}        # C entry point -> (its library, the function)


def _run(entry: str, *args) -> None:
    """Call the C entry point ``entry`` of the library that exports it (the
    forward's or the backward's, ``_build.SIGNATURES``); raise on a CUDA
    error.  Each entry is looked up once (a decode step makes 72 calls)."""
    found = _ENTRIES.get(entry)
    if found is None:
        lib = _build.load(next(n for n, sig in _build.SIGNATURES.items()
                               if entry in sig))
        found = _ENTRIES[entry] = (lib, getattr(lib, entry))
    lib, fn = found
    _build.check(lib, fn(*args), entry)


def _p(t: Optional[torch.Tensor]):
    return _build.ptr(t) if t is not None else None


@functools.lru_cache(maxsize=None)
def gemm_splits(r: int, c: int, kc: int) -> int:
    """The split count the card's GEMM takes for an (r, c) output over a
    contraction of ``kc`` (a function of the shapes and the SM count; the
    forward's and the backward's libraries share it, ``csrc/gemm_s8.cuh``)."""
    lib = _build.load("int8_matmul")
    return int(lib.repro_int8_gemm_splits(r, c, kc))


def _on_card(what: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one;
    any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return False


def _check_kmajor(what: str, dev, ops, kc: int) -> None:
    _check_cuda(what, dev, [(n, t, (torch.int8,)) for n, t in ops])
    for name, t in ops:
        if (t.stride(0) % 16 or t.data_ptr() % 16 or t.shape[1] < kc):
            raise ValueError(f"{what}: {name} must hold rows of >= {kc} "
                             f"bytes, 16 bytes apart and 16-byte aligned")
    if not 0 < kc <= MAX_CONTRACTION:
        raise ValueError(f"{what}: contraction {kc} outside "
                         f"[1, {MAX_CONTRACTION}]")


def quant_rows_packed(g: torch.Tensor, fold: torch.Tensor,
                      q_scale: torch.Tensor) -> torch.Tensor:
    """nt's quantize pass (see :func:`quant_rows_packed_plain`)."""
    if not _on_card("quant_rows_packed", g):
        return quant_rows_packed_plain(g, fold, q_scale)
    m, n = g.shape
    _check_cuda("quant_rows_packed", g.device, (
        ("g", g, _CARRIERS), ("fold", fold, (torch.float32,)),
        ("q_scale", q_scale, (torch.float32,))))
    if fold.numel() != n or q_scale.numel() != m:
        raise ValueError(f"quant_rows_packed: fold {tuple(fold.shape)}, "
                         f"q_scale {tuple(q_scale.shape)} for g {(m, n)}")
    gq = torch.empty((m, _pad16(n)), dtype=torch.int8, device=g.device)
    _run("repro_int8_quant_rows", _build.ptr(g), _build.ptr(fold),
         _build.ptr(q_scale), _build.ptr(gq), m, n, _DTYPE_CODES[g.dtype],
         _build.stream_of(g))
    return gq


def pack_tn(x: torch.Tensor, g: torch.Tensor, fold: torch.Tensor,
            q_scale: torch.Tensor):
    """tn's pass, one launch on the card: (:func:`transpose_packed_plain`
    of x, :func:`quant_cols_packed_t_plain` of g)."""
    if not _on_card("pack_tn", g):
        return (transpose_packed_plain(x),
                quant_cols_packed_t_plain(g, fold, q_scale))
    m, n = g.shape
    k = x.shape[1]
    _check_cuda("pack_tn", g.device, (
        ("x", x, (torch.int8,)), ("g", g, _CARRIERS),
        ("fold", fold, (torch.float32,)),
        ("q_scale", q_scale, (torch.float32,))))
    if x.shape[0] != m or fold.numel() != m or q_scale.numel() != n:
        raise ValueError(f"pack_tn: x {tuple(x.shape)}, g {tuple(g.shape)}, "
                         f"fold {tuple(fold.shape)}, q_scale "
                         f"{tuple(q_scale.shape)}")
    xt = torch.empty((k, _pad16(m)), dtype=torch.int8, device=g.device)
    gt = torch.empty((n, _pad16(m)), dtype=torch.int8, device=g.device)
    _run("repro_int8_pack_tn", _build.ptr(x), _build.ptr(g), _build.ptr(fold),
         _build.ptr(q_scale), _build.ptr(xt), _build.ptr(gt), m, n, k,
         _DTYPE_CODES[g.dtype], _build.stream_of(g))
    return xt, gt


def int8_gemm_partials(a: torch.Tensor, b: torch.Tensor, kc: int,
                       splits: int) -> torch.Tensor:
    """The split GEMM's first kernel (see
    :func:`int8_gemm_partials_plain`); splits >= 2 on the card."""
    if not _on_card("int8_gemm_partials", a):
        return int8_gemm_partials_plain(a, b, kc, splits)
    _check_kmajor("int8_gemm_partials", a.device, (("a", a), ("b", b)), kc)
    _split_bounds(kc, splits)
    if splits < 2:
        raise ValueError("int8_gemm_partials: takes 2 splits or more")
    r, c = a.shape[0], b.shape[0]
    ws = torch.empty((splits, r, c), dtype=torch.int32, device=a.device)
    _run("repro_int8_gemm", _build.ptr(a), _build.ptr(b), None, None,
         _build.ptr(ws), r, c, kc, a.stride(0), b.stride(0), 1, splits,
         _DTYPE_CODES[torch.float32], _build.stream_of(a))
    return ws


def int8_split_reduce(ws: torch.Tensor, scale: torch.Tensor, row_scale: bool,
                      out_dtype=torch.float32) -> torch.Tensor:
    """The split GEMM's second kernel (see :func:`int8_split_reduce_plain`)."""
    if not _on_card("int8_split_reduce", ws):
        return int8_split_reduce_plain(ws, scale, row_scale, out_dtype)
    s, r, c = ws.shape
    _check_cuda("int8_split_reduce", ws.device, (
        ("ws", ws, (torch.int32,)), ("scale", scale, (torch.float32,))))
    if scale.numel() != (r if row_scale else c) or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_split_reduce: scale {tuple(scale.shape)} or "
                         f"out_dtype {out_dtype} for a ({r}, {c}) output")
    out = torch.empty((r, c), dtype=out_dtype, device=ws.device)
    _run("repro_int8_split_reduce", _build.ptr(ws), _build.ptr(scale),
         _build.ptr(out), r, c, s, int(row_scale), _DTYPE_CODES[out_dtype],
         _build.stream_of(ws))
    return out


def int8_gemm_kmajor(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor,
                     kc: int, row_scale: bool, out_dtype=torch.float32,
                     splits: Optional[int] = None) -> torch.Tensor:
    """The GEMM of two K-major int8 operands with its rank-1 epilogue (see
    :func:`int8_gemm_kmajor_plain`).  On the card: one kernel, or with
    ``splits`` > 1 (default :func:`gemm_splits`) the partials and their
    reduction; every split count gives the same bits."""
    if not _on_card("int8_gemm_kmajor", a):
        return int8_gemm_kmajor_plain(a, b, scale, kc, row_scale, out_dtype)
    r, c = a.shape[0], b.shape[0]
    splits = splits or gemm_splits(r, c, kc)
    if splits > 1:
        return int8_split_reduce(int8_gemm_partials(a, b, kc, splits), scale,
                                 row_scale, out_dtype)
    _check_kmajor("int8_gemm_kmajor", a.device, (("a", a), ("b", b)), kc)
    _check_cuda("int8_gemm_kmajor", a.device,
                (("scale", scale, (torch.float32,)),))
    if scale.numel() != (r if row_scale else c) or out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_gemm_kmajor: scale {tuple(scale.shape)} or "
                         f"out_dtype {out_dtype} for a ({r}, {c}) output")
    out = torch.empty((r, c), dtype=out_dtype, device=a.device)
    _run("repro_int8_gemm", _build.ptr(a), _build.ptr(b), _build.ptr(scale),
         _build.ptr(out), None, r, c, kc, a.stride(0), b.stride(0),
         int(row_scale), 1, _DTYPE_CODES[out_dtype], _build.stream_of(a))
    return out


def transpose_packed(x: torch.Tensor) -> torch.Tensor:
    """The forward's transpose pass (see :func:`transpose_packed_plain`): w
    (K, N) -> (N, pad16(K)), one launch on the card."""
    if not _on_card("transpose_packed", x):
        return transpose_packed_plain(x)
    _check_cuda("transpose_packed", x.device, (("x", x, (torch.int8,)),))
    r, c = x.shape
    out = torch.empty((c, _pad16(r)), dtype=torch.int8, device=x.device)
    _run("repro_int8_transpose", _build.ptr(x), _build.ptr(out), r, c,
             _build.stream_of(x))
    return out


def _check_fwd_scales(what, a, b, rs, cs, out_dtype):
    _check_cuda(what, a.device, (("rs", rs, (torch.float32,)),
                                 ("cs", cs, (torch.float32,))))
    if (rs.numel() != a.shape[0] or cs.numel() != b.shape[0]
            or out_dtype not in _DTYPE_CODES):
        raise ValueError(f"{what}: rs {tuple(rs.shape)}, cs {tuple(cs.shape)}"
                         f" or out_dtype {out_dtype} for a "
                         f"({a.shape[0]}, {b.shape[0]}) output")


def int8_split_reduce_fwd(ws: torch.Tensor, rs: torch.Tensor,
                          cs: torch.Tensor,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    """The forward's split reduction (see
    :func:`int8_split_reduce_fwd_plain`), one launch on the card."""
    if not _on_card("int8_split_reduce_fwd", ws):
        return int8_split_reduce_fwd_plain(ws, rs, cs, out_dtype)
    s, r, c = ws.shape
    _check_cuda("int8_split_reduce_fwd", ws.device,
                (("ws", ws, (torch.int32,)),))
    _check_fwd_scales("int8_split_reduce_fwd", ws[0], ws[0].t(), rs, cs,
                      out_dtype)
    out = torch.empty((r, c), dtype=out_dtype, device=ws.device)
    _run("repro_int8_split_reduce_fwd", _build.ptr(ws), _build.ptr(rs),
             _build.ptr(cs), _build.ptr(out), r, c, s,
             _DTYPE_CODES[out_dtype], _build.stream_of(ws))
    return out


def int8_gemm_fwd(a: torch.Tensor, b: torch.Tensor, rs: torch.Tensor,
                  cs: torch.Tensor, kc: int, out_dtype=torch.bfloat16,
                  splits: Optional[int] = None) -> torch.Tensor:
    """The forward's GEMM of two K-major int8 operands with both scales (see
    :func:`int8_gemm_fwd_plain`).  On the card: one kernel, or with
    ``splits`` > 1 (default :func:`gemm_splits`) the partials and their
    reduction (two kernels); every split count gives the same bits."""
    if not _on_card("int8_gemm_fwd", a):
        return int8_gemm_fwd_plain(a, b, rs, cs, kc, out_dtype)
    _check_kmajor("int8_gemm_fwd", a.device, (("a", a), ("b", b)), kc)
    _check_fwd_scales("int8_gemm_fwd", a, b, rs, cs, out_dtype)
    r, c = a.shape[0], b.shape[0]
    splits = splits or gemm_splits(r, c, kc)
    _split_bounds(kc, splits)
    if splits > 1:
        ws = torch.empty((splits, r, c), dtype=torch.int32, device=a.device)
        _run("repro_int8_gemm_fwd", _build.ptr(a), _build.ptr(b), None,
                 None, None, _build.ptr(ws), r, c, kc, a.stride(0),
                 b.stride(0), splits, _DTYPE_CODES[torch.float32],
                 _build.stream_of(a))
        return int8_split_reduce_fwd(ws, rs, cs, out_dtype)
    out = torch.empty((r, c), dtype=out_dtype, device=a.device)
    _run("repro_int8_gemm_fwd", _build.ptr(a), _build.ptr(b),
             _build.ptr(rs), _build.ptr(cs), _build.ptr(out), None, r, c, kc,
             a.stride(0), b.stride(0), 1, _DTYPE_CODES[out_dtype],
             _build.stream_of(a))
    return out


def _workspace(splits: int, r: int, c: int, dev) -> Optional[torch.Tensor]:
    return (torch.empty((splits, r, c), dtype=torch.int32, device=dev)
            if splits > 1 else None)


def kmajor_weight(w: torch.Tensor) -> torch.Tensor:
    """A K-major int8 operand as the GEMM reads it (nt's weight w (K, N),
    the forward's activation x (M, K)): the tensor itself when its rows are
    a multiple of 16 bytes long and it starts 16-byte aligned (GPT-2's 768
    and 3072), else one zero-padded copy (rows, pad16(inner))."""
    k, n = w.shape
    if n % 16 == 0 and w.data_ptr() % 16 == 0:
        return w
    return torch.nn.functional.pad(w, (0, _pad16(n) - n))


def int8_matmul_nt(g: torch.Tensor, w: torch.Tensor, fold_scale: torch.Tensor,
                   q_scale: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """dx = qdq_token(g * fold_scale) @ w^T with real int8 compute.

    g: fp32/bf16 (M, N) output gradient; w: int8 (K, N) stored forward
    payload; fold_scale fp32 (N,) or (1, N) -- the weight's dequant scales;
    q_scale fp32 (M,) or (M, 1) -- the per-token quant scale of g * fold
    (absmax / 127, from ``kernels/ops.int8_bwd_dx``) -> (M, K) ``out_dtype``:

        dx[m, k] = g(qs[m]) * sum_n clip(round(g[m, n] * fold[n] / g(qs[m])))
                   * w[k, n]

    CPU tensors take :func:`int8_matmul_nt_plain`; CUDA tensors launch the
    kernel (any M, K and N up to ``MAX_CONTRACTION``) or raise: one quantize
    pass into a packed (M, pad16(N)) int8 buffer, then the int8 GEMM.  Where
    N is not a multiple of 16 (or ``w`` does not start 16-byte aligned) the
    GEMM reads one zero-padded copy of ``w`` (K x pad16(N) bytes,
    :func:`kmajor_weight`); at GPT-2's N of 768 and 3072 it reads ``w``
    itself."""
    m, n = g.shape
    k, n2 = w.shape
    if n != n2 or fold_scale.numel() != n or q_scale.numel() != m:
        raise ValueError(f"int8_matmul_nt: g {tuple(g.shape)}, w "
                         f"{tuple(w.shape)}, fold {tuple(fold_scale.shape)}, "
                         f"q_scale {tuple(q_scale.shape)}")
    if g.device.type == "cpu":
        return int8_matmul_nt_plain(g, w, fold_scale, q_scale, out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"int8_matmul_nt: unsupported device {g.device}")
    _check_cuda("int8_matmul_nt", g.device, (
        ("g", g, _CARRIERS), ("w", w, (torch.int8,)),
        ("fold_scale", fold_scale, (torch.float32,)),
        ("q_scale", q_scale, (torch.float32,))))
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul_nt: unsupported out_dtype {out_dtype}")
    if n > MAX_CONTRACTION:
        raise ValueError(f"int8_matmul_nt: contraction {n} > "
                         f"{MAX_CONTRACTION} (int32 sums)")
    out = torch.empty((m, k), dtype=out_dtype, device=g.device)
    gq = torch.empty((m, _pad16(n)), dtype=torch.int8, device=g.device)
    wk = kmajor_weight(w)
    splits = gemm_splits(m, k, n)
    ws = _workspace(splits, m, k, g.device)
    _run("repro_int8_matmul_nt", _build.ptr(g), _build.ptr(wk),
         _build.ptr(fold_scale), _build.ptr(q_scale), _build.ptr(out),
         _build.ptr(gq), _p(ws), m, n, k, wk.stride(0), splits,
         _DTYPE_CODES[g.dtype], _DTYPE_CODES[out_dtype], _build.stream_of(g))
    int8_matmul_nt.launches += 1
    return out


def int8_matmul_tn(x: torch.Tensor, g: torch.Tensor, fold_scale: torch.Tensor,
                   q_scale: torch.Tensor,
                   out_dtype=torch.float32) -> torch.Tensor:
    """dW = x^T @ qdq_channel(g * fold_scale) with real int8 compute.

    x: int8 (M, K) stored forward payload; g: fp32/bf16 (M, N) output
    gradient; fold_scale fp32 (M,) or (M, 1) -- the activation's per-token
    dequant scales; q_scale fp32 (N,) or (1, N) -- the per-channel quant
    scale of g * fold (from ``kernels/ops.int8_bwd_dw``) -> (K, N)
    ``out_dtype``:

        dW[k, n] = g(qs[n]) * sum_m x[m, k]
                   * clip(round(g[m, n] * fold[m] / g(qs[n])))

    CPU tensors take :func:`int8_matmul_tn_plain`; CUDA tensors launch the
    kernel (any N, K and M up to ``MAX_CONTRACTION``) or raise: the gradient
    quantized and transposed into (N, pad16(M)) int8, x transposed into (K,
    pad16(M)), then the int8 GEMM, split over M where its output tiles
    cannot fill the card."""
    m, k = x.shape
    m2, n = g.shape
    if m != m2 or fold_scale.numel() != m or q_scale.numel() != n:
        raise ValueError(f"int8_matmul_tn: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}, fold {tuple(fold_scale.shape)}, "
                         f"q_scale {tuple(q_scale.shape)}")
    if g.device.type == "cpu":
        return int8_matmul_tn_plain(x, g, fold_scale, q_scale, out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"int8_matmul_tn: unsupported device {g.device}")
    _check_cuda("int8_matmul_tn", g.device, (
        ("x", x, (torch.int8,)), ("g", g, _CARRIERS),
        ("fold_scale", fold_scale, (torch.float32,)),
        ("q_scale", q_scale, (torch.float32,))))
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul_tn: unsupported out_dtype {out_dtype}")
    if m > MAX_CONTRACTION:
        raise ValueError(f"int8_matmul_tn: contraction {m} > "
                         f"{MAX_CONTRACTION} (int32 sums)")
    out = torch.empty((k, n), dtype=out_dtype, device=g.device)
    xt = torch.empty((k, _pad16(m)), dtype=torch.int8, device=g.device)
    gt = torch.empty((n, _pad16(m)), dtype=torch.int8, device=g.device)
    splits = gemm_splits(k, n, m)
    ws = _workspace(splits, k, n, g.device)
    _run("repro_int8_matmul_tn", _build.ptr(x), _build.ptr(g),
         _build.ptr(fold_scale), _build.ptr(q_scale), _build.ptr(out),
         _build.ptr(xt), _build.ptr(gt), _p(ws), m, n, k, splits,
         _DTYPE_CODES[g.dtype], _DTYPE_CODES[out_dtype], _build.stream_of(g))
    int8_matmul_tn.launches += 1
    return out


int8_matmul_nt.launches = 0
int8_matmul_tn.launches = 0
