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
the carrier -- bit for bit ``repro.kernels.ref.int8_matmul_ref``.  The
transposed layouts take the fp gradient and quantize it inside the kernel
(see their docstrings); the wrappers in ``kernels/ops.py`` reduce its
scales.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    """Plain PyTorch version.  The int32 sum is exact on both devices: the
    CPU multiplies int32 tensors; CUDA has no integer matmul, and a float32
    one is not exact at K = 3072 (|sum| <= 127*128*K ~ 5e7 > 2**24), so the
    card sums in float64, exact below 2**53."""
    if x.is_cuda:
        acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    else:
        acc = torch.matmul(x.to(torch.int32), w.to(torch.int32))
    acc = acc.to(torch.float32)
    return ((acc * scale_guard(row_scale).reshape(-1, 1))
            * scale_guard(col_scale).reshape(1, -1)).to(out_dtype)


def int8_matmul(x: torch.Tensor, w: torch.Tensor, row_scale: torch.Tensor,
                col_scale: torch.Tensor,
                out_dtype=torch.bfloat16) -> torch.Tensor:
    """x: int8 (M, K); w: int8 (K, N); row_scale fp32 (M, 1) or (M,);
    col_scale fp32 (1, N) or (N,) -> (M, N) ``out_dtype``.

    CPU tensors take :func:`int8_matmul_plain`; CUDA tensors launch the
    kernel (any M, N, K) or raise."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"int8_matmul: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    if row_scale.numel() != m or col_scale.numel() != n:
        raise ValueError(f"int8_matmul: scales {tuple(row_scale.shape)}, "
                         f"{tuple(col_scale.shape)} for ({m}, {n}) output")
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, row_scale, col_scale, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    _check_cuda("int8_matmul", x.device, (
        ("x", x, (torch.int8,)), ("w", w, (torch.int8,)),
        ("row_scale", row_scale, (torch.float32,)),
        ("col_scale", col_scale, (torch.float32,))))
    if out_dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul: unsupported out_dtype {out_dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    lib = _build.load("int8_matmul")
    rc = lib.repro_int8_matmul(_build.ptr(x), _build.ptr(w), _build.ptr(row_scale),
            _build.ptr(col_scale), _build.ptr(out), m, n, k,
            _DTYPE_CODES[out_dtype], _build.stream_of(x))
    _build.check(lib, rc, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 of the exact integer product of two integer-valued tensors:
    int32 on the CPU, float64 on the card (no CUDA integer matmul; float64
    is exact below 2**53, float32 only below 2**24)."""
    if a.is_cuda:
        return torch.matmul(a.to(torch.float64), b.to(torch.float64)
                            ).to(torch.float32)
    return torch.matmul(a.to(torch.int32), b.to(torch.int32)).to(torch.float32)


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


def _launch_bwd(entry: str, a: torch.Tensor, b: torch.Tensor,
                fold: torch.Tensor, qs: torch.Tensor, out: torch.Tensor,
                m: int, n: int, k: int, g: torch.Tensor) -> None:
    lib = _build.load("int8_matmul_bwd")
    rc = getattr(lib, entry)(
        _build.ptr(a), _build.ptr(b), _build.ptr(fold), _build.ptr(qs),
        _build.ptr(out), m, n, k, _DTYPE_CODES[g.dtype],
        _DTYPE_CODES[out.dtype], _build.stream_of(g))
    _build.check(lib, rc, entry)


_CARRIERS = tuple(_DTYPE_CODES)


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
    kernel (any M, N, K) or raise."""
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
    out = torch.empty((m, k), dtype=out_dtype, device=g.device)
    _launch_bwd("repro_int8_matmul_nt", g, w, fold_scale, q_scale, out,
                m, n, k, g)
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
    kernel (any M, N, K) or raise."""
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
    out = torch.empty((k, n), dtype=out_dtype, device=g.device)
    _launch_bwd("repro_int8_matmul_tn", x, g, fold_scale, q_scale, out,
                m, n, k, g)
    int8_matmul_tn.launches += 1
    return out


int8_matmul_nt.launches = 0
int8_matmul_tn.launches = 0
