"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes`` -- no PyTorch headers, so a
build takes seconds.  Libraries land in ``build/repro_torch/`` at the root
of the checkout, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not ``cudaSuccess`` (a refused launch --
too many threads, too much shared memory -- never runs, and a later
``synchronize`` would not report it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: source name -> {C entry point: argtypes}; every entry returns int
SIGNATURES = {
    "int8_matmul": {
        "repro_int8_matmul_dp4a": [_P] * 5 + [_I] * 4 + [_P],
        "repro_int8_gemv": [_P] * 5 + [_I] * 9 + [_P],
        "repro_int8_matmul_wgmma": [_P] * 7 + [_I] * 7 + [_P],
        "repro_int8_transpose": [_P] * 2 + [_I] * 2 + [_P],
        "repro_int8_gemm_fwd": [_P] * 6 + [_I] * 7 + [_P],
        "repro_int8_split_reduce_fwd": [_P] * 4 + [_I] * 4 + [_P],
        "repro_int8_gemm_splits": [_I] * 4},
    "int8_matmul_bwd": {
        "repro_int8_matmul_nt": [_P] * 7 + [_I] * 7 + [_P],
        "repro_int8_matmul_tn": [_P] * 8 + [_I] * 6 + [_P],
        "repro_int8_matmul_nt_experts": [_P] * 7 + [_I] * 8 + [_P],
        "repro_int8_matmul_tn_experts": [_P] * 8 + [_I] * 7 + [_P],
        "repro_int8_quant_rows": [_P] * 4 + [_I] * 3 + [_P],
        "repro_int8_pack_tn": [_P] * 6 + [_I] * 4 + [_P],
        "repro_int8_gemm": [_P] * 5 + [_I] * 8 + [_P],
        "repro_int8_split_reduce": [_P] * 3 + [_I] * 5 + [_P]},
    "flash_attn_q8": {"repro_flash_attn_q8":
                      [_P] * 6 + [_I] * 6 + [_F] + [_I] * 3 + [_P]},
    "flash_q8_sm90": {"repro_flash_q8_sm90":
                      [_P] * 6 + [_I] * 6 + [_F] + [_I] * 3 + [_P]},
    "flash_attn": {
        "repro_flash_attn_fwd": [_P] * 5 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
        "repro_flash_attn_bwd_dkdv":
            [_P] * 8 + [_I] * 4 + [_F] + [_I] * 3 + [_P],
        "repro_flash_attn_bwd_dq":
            [_P] * 7 + [_I] * 4 + [_F] + [_I] * 3 + [_P]},
    "flash_fwd_sm90": {
        "repro_flash_fwd_sm90": [_P] * 5 + [_I] * 4 + [_F] + [_I] * 2 + [_P],
        "repro_flash_kv_tile": [_I]},
    "flash_bwd_sm90": {
        "repro_flash_bwd_sm90_dkdv":
            [_P] * 8 + [_I] * 4 + [_F] + [_I] * 2 + [_P],
        "repro_flash_bwd_sm90_dq":
            [_P] * 7 + [_I] * 4 + [_F] + [_I] * 2 + [_P],
        "repro_flash_bwd_max_head_dim": []},
    "flash_bwd_sm90_wide": {
        "repro_flash_bwd_sm90_wide_dkdv":
            [_P] * 8 + [_I] * 4 + [_F] + [_I] * 2 + [_P],
        "repro_flash_bwd_sm90_wide_dq":
            [_P] * 7 + [_I] * 4 + [_F] + [_I] * 2 + [_P],
        "repro_flash_bwd_sm90_wide_max_head_dim": []},
    "decode_attn": {
        "repro_decode_attn": [_P] * 10 + [_I] * 6 + [_F] + [_I] * 3 + [_P],
        "repro_decode_attn_paged":
            [_P] * 11 + [_I] * 7 + [_F] + [_I] * 3 + [_P],
        "repro_decode_chunk": []},
    "opt_update": {"repro_fused_adamw":
                   [_P, _I, _I, _L, _I, _I] + [_P] * 9 + [_I] * 10 + [_P]},
    "qdq": {"repro_qdq_row": [_P] * 2 + [_I] * 4 + [_P],
            "repro_qdq_scaled": [_P] * 3 + [_I] * 5 + [_P]},
}
SOURCES = tuple(SIGNATURES)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME or "
                       "/usr/local/cuda): the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def lib_path(name: str) -> Path:
    """Library path for ``csrc/<name>.cu``, keyed by the source, every
    shared header and the flags."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns seconds per
    library built (an empty dict when everything was cached).  The ptxas
    report (registers, shared memory, spills) goes to ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT), tmp, out,
                       log)
    times, failed = {}, []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}: nvcc exit {rc}\n"
                          + out.with_suffix(".log").read_text()[-4000:])
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return times


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        for entry, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


# Both return plain ints, which ctypes passes as the entry points'
# c_void_p arguments: a decode step makes hundreds of launches, and a
# c_void_p object or a torch.cuda.Stream costs microseconds of host time
# each (PERF.md).


def ptr(t) -> int:
    return t.data_ptr()


def stream_of(t) -> int:
    """The raw handle of the current stream on ``t``'s card."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
