#!/usr/bin/env python3
"""Time the wide tensor-core flash backward (``csrc/flash_bwd_sm90_wide.cu``)
against a variant that issues the next tile's S (dQ) or S^T (dK/dV) with
the last chunk at 256 columns too (``OVERLAP = true`` in both configs; the
tree overlaps at 192 columns only), on one card.

    python3 tools/flash_bwd_overlap.py

Builds the tree's library as ``chip_smoke.py`` does and the variant from a
copy of ``src/repro_torch/csrc`` under ``build/variants/overlap``, prints
the variant's ptxas spill lines, checks that both write the same bits, and
times #9 and #10 of each with the card's queue full
(``chip_smoke.queued_ms``) in turns -- tree, variant, variant, tree -- at
Gemma-2B's training attention (BH 16, S 4096, hd 256, causal) and at
Zamba2-2.7B's (BH 64, hd 160, where both run the same code: the spread of
two timings).  Prints the card's name and power limit.  Imports no JAX.
"""
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LIB = "flash_bwd_sm90_wide"


def build_variant(_build) -> ctypes.CDLL:
    """The wide library compiled with ``OVERLAP = true``; prints ptxas's
    spill lines."""
    d = ROOT / "build" / "variants" / "overlap"
    if d.exists():
        shutil.rmtree(d)
    shutil.copytree(_build.CSRC, d)
    for name in ("flash_bwd_sm90.cuh", f"{LIB}.cu"):
        p = d / name
        src = p.read_text()
        if "OVERLAP = HDP <= 192" not in src:
            raise SystemExit(f"{name}: no 'OVERLAP = HDP <= 192' to vary")
        p.write_text(src.replace("OVERLAP = HDP <= 192", "OVERLAP = true"))
    so = d / f"{LIB}.so"
    r = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(d),
                        "-o", str(so), str(d / f"{LIB}.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    print("variant ptxas: " + "; ".join(
        " ".join(l.split()) for l in (r.stdout + r.stderr).splitlines()
        if "spill" in l))
    lib = ctypes.CDLL(str(so))
    for entry, argtypes in _build.SIGNATURES[LIB].items():
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_overlap: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attn as fa
    _build.build([LIB, "flash_fwd_sm90"])
    libs = {"tree": _build.load(LIB), "overlap": build_variant(_build)}
    print(cs.card_line())

    def launch(lib, which, args, outs):
        q, k = args[0], args[1]
        bh, sq, d = q.shape
        a = [_build.ptr(t) for t in (*args, *outs)]
        a += [bh, sq, k.shape[1], d, 1.0 / d ** 0.5, 1, 0,
              _build.stream_of(q)]
        _build.check(lib, getattr(lib, f"repro_{LIB}_{which}")(*a), which)

    gen = torch.Generator(device="cuda").manual_seed(0)
    for tag, (b, s, h, d) in (("gemma-2b", (2, 4096, 8, 256)),
                              ("zamba2-2.7b", (2, 4096, 32, 160))):
        q, k, v, do = (torch.randn((b * h, s, d), generator=gen,
                                   device="cuda").bfloat16()
                       for _ in range(4))
        o, lse = fa.flash_attention_fwd_lse(q, k, v)
        args = (q, k, v, do, lse, (do.float() * o.float()).sum(-1))
        outs = {}
        for name, lib in libs.items():
            outs[name] = ((torch.empty_like(k), torch.empty_like(v)),
                          (torch.empty_like(q),))
            launch(lib, "dkdv", args, outs[name][0])
            launch(lib, "dq", args, outs[name][1])
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in
                   zip(outs["tree"][0] + outs["tree"][1],
                       outs["overlap"][0] + outs["overlap"][1]))
        times = {}
        for name in ("tree", "overlap", "overlap", "tree"):
            lib, (o9, o10) = libs[name], outs[name]
            t9 = cs.queued_ms(lambda: launch(lib, "dkdv", args, o9), iters=10)
            t10 = cs.queued_ms(lambda: launch(lib, "dq", args, o10), iters=10)
            times.setdefault(name, []).append(f"{t9:.4f} / {t10:.4f}")
        print(f"{tag} BH={b * h} S={s} hd={d} causal: bits equal {same}; "
              f"#9 / #10 ms, queued, in turns: "
              + "; ".join(f"{k} {', '.join(v)}" for k, v in times.items()))
        del q, k, v, do, o, lse, args, outs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
