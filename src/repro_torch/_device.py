"""Device resolution for the port's entry points.

Entry points default to ``"cuda"``: the port exists to run on the card, so
a missing card is an error, never a silent CPU run.  The CPU is taken only
when the caller names it (the tests do), and then every kernel wrapper runs
its plain PyTorch version because the tensors it receives lie on the CPU.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``device`` -> ``torch.device``; raises when CUDA is asked for (the
    default) and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on the GPU by default and no CUDA "
            "device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
