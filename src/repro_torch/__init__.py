"""PyTorch/CUDA port of the quantized pre-training repro (``src/repro``).

The JAX package stays the reference; this package runs the same models on
an NVIDIA Hopper card through hand-written CUDA kernels (``csrc/``).  The
first slice serves the paper's W8A8 recipe with an int8 KV cache on the
dense GPT-2 decoder: prepared int8 weights (``infer.prepare``), the int8
matmul, the int8-KV flash prefill and the fused int8-KV decode step.

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version.  Nothing here imports JAX.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
