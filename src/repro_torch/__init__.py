"""PyTorch/CUDA port of the quantized pre-training repro (``src/repro``).

The JAX package stays the reference; this package runs the same models on
an NVIDIA Hopper card through hand-written CUDA kernels (``csrc/``), on the
dense GPT-2 decoder: serving under the paper's W8A8 recipe with an int8 KV
cache -- dense strips or page pools, under the async scheduler
(``infer``) -- and the paper's quantized pre-training step (``train``).

Entry points take ``device=`` and default to ``"cuda"``; without a card
they raise unless the caller asks for ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version.  Nothing here imports JAX.
"""
from repro_torch._device import resolve_device

__all__ = ["resolve_device"]
