"""Architecture configs of the port (its own copy: the port imports nothing
from the JAX package): the dense family -- GPT-2 small, the llama
family's Llama 3 8B and Yi-6B, Gemma-2B and Qwen3-32B -- and the MoE
family's Granite-3.0-MoE 3B-A800M and Phi-3.5-MoE, the SSM family's
Mamba2-130M, the hybrid family's Zamba2-2.7B and the encoder-decoder
family's seamless-m4t-medium."""
from __future__ import annotations

from repro_torch.configs import (gemma_2b, gpt2_small,
                                 granite_moe_3b_a800m, llama3_8b,
                                 mamba2_130m, phi35_moe_42b_a6p6b,
                                 qwen3_32b, seamless_m4t_medium, yi_6b,
                                 zamba2_2p7b)
from repro_torch.configs.base import ArchConfig

_MODULES = {"gpt2-small": gpt2_small, "llama3-8b": llama3_8b,
            "yi-6b": yi_6b, "gemma-2b": gemma_2b, "qwen3-32b": qwen3_32b,
            "granite-moe-3b-a800m": granite_moe_3b_a800m,
            "phi3.5-moe-42b-a6.6b": phi35_moe_42b_a6p6b,
            "mamba2-130m": mamba2_130m, "zamba2-2.7b": zamba2_2p7b,
            "seamless-m4t-medium": seamless_m4t_medium}


def _module(name: str):
    try:
        return _MODULES[name]
    except KeyError:
        raise KeyError(
            f"unknown arch {name!r}; options: {sorted(_MODULES)}") from None


def get_config(name: str) -> ArchConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ArchConfig:
    return _module(name).smoke_config()


__all__ = ["ArchConfig", "get_config", "get_smoke_config"]
