"""Architecture configs of the port (its own copy: the port imports nothing
from the JAX package): GPT-2 small, which the port trains and serves,
and the llama family's Llama 3 8B and Yi-6B, which it serves."""
from __future__ import annotations

from repro_torch.configs import gpt2_small, llama3_8b, yi_6b
from repro_torch.configs.base import ArchConfig

_MODULES = {"gpt2-small": gpt2_small, "llama3-8b": llama3_8b,
            "yi-6b": yi_6b}


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
