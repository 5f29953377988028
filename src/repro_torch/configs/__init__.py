"""Architecture configs of the port (its own copy: the port imports nothing
from the JAX package).  This slice serves GPT-2 small."""
from __future__ import annotations

from repro_torch.configs import gpt2_small
from repro_torch.configs.base import ArchConfig

_MODULES = {"gpt2-small": gpt2_small}


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
