"""Quantization configuration (copy of ``repro.core.qconfig``).

Each quantized component gets a :class:`QuantSpec` (bits / granularity /
symmetry) and a whole study is a :class:`QuantRecipe`.  The compact string
codec (``w8c,a8t``) and the presets are the reference's, so the same policy
strings parse to the same recipes in both packages.
"""
from __future__ import annotations

import dataclasses
import enum
import re
from typing import Optional


class Granularity(str, enum.Enum):
    """Scale-factor granularity (paper Section 3.2).

    PER_TENSOR  : one scale for the whole tensor.
    PER_CHANNEL : one scale per element of the last dim.
    PER_TOKEN   : one scale per row (reduced over the last dim).
    """

    PER_TENSOR = "per_tensor"
    PER_CHANNEL = "per_channel"
    PER_TOKEN = "per_token"


class RoundMode(str, enum.Enum):
    NEAREST = "nearest"          # paper default: round-to-nearest
    STOCHASTIC = "stochastic"    # beyond-paper option for gradients


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """One component's quantization scheme (paper Eq. 1)."""

    bits: int = 8
    granularity: Granularity = Granularity.PER_TENSOR
    symmetric: bool = True               # z = 0 (paper default)
    round_mode: RoundMode = RoundMode.NEAREST
    block_size: int = 0                  # 0 disables block-wise codecs
    sqrt_domain: bool = False            # sqrt-space codec for Adam m2

    def __post_init__(self):
        if self.bits < 2 or self.bits > 16:
            raise ValueError(f"unsupported bit width {self.bits}")
        if self.block_size < 0:
            raise ValueError("block_size must be >= 0")

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        return 2 ** (self.bits - 1) - 1

    def describe(self) -> str:
        sym = "sym" if self.symmetric else "asym"
        extra = ""
        if self.block_size:
            extra += f",block{self.block_size}"
        if self.sqrt_domain:
            extra += ",sqrt"
        if self.round_mode is RoundMode.STOCHASTIC:
            extra += ",sr"
        return f"int{self.bits}/{self.granularity.value}/{sym}{extra}"

    def describe_compact(self) -> str:
        """Compact codec form, e.g. ``8c-asym-b128-sqrt`` (see parse_spec)."""
        s = f"{self.bits}{_GRAN_TO_CODE[self.granularity]}"
        if not self.symmetric:
            s += "-asym"
        if self.round_mode is RoundMode.STOCHASTIC:
            s += "-sr"
        if self.block_size:
            s += f"-b{self.block_size}"
        if self.sqrt_domain:
            s += "-sqrt"
        return s


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """Full quantization recipe (paper Section 4.5); ``None`` disables
    quantization for that component."""

    weights: Optional[QuantSpec] = None
    acts: Optional[QuantSpec] = None
    grads: Optional[QuantSpec] = None
    grads_dx: Optional[QuantSpec] = None
    adam_m1: Optional[QuantSpec] = None
    adam_m2: Optional[QuantSpec] = None
    include_embeddings: bool = False

    def describe(self) -> str:
        parts = []
        for name in ("weights", "acts", "grads", "grads_dx", "adam_m1", "adam_m2"):
            spec = getattr(self, name)
            if spec is not None:
                parts.append(f"{name}={spec.describe()}")
        return "fp-baseline" if not parts else " ".join(parts)

    @property
    def any_linear_quant(self) -> bool:
        return any(s is not None for s in (self.weights, self.acts, self.grads, self.grads_dx))

    def describe_compact(self) -> str:
        """Compact string codec, the inverse of :func:`parse_recipe`:
        ``w8c,a8t,g8t,m1:4c``.  ``fp`` for the baseline recipe."""
        parts = []
        for code, name in _COMP_CODES.items():
            spec = getattr(self, name)
            if spec is not None:
                sep = ":" if code.startswith("m") else ""
                parts.append(f"{code}{sep}{spec.describe_compact()}")
        if self.include_embeddings:
            parts.append("emb")
        return "fp" if not parts else ",".join(parts)


def fp_baseline() -> QuantRecipe:
    return QuantRecipe()


def paper_recipe() -> QuantRecipe:
    """W8 per-channel + A8 per-token (paper Section 4.5)."""
    return QuantRecipe(
        weights=QuantSpec(8, Granularity.PER_CHANNEL),
        acts=QuantSpec(8, Granularity.PER_TOKEN),
    )


def paper_recipe_wag8() -> QuantRecipe:
    return QuantRecipe(
        weights=QuantSpec(8, Granularity.PER_CHANNEL),
        acts=QuantSpec(8, Granularity.PER_TOKEN),
        grads=QuantSpec(8, Granularity.PER_TOKEN),
    )


def beyond_paper_recipe() -> QuantRecipe:
    return QuantRecipe(
        weights=QuantSpec(8, Granularity.PER_CHANNEL),
        acts=QuantSpec(8, Granularity.PER_TOKEN),
        adam_m1=QuantSpec(4, Granularity.PER_CHANNEL),
        adam_m2=QuantSpec(8, Granularity.PER_CHANNEL, symmetric=False,
                          block_size=128, sqrt_domain=True),
    )


PRESETS = {
    "fp": fp_baseline,
    "paper": paper_recipe,
    "paper_wag8": paper_recipe_wag8,
    "beyond": beyond_paper_recipe,
}


def get_recipe(name: str) -> QuantRecipe:
    """Resolve a preset name OR a compact recipe string (``w8c,a8t``)."""
    if name in PRESETS:
        return PRESETS[name]()
    try:
        return parse_recipe(name)
    except ValueError as e:
        raise KeyError(
            f"unknown recipe {name!r}; options: {sorted(PRESETS)} "
            f"or a compact spec like 'w8c,a8t,g8t,m1:4c' ({e})") from None


_GRAN_CODES = {"c": Granularity.PER_CHANNEL, "t": Granularity.PER_TOKEN,
               "n": Granularity.PER_TENSOR}
_GRAN_TO_CODE = {v: k for k, v in _GRAN_CODES.items()}
# component codes; insertion order fixes describe_compact() field order
_COMP_CODES = {"w": "weights", "a": "acts", "g": "grads", "gx": "grads_dx",
               "m1": "adam_m1", "m2": "adam_m2"}

_SPEC_RE = re.compile(r"^(\d+)([ctn])((?:-(?:asym|sr|sqrt|b\d+))*)$")
_TOKEN_RE = re.compile(r"^(gx|g|w|a|m1|m2):?(.*)$")


def parse_spec(text: str) -> QuantSpec:
    """``<bits><gran>[-asym][-sr][-b<N>][-sqrt]`` -> QuantSpec."""
    m = _SPEC_RE.match(text.strip())
    if not m:
        raise ValueError(f"bad quant spec {text!r} "
                         "(want e.g. '8c', '4t-sr', '8c-asym-b128-sqrt')")
    bits, gran, flags = int(m.group(1)), _GRAN_CODES[m.group(2)], m.group(3)
    kw = {}
    for flag in filter(None, flags.split("-")):
        if flag == "asym":
            kw["symmetric"] = False
        elif flag == "sr":
            kw["round_mode"] = RoundMode.STOCHASTIC
        elif flag == "sqrt":
            kw["sqrt_domain"] = True
        elif flag.startswith("b"):
            kw["block_size"] = int(flag[1:])
    return QuantSpec(bits, gran, **kw)


def parse_recipe(text: str) -> QuantRecipe:
    """Inverse of :meth:`QuantRecipe.describe_compact`; ``+`` is accepted as
    a component separator so recipes embed in comma-separated policy rules
    (``*=w8c+a8t``)."""
    text = text.strip()
    if text in ("", "fp"):
        return QuantRecipe()
    kw = {}
    for token in re.split(r"[,+]", text):
        token = token.strip()
        if not token:
            continue
        if token == "emb":
            kw["include_embeddings"] = True
            continue
        m = _TOKEN_RE.match(token)
        if not m:
            raise ValueError(f"bad recipe component {token!r} "
                             "(want e.g. 'w8c', 'a8t', 'm1:4c')")
        name = _COMP_CODES[m.group(1)]
        if name in kw:
            raise ValueError(f"duplicate component {m.group(1)!r} in {text!r}")
        kw[name] = parse_spec(m.group(2))
    return QuantRecipe(**kw)
