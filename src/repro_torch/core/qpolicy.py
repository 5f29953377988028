"""Layer-aware quantization policy, ported from ``repro.core.qpolicy``.

Ordered pattern **rules** map a layer role (``attn_qkv``, ``mlp_down``,
``block[0:2].*`` ...) to a :class:`QuantRecipe` (or fp) plus a kernel
**backend**; every weight-bearing matmul calls ``policy.linear(ctx, x, w)``.
The string codec is the reference's, so one policy string means the same
thing in both packages.

Backends, in a registry of :class:`KernelBackend` records: ``fake_quant``
(the reference error-injection path, ``core.qlinear.quantized_linear``)
and ``int8_cuda``, the hand-written Hopper kernels
(``core.qlinear.int8_quantized_linear``).  ``int8_pallas`` -- the JAX
package's name for its TPU kernels -- parses as an alias of ``int8_cuda``.

A weight reaches :meth:`QuantPolicy.linear` in one of two forms:

* raw (training, or fp serving): the resolved backend's Fig-1 linear runs,
  with the reference's automatic fallback to ``fake_quant`` for recipes
  outside the backend's contract;
* prepared as a :class:`QState` (serving, ``repro_torch.infer.prepare``):
  the int8 matmul kernel when the backend is ``int8_cuda`` and the recipe
  fits the W8A8 contract, else the dequant-read matmul.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.qadam import QState
from repro_torch.core.qconfig import (Granularity, QuantRecipe, QuantSpec,
                                      RoundMode, get_recipe)
from repro_torch.core.qlinear import (int8_backend_supported,
                                      int8_bwd_supported,
                                      int8_decode_attn_supported,
                                      int8_quantized_linear, quantized_linear)
from repro_torch.core.quantizer import fake_quant, fake_quant_nograd

ROLES = ("embed", "lm_head", "attn_qkv", "attn_out", "mlp_up", "mlp_down",
         "router", "ssm_in", "ssm_out", "shared_proj", "frame_proj",
         "patch_proj", "kv_cache")

INT8_BACKEND = "int8_cuda"
#: backend names of the JAX package that mean the same kernels here
BACKEND_ALIASES = {"int8_pallas": INT8_BACKEND}


# ---------------------------------------------------------------------------
# Kernel backend registry
# ---------------------------------------------------------------------------

class KernelBackend(NamedTuple):
    """A quantized-matmul implementation.  ``fn(x, w, recipe) -> y`` runs
    the forward and owns its backward; ``supports(recipe)`` gates
    eligibility (unsupported recipes fall back to ``fake_quant``);
    ``bwd_supports(recipe)`` says whether the backward also runs quantized
    kernels; ``decode_attn_supports(kv_spec)`` whether the backend's
    attention kernels consume a KV cache stored under that spec."""
    fn: Callable
    supports: Callable
    bwd_supports: Callable = lambda recipe: False
    decode_attn_supports: Callable = lambda spec: False


KERNEL_BACKENDS: Dict[str, KernelBackend] = {
    "fake_quant": KernelBackend(quantized_linear, lambda recipe: True),
    INT8_BACKEND: KernelBackend(int8_quantized_linear,
                                supports=int8_backend_supported,
                                bwd_supports=int8_bwd_supported,
                                decode_attn_supports=int8_decode_attn_supported),
}


def _backend_name(name: str) -> str:
    name = BACKEND_ALIASES.get(name, name)
    if name not in KERNEL_BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; registered: "
                         f"{sorted(KERNEL_BACKENDS)} (aliases: "
                         f"{sorted(BACKEND_ALIASES)})")
    return name


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def _prepared_int8_ok(recipe: Optional[QuantRecipe], w: QState) -> bool:
    """Can the int8 kernel consume this prepared weight directly?  Needs the
    full W8A8 contract and a plain 2-D int8 payload."""
    return (int8_backend_supported(recipe) and w.q.ndim == 2
            and w.q.dtype == torch.int8)


def _prepared_matmul(resolved: "Resolved", x: torch.Tensor,
                     w: QState) -> torch.Tensor:
    """Serving path: the weight arrives as a stored integer payload + scales
    (quantized once, ``repro_torch.infer.prepare``); only the activations
    are quantized here, per the resolved recipe."""
    recipe = resolved.recipe
    a_spec = recipe.acts if recipe is not None else None
    if (resolved.backend == INT8_BACKEND and a_spec is not None
            and _prepared_int8_ok(recipe, w)):
        from repro_torch.kernels.ops import int8_prepared_linear
        return int8_prepared_linear(x, w.q, w.scale, a_spec,
                                    out_dtype=x.dtype)
    xq = x if a_spec is None else fake_quant_nograd(x, a_spec)
    wd = ((w.q.to(torch.float32) + w.zero) * w.scale).to(x.dtype)
    return torch.matmul(xq, wd)


def _dispatch(resolved: "Resolved", x: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, QState):
        return _prepared_matmul(resolved, x, w)
    recipe = resolved.recipe
    if recipe is None or not recipe.any_linear_quant:
        return torch.matmul(x, w)
    be = KERNEL_BACKENDS[resolved.backend]
    if not be.supports(recipe):
        be = KERNEL_BACKENDS["fake_quant"]       # automatic fallback
    return be.fn(x, w, recipe)


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PolicyRule:
    """One ordered pattern rule: ``block[lo:hi].role = recipe @ backend``.
    ``recipe=None`` means fp; ``backend=None`` inherits the policy's."""
    role: str = "*"
    lo: Optional[int] = None
    hi: Optional[int] = None
    recipe: Optional[QuantRecipe] = None
    backend: Optional[str] = None

    @property
    def depth_bounded(self) -> bool:
        return self.lo is not None or self.hi is not None

    def matches(self, role: str, layer: Optional[int], n_layers: int = 0) -> bool:
        if self.role != "*" and self.role != role:
            return False
        if not self.depth_bounded:
            return True
        if layer is None:
            return False
        lo = self.lo if self.lo is not None else 0
        hi = self.hi if self.hi is not None else (n_layers or 1 << 30)
        if lo < 0:
            lo += n_layers
        if hi < 0:
            hi += n_layers
        return lo <= layer < hi

    def describe(self) -> str:
        pat = self.role
        if self.depth_bounded:
            lo = "" if self.lo is None else str(self.lo)
            hi = "" if self.hi is None else str(self.hi)
            pat = f"block[{lo}:{hi}].{pat}"
        spec = "fp" if self.recipe is None else \
            self.recipe.describe_compact().replace(",", "+")
        s = f"{pat}={spec}"
        if self.backend is not None:
            s += f"@{self.backend}"
        return s


@dataclasses.dataclass(frozen=True)
class Resolved:
    """Outcome of role resolution: what to run and on which backend."""
    recipe: Optional[QuantRecipe]
    backend: str = "fake_quant"


@dataclasses.dataclass(frozen=True)
class LinearCtx:
    """Call-site context for one matmul: role and (static) layer index."""
    role: str
    layer: Optional[int] = None
    n_layers: int = 0


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Ordered pattern rules + default recipe + default backend.
    Resolution: first matching rule wins; otherwise ``(default, backend)``."""
    rules: Tuple[PolicyRule, ...] = ()
    default: Optional[QuantRecipe] = None
    backend: str = "fake_quant"

    @classmethod
    def from_recipe(cls, recipe: Optional[QuantRecipe],
                    backend: str = "fake_quant") -> "QuantPolicy":
        """Block linears get ``recipe``; embed, lm-head, router, patch
        adapter and the KV cache stay fp (the reference's scoping)."""
        rules = ()
        if not (recipe is not None and recipe.include_embeddings):
            rules += (PolicyRule(role="embed"), PolicyRule(role="lm_head"))
        rules += (PolicyRule(role="patch_proj"), PolicyRule(role="router"),
                  PolicyRule(role="kv_cache"))
        return cls(rules=rules, default=recipe, backend=_backend_name(backend))

    @property
    def adam_m1(self) -> Optional[QuantSpec]:
        """Optimizer-moment specs come from the default recipe (moments are
        per parameter, not per role)."""
        return self.default.adam_m1 if self.default is not None else None

    @property
    def adam_m2(self) -> Optional[QuantSpec]:
        return self.default.adam_m2 if self.default is not None else None

    def resolve(self, role: str, layer: Optional[int] = None,
                n_layers: int = 0) -> Resolved:
        for rule in self.rules:
            if rule.matches(role, layer, n_layers):
                return Resolved(rule.recipe, rule.backend or self.backend)
        return Resolved(self.default, self.backend)

    def depth_sensitive(self, role: str) -> bool:
        """Could resolution of ``role`` depend on the layer index?"""
        return any(r.depth_bounded for r in self.rules
                   if r.role in ("*", role))

    def effective_backend(self, role: str, layer: Optional[int] = None,
                          n_layers: int = 0) -> Tuple[str, Tuple[str, ...]]:
        """``(backend_name, caps)`` that :meth:`linear` runs for a raw
        weight of this role, with the registry fallback applied: ``caps``
        is ``('fwd', 'bwd')`` for the full int8 training path, ``('fwd',)``
        for an int8 forward only, ``()`` for the fake-quant reference;
        ``'fp'`` means a plain matmul."""
        res = self.resolve(role, layer, n_layers)
        recipe = res.recipe
        if recipe is None or not recipe.any_linear_quant:
            return "fp", ()
        name, be = res.backend, KERNEL_BACKENDS[res.backend]
        if not be.supports(recipe):
            name, be = "fake_quant", KERNEL_BACKENDS["fake_quant"]
        if name == "fake_quant":
            return name, ()
        return name, (("fwd", "bwd") if be.bwd_supports(recipe)
                      else ("fwd",))

    def decode_attn_backend(self) -> Tuple[str, Tuple[str, ...]]:
        """``(backend_name, caps)`` for the KV-cache consumption path:
        ``('fp', ())`` when the cache is stored fp; ``('int8_cuda',
        ('decode', 'prefill'))`` when the attention kernels consume the
        stored payload directly; ``('dequant', ())`` when the cache is
        quantized but no kernel fits the spec (that path is not ported).
        A capability scan: the resolved rule backend is preferred, and a
        plain ``kv_cache=a8t`` rule still finds the int8 kernels."""
        spec = self.kv_spec()
        if spec is None:
            return "fp", ()
        preferred = self.resolve("kv_cache").backend
        names = [preferred] + [n for n in KERNEL_BACKENDS if n != preferred]
        for name in names:
            if KERNEL_BACKENDS[name].decode_attn_supports(spec):
                return name, ("decode", "prefill")
        return "dequant", ()

    def kv_spec(self) -> Optional[QuantSpec]:
        """Storage spec for the KV cache (role ``kv_cache``), or None for fp
        storage: the resolved recipe's ``acts`` component, else ``weights``.
        Per-channel, asymmetric, block-wise and stochastic codecs cannot key
        a (B, S, K, 1) sidecar and are rejected."""
        r = self.resolve("kv_cache").recipe
        if r is None:
            return None
        spec = r.acts if r.acts is not None else r.weights
        if spec is None:
            return None
        if (spec.granularity is Granularity.PER_CHANNEL
                or not spec.symmetric or spec.block_size
                or spec.sqrt_domain
                or spec.round_mode is not RoundMode.NEAREST):
            raise ValueError(
                f"kv_cache spec [{spec.describe()}] unsupported: the cache "
                "codec is symmetric nearest-rounded per-token (one scale per "
                "position x head) or per-tensor (per write-block)")
        return spec

    def linear(self, ctx: LinearCtx, x: torch.Tensor, w,
               b: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The quantized matmul: resolve (role, layer) -> spec + backend,
        run.  The bias is added after the matmul, in the carrier (biases
        are not quantized -- the paper's scope is the matmul)."""
        y = _dispatch(self.resolve(ctx.role, ctx.layer, ctx.n_layers), x, w)
        return y if b is None else y + b

    def quantize_weight(self, role: str, w: torch.Tensor) -> torch.Tensor:
        """Weight-only qdq for non-matmul sites (embedding lookup, tied
        head), straight-through for the gradient; a no-op when the role
        resolves to fp (the default)."""
        res = self.resolve(role)
        spec = res.recipe.weights if res.recipe is not None else None
        return w if spec is None else fake_quant(w, spec)

    def describe(self) -> str:
        parts = [r.describe() for r in self.rules]
        if not any(r.role == "*" and not r.depth_bounded for r in self.rules):
            spec = "fp" if self.default is None else \
                self.default.describe_compact().replace(",", "+")
            tail = f"*={spec}"
            if self.backend != "fake_quant":
                tail += f"@{self.backend}"
            parts.append(tail)
        return ",".join(parts)


#: The fp baseline policy: every linear is a plain matmul.
FP_POLICY = QuantPolicy()


def fallback_policy(policy: "QuantPolicy", mode: str = "fake_quant"
                    ) -> "QuantPolicy":
    """Stability-fallback variant of a policy: the train sentinel's recovery
    action after a rollback (the trainer runs the step built from it for a
    window of steps, then re-engages the primary policy; see
    ``train/sentinel.py``).

    ``mode='fake_quant'`` keeps every resolved recipe (the quantization
    error stays) but moves every rule and the default off the int8 kernels
    onto the ``fake_quant`` reference, whose G spec runs the qdq kernels.
    ``mode='fp'`` also drops the linear quantization (weights, acts, grads)
    from every rule and the default.

    Both modes keep the default recipe's optimizer-moment specs, so the
    fallback step consumes and produces the same ``AdamState`` structure
    (int8 ``QState`` payloads and sidecars) as the primary step and the
    two hand the state back and forth."""
    if mode not in ("fake_quant", "fp"):
        raise ValueError(f"unknown fallback mode {mode!r} "
                         "(want 'fake_quant' or 'fp')")
    policy = as_policy(policy)

    def degrade(recipe: Optional[QuantRecipe]) -> Optional[QuantRecipe]:
        if recipe is None:
            return None
        if mode == "fake_quant":
            return recipe
        return dataclasses.replace(recipe, weights=None, acts=None,
                                   grads=None, grads_dx=None)

    rules = tuple(dataclasses.replace(r, recipe=degrade(r.recipe),
                                      backend="fake_quant")
                  for r in policy.rules)
    return QuantPolicy(rules=rules, default=degrade(policy.default),
                       backend="fake_quant")


def as_policy(obj: Union[None, QuantRecipe, QuantPolicy, str]) -> QuantPolicy:
    """None (fp), a QuantRecipe, a QuantPolicy, or a policy string."""
    if obj is None:
        return FP_POLICY
    if isinstance(obj, QuantPolicy):
        return obj
    if isinstance(obj, QuantRecipe):
        return QuantPolicy.from_recipe(obj)
    if isinstance(obj, str):
        return parse_policy(obj)
    raise TypeError(f"expected QuantRecipe / QuantPolicy / str / None, "
                    f"got {type(obj).__name__}")


# ---------------------------------------------------------------------------
# Policy string codec:  "embed=fp,block[0:2].*=fp,*=w8c+a8t@int8_cuda"
# ---------------------------------------------------------------------------

_PATTERN_RE = re.compile(
    r"^(?:(block\[)(-?\d+)?(:)?(-?\d+)?\]\.)?([a-z_][a-z0-9_]*|\*)$")


def _parse_pattern(pat: str) -> Tuple[str, Optional[int], Optional[int]]:
    m = _PATTERN_RE.match(pat.strip())
    if not m:
        raise ValueError(
            f"bad policy pattern {pat!r} (want 'role', '*', 'block[2].role' "
            "or 'block[0:4].*')")
    prefix, lo_s, colon, hi_s, role = m.groups()
    if role != "*" and role not in ROLES:
        raise ValueError(f"unknown role {role!r}; roles: {ROLES}")
    if prefix is None:
        return role, None, None
    if lo_s is None and hi_s is None:
        if colon is None:
            raise ValueError(f"bad policy pattern {pat!r}: block[] needs an "
                             "index or slice (block[2], block[0:4], block[:])")
        return role, 0, None            # block[:]: every depth, depth-bounded
    lo = int(lo_s) if lo_s is not None else 0
    if colon is None:                       # block[i] -> exactly layer i
        if lo == -1:
            return role, -1, None           # block[-1] -> last layer
        return role, lo, lo + 1
    hi = int(hi_s) if hi_s is not None else None
    return role, lo, hi


def _parse_value(spec: str) -> Tuple[Optional[QuantRecipe], Optional[str]]:
    """``spec[@backend]`` where spec is 'fp', a preset name, or a compact
    recipe string with '+' separators."""
    backend = None
    if "@" in spec:
        spec, backend = spec.split("@", 1)
        backend = _backend_name(backend.strip())
    spec = spec.strip()
    recipe = None if spec == "fp" else get_recipe(spec)
    return recipe, backend


#: roles pinned fp unless a rule names them (same as from_recipe)
_DEFAULT_FP_ROLES = ("embed", "lm_head", "patch_proj", "router", "kv_cache")


def parse_policy(text: str, backend: str = "fake_quant") -> QuantPolicy:
    """Parse a comma-separated rule list into a :class:`QuantPolicy`.
    Each entry is ``pattern=spec[@backend]``; earlier entries win; a
    depth-less ``*`` entry also sets the policy default.  Example::

        kv_cache=a8t,*=w8c+a8t@int8_cuda
    """
    rules = []
    default: Optional[QuantRecipe] = None
    default_backend = _backend_name(backend)
    for entry in text.split(","):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"bad policy entry {entry!r} (want pattern=spec)")
        pat, spec = entry.split("=", 1)
        role, lo, hi = _parse_pattern(pat)
        recipe, be = _parse_value(spec)
        rules.append(PolicyRule(role=role, lo=lo, hi=hi, recipe=recipe,
                                backend=be))
        if role == "*" and lo is None and hi is None and default is None:
            default = recipe
            if be is not None:
                default_backend = be
    for rule in rules:
        r = rule.recipe
        if (r is not None and (r.adam_m1 is not None or r.adam_m2 is not None)
                and r != default):
            raise ValueError(
                f"rule '{rule.describe()}' carries optimizer-moment specs "
                "(m1:/m2:), but moments are read from the depth-less '*' "
                "entry only -- move them there")
    named = {r.role for r in rules if r.role != "*"}
    include_emb = default is not None and default.include_embeddings
    exclusions = tuple(
        PolicyRule(role=role) for role in _DEFAULT_FP_ROLES
        if role not in named
        and not (include_emb and role in ("embed", "lm_head")))
    return QuantPolicy(rules=exclusions + tuple(rules), default=default,
                       backend=default_backend)
