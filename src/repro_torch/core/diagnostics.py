"""Training diagnostics reproducing the paper's analysis figures (port of
``repro.core.diagnostics``).

* channel outlier statistics (Fig. 6 / Fig. 8): activations carry
  persistent per-channel outliers that break per-token/per-tensor
  quantization.
* gradient sparsity (Fig. 10 down): gradients are near-sparse, which makes
  absmax-scaled linear quantization lose most mass to the zero bin.
* m-sharpness (Fig. 5, Foret et al. 2021): quantized pre-training lands in
  sharper minima; measured as the loss increase under the worst of n
  random perturbations of radius rho on a batch.
* zero-bin fraction (Fig. 12): how much of a tensor quantizes to exactly 0
  -- the mechanism behind Adam-m2 divergence.

Plus the online quantization-health counters the training stability
sentinel (``train/sentinel.py``) watches every step:

* int8 saturation rate against a stored scale sidecar
  (:func:`saturation_rate`);
* relative quantization error (:func:`relative_quant_error`), whose drift
  the sentinel tracks;
* gradient-vs-moment saturation (:func:`moment_saturation_rate`): the
  fraction of candidate first moments the stored int8 Adam-moment scales
  cannot absorb (the paper's m2-divergence mechanism, measured live).

Every statistic is a 0-d float32 tensor on its input's device (no host
sync); ``jnp.median`` / ``jnp.percentile`` become ``torch.quantile``,
which interpolates linearly as they do.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core.qconfig import QuantSpec
from repro_torch.core.quantizer import fake_quant_nograd
from repro_torch.models.common import tree_flatten, tree_unflatten


def channel_outlier_stats(acts: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-channel outlier profile of an activation tensor (..., channels):
    the channel absmax vector plus summary ratios.  A large
    ``max_over_median`` with a few recurring argmax channels is the
    paper's Fig-6 signature."""
    flat = acts.reshape(-1, acts.shape[-1]).to(torch.float32)
    ch_absmax = torch.amax(flat.abs(), dim=0)
    med = torch.quantile(ch_absmax, 0.5)
    return {
        "channel_absmax": ch_absmax,
        "max_over_median": torch.amax(ch_absmax) / med.clamp_min(1e-9),
        "top_channel": torch.argmax(ch_absmax),
        "p99_over_p50": (torch.quantile(ch_absmax, 0.99)
                         / med.clamp_min(1e-9)),
    }


def gradient_sparsity(g: torch.Tensor,
                      rel_threshold: float = 1e-3) -> torch.Tensor:
    """Fraction of entries with |g| < rel_threshold * absmax(g) (Fig. 10)."""
    gf = g.to(torch.float32)
    thresh = rel_threshold * torch.amax(gf.abs())
    return torch.mean((gf.abs() < thresh).to(torch.float32))


def zero_bin_fraction(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Fraction of entries that dequantize to exactly zero (Fig. 12)."""
    q = fake_quant_nograd(x.to(torch.float32), spec)
    return torch.mean((q == 0.0).to(torch.float32))


def quant_snr_db(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB (higher = better)."""
    xf = x.to(torch.float32)
    err = xf - fake_quant_nograd(xf, spec)
    return 10.0 * torch.log10(torch.sum(xf ** 2)
                              / torch.sum(err ** 2).clamp_min(1e-20))


def saturation_rate(x: torch.Tensor, spec: QuantSpec,
                    scale: torch.Tensor) -> torch.Tensor:
    """Fraction of entries that would pin at the integer grid edge when
    quantized with the given stored scale (an overflow counter): entries
    with ``|x| > qmax * scale``.  ``scale`` broadcasts against ``x``."""
    xf = x.to(torch.float32).abs()
    lim = spec.qmax * scale.to(torch.float32).clamp_min(1e-30)
    return torch.mean((xf > lim).to(torch.float32))


def relative_quant_error(x: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """||x - qdq(x)|| / ||x||: the per-step size of the injected
    quantization error (the sentinel tracks its drift)."""
    xf = x.to(torch.float32)
    err = xf - fake_quant_nograd(xf, spec)
    return (torch.sqrt(torch.sum(torch.square(err)))
            / torch.sqrt(torch.sum(torch.square(xf))).clamp_min(1e-20))


def moment_saturation_rate(grads, moments, spec: Optional[QuantSpec],
                           beta1: float = 0.9,
                           headroom: float = 4.0) -> Optional[torch.Tensor]:
    """Saturation rate of the candidate first moments against the stored
    int8 moment scales, over every integer-stored leaf: the share of
    entries whose next value ``beta1 * dequant(m1) + (1 - beta1) * g``
    exceeds ``headroom * qmax * stored_scale``.  Entries whose stored scale
    sits at the quantizer's absmax floor (an all-zero block when fit) are
    left out.  None when no leaf stores integer moments."""
    from repro_torch.core import qadam
    if spec is None:
        return None
    g_leaves = tree_flatten(grads)[0]
    m_leaves = tree_flatten(moments)[0]
    hits, valid = [], []
    for g, m in zip(g_leaves, m_leaves):
        if not isinstance(m, qadam.QState):
            continue
        if spec.block_size:
            gb = qadam.flatten_blocks(g.to(torch.float32), spec.block_size)
        else:
            gb = g.to(torch.float32)
        scale = m.scale.to(torch.float32)
        m1 = (m.q.to(torch.float32) + m.zero.to(torch.float32)) * scale
        cand = beta1 * m1 + (1.0 - beta1) * gb
        lim = headroom * spec.qmax * scale
        # the quantizer clamps absmax to 1e-12: a scale at (or under) the
        # floor encodes an all-zero block, not a fitted regime
        fitted = torch.broadcast_to(scale * spec.qmax > 2e-12, gb.shape)
        hits.append(torch.sum((cand.abs() > lim) & fitted))
        valid.append(torch.sum(fitted))
    if not hits:
        return None
    n = torch.sum(torch.stack(valid)).to(torch.float32)
    return torch.sum(torch.stack(hits)).to(torch.float32) / n.clamp_min(1.0)


def grad_quant_health(grads, moments, m1_spec: Optional[QuantSpec],
                      err_spec: Optional[QuantSpec],
                      beta1: float = 0.9) -> Dict[str, torch.Tensor]:
    """The quant-health metrics the train step emits for the sentinel:
    ``grad_sat`` (:func:`moment_saturation_rate` against the stored m1
    scales) and ``grad_qerr`` (:func:`relative_quant_error` of the
    concatenated 2-D+ gradient leaves under ``err_spec``)."""
    out: Dict[str, torch.Tensor] = {}
    sat = moment_saturation_rate(grads, moments, m1_spec, beta1)
    if sat is not None:
        out["grad_sat"] = sat
    if err_spec is not None:
        flat = [g.to(torch.float32).reshape(-1)
                for g in tree_flatten(grads)[0] if g.ndim >= 2]
        if flat:
            out["grad_qerr"] = relative_quant_error(torch.cat(flat),
                                                    err_spec)
    return out


def m_sharpness(loss_fn: Callable, params, batch,
                generator: torch.Generator, rho: float = 0.05,
                n_samples: int = 8) -> torch.Tensor:
    """m-sharpness (Foret et al. 2021) via the worst of n random
    filter-normalized perturbations: max_eps<=rho L(params + eps) -
    L(params).  ``loss_fn(params, batch) -> scalar``; each leaf's noise is
    scaled by the leaf's norm (filter normalization, Li et al. 2018).  The
    noise comes from ``generator`` (on the params' device), where the
    reference splits a key: the draws differ between the packages."""
    leaves, struct = tree_flatten(params)
    base = loss_fn(params, batch)
    losses = []
    for _ in range(n_samples):
        perturbed = []
        for leaf in leaves:
            noise = torch.randn(leaf.shape, generator=generator,
                                dtype=torch.float32, device=leaf.device)
            nn = torch.linalg.norm(noise.reshape(-1)) + 1e-12
            ln = torch.linalg.norm(leaf.to(torch.float32).reshape(-1))
            perturbed.append((leaf + (rho * ln / nn) * noise).to(leaf.dtype))
        losses.append(loss_fn(tree_unflatten(struct, perturbed), batch))
    return torch.amax(torch.stack(losses)) - base
