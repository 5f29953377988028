"""Quantization core of the port: configs, the integer codec, the Fig-1
linears, the layer-aware policy and the training diagnostics."""
from repro_torch.core.qconfig import (PRESETS, Granularity, QuantRecipe,
                                      QuantSpec, RoundMode,
                                      beyond_paper_recipe, fp_baseline,
                                      get_recipe, paper_recipe,
                                      paper_recipe_wag8, parse_recipe,
                                      parse_spec)
from repro_torch.core.qadam import QState
from repro_torch.core.qlinear import (int8_backend_supported,
                                      int8_bwd_supported,
                                      int8_quantized_linear, quantized_linear)
from repro_torch.core.qpolicy import (FP_POLICY, KERNEL_BACKENDS, LinearCtx,
                                      PolicyRule, QuantPolicy, ROLES,
                                      as_policy, fallback_policy,
                                      parse_policy)
from repro_torch.core.quantizer import (compute_scale_zero, dequantize_int,
                                        fake_quant, fake_quant_nograd,
                                        maybe_fake_quant, quantize_int)

__all__ = [
    "Granularity", "QuantRecipe", "QuantSpec", "RoundMode",
    "beyond_paper_recipe", "fp_baseline", "get_recipe", "paper_recipe",
    "paper_recipe_wag8", "parse_recipe", "parse_spec", "PRESETS",
    "QState", "quantized_linear", "int8_backend_supported",
    "int8_bwd_supported", "int8_quantized_linear",
    "FP_POLICY", "KERNEL_BACKENDS", "LinearCtx", "PolicyRule", "QuantPolicy",
    "ROLES", "as_policy", "fallback_policy", "parse_policy",
    "compute_scale_zero", "dequantize_int", "fake_quant", "fake_quant_nograd",
    "maybe_fake_quant", "quantize_int",
]
