"""Policy-driven quantized inference of the port: prepared int8 weights,
the int8 KV cache and the continuous-batching engine."""
from repro_torch.infer.engine import Engine, Request, Response
from repro_torch.infer.prepare import (params_nbytes, prepare_params,
                                       quantize_weight)
from repro_torch.infer.sampling import SamplingParams, sample
from repro_torch.infer.scheduler import Scheduler

__all__ = ["Engine", "Request", "Response", "params_nbytes",
           "prepare_params", "quantize_weight", "SamplingParams", "sample",
           "Scheduler"]
