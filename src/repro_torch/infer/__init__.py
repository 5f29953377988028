"""Policy-driven quantized inference of the port: prepared int8 weights,
the int8 KV cache (dense strips or page pools), the continuous-batching
engine and its async scheduler."""
from repro_torch.infer.engine import (ENGINE_FAMILIES, PAGED_FAMILIES,
                                      Engine, Request, Response)
from repro_torch.infer.pages import (CapacityError, PagePool,
                                     init_paged_caches, page_nbytes,
                                     pages_for)
from repro_torch.infer.prepare import (params_nbytes, prepare_params,
                                       quantize_weight)
from repro_torch.infer.resilience import EngineMonitor, MonitorConfig
from repro_torch.infer.sampling import SamplingParams, sample
from repro_torch.infer.scheduler import Scheduler

__all__ = ["CapacityError", "ENGINE_FAMILIES", "Engine", "EngineMonitor",
           "MonitorConfig", "PAGED_FAMILIES", "PagePool", "Request", "Response", "SamplingParams", "Scheduler",
           "init_paged_caches", "page_nbytes", "pages_for", "params_nbytes",
           "prepare_params", "quantize_weight", "sample"]
