"""Hand-written Hopper kernels of the port (CUDA C++ under ``csrc/``, built
and bound by ``_build``), each beside its plain PyTorch version and a
launch counter.  Importing this package builds nothing and needs no CUDA:
a kernel is built at its first launch."""
from repro_torch.kernels.decode_attn import (decode_attention,
                                             decode_attention_paged)
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attention_bwd_dkdv,
                                            flash_attention_bwd_dq,
                                            flash_attention_fwd,
                                            flash_attention_fwd_lse,
                                            flash_attention_fwd_q8)
from repro_torch.kernels.int8_matmul import (int8_matmul,
                                             int8_matmul_experts,
                                             int8_matmul_nt,
                                             int8_matmul_nt_experts,
                                             int8_matmul_tn,
                                             int8_matmul_tn_experts)
from repro_torch.kernels.opt_update import (fused_adamw_blocks,
                                            fused_adamw_leaves)
from repro_torch.kernels.qdq import qdq_row, qdq_scaled

#: every kernel wrapper of the port, each with a ``launches`` counter
KERNELS = (int8_matmul, flash_attention_fwd_q8, decode_attention,
           int8_matmul_nt, int8_matmul_tn, fused_adamw_blocks,
           fused_adamw_leaves, decode_attention_paged, qdq_row, qdq_scaled, flash_attention_fwd,
           flash_attention_fwd_lse, flash_attention_bwd_dkdv,
           flash_attention_bwd_dq, int8_matmul_experts,
           int8_matmul_nt_experts, int8_matmul_tn_experts)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


__all__ = ["KERNELS", "decode_attention", "decode_attention_paged",
           "flash_attention", "flash_attention_bwd_dkdv",
           "flash_attention_bwd_dq", "flash_attention_fwd",
           "flash_attention_fwd_lse", "flash_attention_fwd_q8",
           "fused_adamw_blocks", "fused_adamw_leaves", "int8_matmul",
           "int8_matmul_experts", "int8_matmul_nt",
           "int8_matmul_nt_experts", "int8_matmul_tn",
           "int8_matmul_tn_experts", "launch_counts", "qdq_row", "qdq_scaled",
           "reset_launch_counts"]
