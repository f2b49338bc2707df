"""Kernels of the port: each hand-written for Hopper, with its plain
PyTorch version beside it."""
from .flash_attention import (flash_attention, flash_backward,
                              flash_backward_dkv, flash_backward_dq,
                              flash_forward)
from .fused import (dal_backward, dal_backward_plain, dal_forward,
                    dal_forward_plain, fused_dropout_add_layernorm,
                    int8_matmul, int8_matmul_plain, int8_mm,
                    keep_mask_plain)
from .groupnorm import (fused_group_norm, fused_group_norm_bwd,
                        fused_group_norm_bwd_plain, fused_group_norm_fwd,
                        fused_group_norm_fwd_plain)
from .paged_attention import (DEFAULT_PAGE_SIZE, paged_decode_attention,
                              paged_ragged_attention,
                              paged_ragged_attention_plain)

__all__ = ["DEFAULT_PAGE_SIZE", "dal_backward", "dal_backward_plain",
           "dal_forward", "dal_forward_plain", "flash_attention",
           "flash_backward", "flash_backward_dkv", "flash_backward_dq",
           "flash_forward", "fused_dropout_add_layernorm",
           "fused_group_norm", "fused_group_norm_bwd",
           "fused_group_norm_bwd_plain", "fused_group_norm_fwd",
           "fused_group_norm_fwd_plain", "int8_matmul", "int8_matmul_plain",
           "int8_mm", "keep_mask_plain",
           "paged_decode_attention", "paged_ragged_attention",
           "paged_ragged_attention_plain"]
