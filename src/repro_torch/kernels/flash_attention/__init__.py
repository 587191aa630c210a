"""Flash attention over fresh rows (CUDA kernel + plain version +
autograd Function)."""
from repro_torch.kernels.flash_attention.ops import (FlashAttention,
                                                     attention_ref,
                                                     flash_attention)

__all__ = ["FlashAttention", "attention_ref", "flash_attention"]
