"""Single-token GQA decode attention (CUDA kernel + plain version)."""
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_ref"]
