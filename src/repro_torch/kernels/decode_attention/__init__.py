"""Single-token GQA decode attention over a dense cache or a page pool
(CUDA kernels + plain versions)."""
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_ref)
from repro_torch.kernels.decode_attention.paged import (
    paged_decode_attention, paged_decode_attention_quant_ref,
    paged_decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_ref",
           "paged_decode_attention", "paged_decode_attention_quant_ref",
           "paged_decode_attention_ref"]
