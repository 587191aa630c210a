"""Banded chunk-prefill attention (CUDA kernel + plain version)."""
from repro_torch.kernels.chunk_prefill.ops import (chunk_prefill_attention,
                                                   chunk_prefill_ref)

__all__ = ["chunk_prefill_attention", "chunk_prefill_ref"]
