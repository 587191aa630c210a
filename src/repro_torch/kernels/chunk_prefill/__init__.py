"""Banded chunk-prefill attention, dense and paged (CUDA kernels + plain
versions)."""
from repro_torch.kernels.chunk_prefill.ops import (chunk_prefill_attention,
                                                   chunk_prefill_ref)
from repro_torch.kernels.chunk_prefill.paged import (
    paged_chunk_prefill_attention, paged_chunk_prefill_ref)

__all__ = ["chunk_prefill_attention", "chunk_prefill_ref",
           "paged_chunk_prefill_attention", "paged_chunk_prefill_ref"]
