"""Paged chunk-prefill attention: the wrapper of the CUDA kernel and its
plain version.

``paged_chunk_prefill_attention`` launches ``csrc/paged_chunk_prefill.cu``
(which replaces the TPU kernel ``repro/kernels/chunk_prefill/paged.py:
paged_chunk_prefill_attention_kernel``) for CUDA tensors and runs the plain
``paged_chunk_prefill_ref`` for CPU tensors; nothing else chooses between
them. The scales' ``ndim`` selects the variant, as in the reference: none
(f32/bf16 pages), ``[P, K]`` per (page, KV head), or ``[P, page_size, K]``
per row. ``paged_chunk_prefill_attention.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.kernels import _build, count_launches, runs_plain
from repro_torch.kernels.chunk_prefill.ops import chunk_prefill_ref
from repro_torch.kernels.decode_attention import paged as pg
from repro_torch.kernels.decode_attention.ops import slot_index


def paged_chunk_prefill_ref(q, k_pages, v_pages, page_table, index,
                            k_scales=None, v_scales=None,
                            window: int = GLOBAL_WINDOW):
    """Plain version: gather (and, for int8/fp8 pages, dequantize in f32)
    the slot's pages into the dense layout, then run the dense plain
    version. q [B,S,N,h]; returns [B,S,N,h] in q's dtype."""
    kd, vd = pg.gather_dequant(k_pages, v_pages, page_table, k_scales,
                               v_scales)
    return chunk_prefill_ref(q, kd, vd, index, window)


def paged_chunk_prefill_attention(q, k_pages, v_pages, page_table, index, *,
                                  k_scales=None, v_scales=None,
                                  window: int = GLOBAL_WINDOW):
    """Banded chunk-prefill attention through a page table. q [B,S,N,h]
    f32/bf16 (the chunk, already written to the pool); pages
    [P, page_size, K, h] f32/bf16, or int8/fp8 codes with f32
    ``k_scales``/``v_scales`` [P, K] or [P, page_size, K]; page_table
    [B, npg] int (the caller may slice npg to the live band); index int or
    per-slot [B] chunk starts. Key blocks are pages on the absolute
    partition, so a row's result does not depend on the chunking. Returns
    [B,S,N,h] in q's dtype. The kernel takes page_size 32 only and raises
    on any other."""
    if q.dim() != 4:
        raise ValueError(f"paged_chunk_prefill_attention wants q [B,S,N,h], "
                         f"got {tuple(q.shape)}")
    # the paged decode checks read q's per-row shape [B,N,h]
    pg._check(q[:, 0], k_pages, v_pages, page_table, k_scales, v_scales)
    if runs_plain(q):
        return paged_chunk_prefill_ref(q, k_pages, v_pages, page_table,
                                       index, k_scales, v_scales, window)
    B, S, N, h = q.shape
    ps, K = k_pages.shape[1], k_pages.shape[2]
    if ps != pg.PAGE_SIZE:
        raise ValueError(f"the paged chunk kernel takes page_size "
                         f"{pg.PAGE_SIZE} (one page per key block), got {ps}")
    q = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    idx = slot_index(index, B, q.device)
    out = torch.empty_like(q)
    scale_mode = 0 if k_scales is None else k_scales.dim() - 1
    ks = 0 if k_scales is None else pg._launchable(k_scales, 4)
    vs = 0 if v_scales is None else pg._launchable(v_scales, 4)
    _build.launch("paged_chunk_prefill_launch", q.data_ptr(),
                  pg._launchable(k_pages), pg._launchable(v_pages), ks, vs,
                  pt.data_ptr(), idx.data_ptr(), out.data_ptr(),
                  int(q.dtype == torch.bfloat16),
                  pg.PAGE_CODES[k_pages.dtype], scale_mode, B, S, N, K, h,
                  ps, pt.shape[1], int(window),
                  torch.cuda.current_stream(q.device).cuda_stream)
    count_launches(paged_chunk_prefill_attention)
    return out


paged_chunk_prefill_attention.launches = 0
