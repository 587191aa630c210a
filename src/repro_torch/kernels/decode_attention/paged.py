"""Paged decode attention: the wrapper of the CUDA kernel and its plain
versions.

``paged_decode_attention`` launches ``csrc/paged_decode_attention.cu``
(which replaces the TPU kernel ``repro/kernels/decode_attention/paged.py:
paged_decode_attention_kernel``) for CUDA tensors and runs the plain
``paged_decode_attention_ref`` / ``paged_decode_attention_quant_ref`` for
CPU tensors; nothing else chooses between them. The scales' ``ndim``
selects the variant, as in the reference: none (f32/bf16 pages), ``[P, K]``
per (page, KV head), or ``[P, page_size, K]`` per row.
``paged_decode_attention.launches`` counts calls of the kernel's C entry,
which launches the split-key kernel and its combine pass.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.kernels import _build, count_launches, runs_plain
from repro_torch.kernels.decode_attention.ops import (HEAD_DIMS, MAX_GROUP,
                                                      decode_attention_ref,
                                                      cuda_stream,
                                                      slot_index,
                                                      split_scratch)

PAGE_SIZE = 32          # the kernel's tile: one page per tile
# the kernel's kv_dtype codes; int8/fp8 pages hold codes with f32 scales
PAGE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}
QUANTIZED = (torch.int8, torch.float8_e4m3fn)


def gather_pages(pages, page_table):
    """The dense per-slot view of a paged cache: pages [P, ps, K, h] and
    page_table [B, npg] -> [B, npg*ps, K, h] (logical position p*ps + o is
    row o of page page_table[b, p])."""
    B, npg = page_table.shape
    g = pages[page_table.long()]                       # [B, npg, ps, K, h]
    return g.reshape(B, npg * pages.shape[1], *pages.shape[2:])


def gather_scales(scales, page_table, page_size: int):
    """Per-position scales [B, npg*ps, K, 1] from pool scales [P, K] (every
    row of a page carries the page's scale) or [P, ps, K] (each row its
    own): the factor that dequantizes ``gather_pages``' output."""
    g = scales[page_table.long()]              # [B,npg,K] or [B,npg,ps,K]
    B, npg = page_table.shape
    if scales.dim() == 3:
        return g.reshape(B, npg * page_size, scales.shape[-1])[..., None]
    return g.repeat_interleave(page_size, dim=1)[..., None]


def gather_dequant(k_pages, v_pages, page_table, k_scales=None,
                   v_scales=None):
    """Dense per-slot K/V views of a paged pool, dequantized to f32
    (``code * scale``) when scales are given."""
    ps = k_pages.shape[1]
    kd = gather_pages(k_pages, page_table)
    vd = gather_pages(v_pages, page_table)
    if k_scales is not None:
        kd = kd.float() * gather_scales(k_scales, page_table, ps)
        vd = vd.float() * gather_scales(v_scales, page_table, ps)
    return kd, vd


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, index,
                               window: int = GLOBAL_WINDOW):
    """Plain version for f32/bf16 pages: gather the pages into the dense
    layout and run the dense plain version (f32 softmax)."""
    return decode_attention_ref(q, gather_pages(k_pages, page_table),
                                gather_pages(v_pages, page_table), index,
                                window)


def paged_decode_attention_quant_ref(q, k_pages, v_pages, k_scales,
                                     v_scales, page_table, index,
                                     window: int = GLOBAL_WINDOW):
    """Plain version for int8/fp8 pages: gather codes and scales through
    the page table, dequantize in f32 (the kernel's arithmetic), then run
    the dense plain version."""
    kd, vd = gather_dequant(k_pages, v_pages, page_table, k_scales,
                            v_scales)
    return decode_attention_ref(q, kd, vd, index, window)


def _check(q, k_pages, v_pages, page_table, k_scales, v_scales):
    if (k_scales is None) != (v_scales is None):
        raise ValueError("pass both k_scales and v_scales, or neither")
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode_attention wants q [B,N,h] and pages "
                         f"[P,ps,K,h]; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, N, h = q.shape
    P, ps, K, hk = k_pages.shape
    if hk != h or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError("q, pages and page_table disagree on batch or "
                         "head_dim")
    if N % K or N // K > MAX_GROUP:
        raise ValueError(f"query heads {N} must be a multiple of KV heads "
                         f"{K}, at most {MAX_GROUP} per KV head")
    if h not in HEAD_DIMS:
        raise ValueError(f"head_dim {h} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype not in PAGE_CODES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"pages must be one of {list(PAGE_CODES)} (one type "
                        f"for K and V), got {k_pages.dtype}, {v_pages.dtype}")
    if (k_pages.dtype in QUANTIZED) != (k_scales is not None):
        raise TypeError("int8/fp8 pages need f32 scales, and only they do")
    if k_scales is not None:
        want = {2: (P, K), 3: (P, ps, K)}.get(k_scales.dim())
        if (want is None or tuple(k_scales.shape) != want
                or v_scales.shape != k_scales.shape
                or k_scales.dtype != torch.float32
                or v_scales.dtype != torch.float32):
            raise ValueError(f"scales must be f32 [P,K] or [P,ps,K]; got "
                             f"{tuple(k_scales.shape)} {k_scales.dtype}")
    devs = {t.device for t in (q, k_pages, v_pages, page_table)
            if t is not None}
    if k_scales is not None:
        devs |= {k_scales.device, v_scales.device}
    if len(devs) != 1:
        raise ValueError("q, pages, scales and page_table must be on one "
                         "device")


def _launchable(t, align: int = 16):
    """The device address of a contiguous tensor the kernel reads; pages
    are read 16 bytes at a time, scales one f32 at a time."""
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"pages and scales must be contiguous and "
                         f"{align}-byte aligned")
    return t.data_ptr()


def paged_decode_attention(q, k_pages, v_pages, page_table, index, *,
                           k_scales=None, v_scales=None,
                           window: int = GLOBAL_WINDOW):
    """Single-token GQA flash decode through a page table. q [B,N,h]
    f32/bf16; pages [P, page_size, K, h] f32/bf16, or int8/fp8 codes with
    f32 ``k_scales``/``v_scales`` [P, K] or [P, page_size, K]; page_table
    [B, npg] int; index int or per-slot [B] (each < npg * page_size).
    Returns [B,N,h] in q's dtype; head n reads KV head n // G. The kernel
    takes page_size 32 only and raises on any other."""
    _check(q, k_pages, v_pages, page_table, k_scales, v_scales)
    dev = q.device
    if runs_plain(q):
        if k_scales is None:
            return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                              index, window)
        return paged_decode_attention_quant_ref(q, k_pages, v_pages, k_scales,
                                                v_scales, page_table, index,
                                                window)
    B, N, h = q.shape
    _, ps, K, _ = k_pages.shape
    if ps != PAGE_SIZE:
        raise ValueError(f"the paged decode kernel takes page_size "
                         f"{PAGE_SIZE} (one page per tile), got {ps}")
    q = q.contiguous()
    pt = page_table.to(torch.int32).contiguous()
    idx = slot_index(index, B, dev)
    scratch = split_scratch(q, pt.shape[1] * ps)
    out = torch.empty_like(q)
    scale_mode = 0 if k_scales is None else k_scales.dim() - 1
    ks = 0 if k_scales is None else _launchable(k_scales, 4)
    vs = 0 if v_scales is None else _launchable(v_scales, 4)
    _build.launch("paged_decode_attention_launch", q.data_ptr(),
                  _launchable(k_pages), _launchable(v_pages), ks, vs,
                  pt.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                  out.data_ptr(), int(q.dtype == torch.bfloat16),
                  PAGE_CODES[k_pages.dtype], scale_mode, B, N, K, h, ps,
                  pt.shape[1], int(window), cuda_stream(dev))
    count_launches(paged_decode_attention)
    return out


paged_decode_attention.launches = 0
