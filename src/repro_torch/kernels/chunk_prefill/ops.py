"""Chunk-prefill attention: the wrapper of the CUDA kernel and its plain
version.

``chunk_prefill_attention`` launches ``csrc/chunk_prefill.cu`` (which
replaces the TPU kernel ``repro/kernels/chunk_prefill/chunk_prefill.py:
chunk_prefill_attention_kernel``) for CUDA tensors and runs
``chunk_prefill_ref`` for CPU tensors; nothing else chooses between them.
``chunk_prefill_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.kernels import _build, count_launches, runs_plain
from repro_torch.kernels.decode_attention.ops import (HEAD_DIMS, KV_CODES,
                                                      kv_batch_stride,
                                                      slot_index)

BLOCK_K = 32            # the kernel's key block (= ModelOptions.prefill_band)


def chunk_prefill_ref(q, k_cache, v_cache, index,
                      window: int = GLOBAL_WINDOW):
    """Plain version: one dense masked softmax over the whole view with
    absolute positions, in f32. q [B,S,N,h]; view [B,L,K,h]; index scalar
    or per-slot [B] chunk starts (row r of slot b sits at index[b] + r).
    Returns [B,S,N,h] in q's dtype."""
    B, S, N, h = q.shape
    L, K = k_cache.shape[1], k_cache.shape[2]
    G = N // K
    idx = slot_index(index, B, q.device).long()
    q_pos = idx[:, None] + torch.arange(S, device=q.device)      # [B, S]
    kpos = torch.arange(L, device=q.device)
    mask = kpos[None, None] <= q_pos[..., None]                   # [B, S, L]
    if window != GLOBAL_WINDOW:
        mask &= (q_pos[..., None] - kpos[None, None]) < window
    qg = q.float().reshape(B, S, K, G, h)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k_cache.float()) \
        * (1.0 / math.sqrt(h))
    s = torch.where(mask[:, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1) * mask[:, None, None]
    # lanes past every row's position may hold stale rows: zero them
    live = kpos[None] <= q_pos[:, -1:]                            # [B, L]
    v = torch.where(live[..., None, None], v_cache.float(), 0.0)
    out = torch.einsum("bkgst,btkh->bkgsh", w, v)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, N, h).to(q.dtype)


def _check(q, k_cache, v_cache, bk):
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"chunk_prefill_attention wants q [B,S,N,h] and a "
                         f"view [B,L,K,h]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, S, N, h = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != h:
        raise ValueError("q and cache view disagree on batch or head_dim")
    if N % k_cache.shape[2]:
        raise ValueError("query heads must be a multiple of KV heads")
    if h not in HEAD_DIMS:
        raise ValueError(f"head_dim {h} not in {HEAD_DIMS}")
    if bk != BLOCK_K:
        raise ValueError(f"key block bk={bk}; the kernel walks blocks of "
                         f"{BLOCK_K}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_cache.dtype not in KV_CODES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"the KV cache view must be float32 or bfloat16 "
                        f"(one type for K and V), got {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the cache view must be on one device")


def chunk_prefill_attention(q, k_cache, v_cache, index, *,
                            window: int = GLOBAL_WINDOW, bk: int = BLOCK_K):
    """Banded chunk-prefill attention. q [B,S,N,h] f32/bf16 (the chunk,
    already written to the cache); view [B,L,K,h] f32/bf16, rows contiguous (a
    sequence-axis slice of the cache); index int or per-slot [B] chunk
    starts. Key blocks of ``bk`` sit on the absolute partition from 0, so a
    row's result does not depend on the chunking. Returns [B,S,N,h]."""
    _check(q, k_cache, v_cache, bk)
    if runs_plain(q):
        return chunk_prefill_ref(q, k_cache, v_cache, index, window)
    B, S, N, h = q.shape
    L, K = k_cache.shape[1], k_cache.shape[2]
    q = q.contiguous()
    idx = slot_index(index, B, q.device)
    out = torch.empty_like(q)
    _build.launch("chunk_prefill_launch", q.data_ptr(), k_cache.data_ptr(),
                  v_cache.data_ptr(), idx.data_ptr(), out.data_ptr(),
                  int(q.dtype == torch.bfloat16), KV_CODES[k_cache.dtype],
                  B, S, L, N, K, h, bk,
                  kv_batch_stride(k_cache, v_cache), int(window),
                  torch.cuda.current_stream(q.device).cuda_stream)
    count_launches(chunk_prefill_attention)
    return out


chunk_prefill_attention.launches = 0
