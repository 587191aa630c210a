"""Decode attention: the wrapper of the CUDA kernel and its plain version.

``decode_attention`` launches ``csrc/decode_attention.cu`` (which replaces
the TPU kernel ``repro/kernels/decode_attention/decode_attention.py:
decode_attention_kernel``) for CUDA tensors and runs
``decode_attention_ref`` for CPU tensors; nothing else chooses between
them. ``decode_attention.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.kernels import _build

HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 32          # query heads per KV head the kernel holds
KV_CODES = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' kv_dtype


def slot_index(index, B: int, device) -> torch.Tensor:
    """A decode position (int, 0-d or [B] tensor) as a [B] int32 tensor on
    ``device``."""
    idx = torch.as_tensor(index, dtype=torch.int32, device=device)
    return idx.reshape(-1).expand(B).contiguous()


def decode_attention_ref(q, k_cache, v_cache, index,
                         window: int = GLOBAL_WINDOW):
    """Plain version: one masked softmax over the whole cache, in f32.
    q [B,N,h]; caches [B,S,K,h]; index scalar or per-slot [B]. Returns
    [B,N,h] in q's dtype (f32 when q is f32)."""
    B, N, h = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = N // K
    idx = slot_index(index, B, q.device).long()
    kpos = torch.arange(S, device=q.device)
    valid = kpos[None] <= idx[:, None]                          # [B, S]
    if window != GLOBAL_WINDOW:
        valid &= (idx[:, None] - kpos[None]) < window
    qg = q.float().reshape(B, K, G, h)
    s = torch.einsum("bkgh,btkh->bkgt", qg, k_cache.float()) \
        * (1.0 / math.sqrt(h))
    s = torch.where(valid[:, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1) * valid[:, None, None]
    v = torch.where(valid[:, :, None, None], v_cache.float(), 0.0)
    out = torch.einsum("bkgt,btkh->bkgh", w, v)
    return out.reshape(B, N, h).to(q.dtype)


def _check(q, k_cache, v_cache):
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention wants q [B,N,h] and caches "
                         f"[B,S,K,h]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, N, h = q.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != h:
        raise ValueError("q and cache disagree on batch or head_dim")
    K = k_cache.shape[2]
    if N % K or N // K > MAX_GROUP:
        raise ValueError(f"query heads {N} must be a multiple of KV heads "
                         f"{K}, at most {MAX_GROUP} per KV head")
    if h not in HEAD_DIMS:
        raise ValueError(f"head_dim {h} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_cache.dtype not in KV_CODES or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"the KV cache must be float32 or bfloat16 (one "
                        f"type for K and V), got {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    if not (q.device == k_cache.device == v_cache.device):
        raise ValueError("q and the caches must be on one device")


def kv_batch_stride(k_cache, v_cache) -> int:
    """The slot stride of a cache view whose rows [L,K,h] are contiguous
    (a slice along the sequence axis keeps this layout without a copy)."""
    B, L, K, h = k_cache.shape
    for t in (k_cache, v_cache):
        if (t.stride(3), t.stride(2), t.stride(1)) != (1, h, K * h) \
                or t.stride(0) != k_cache.stride(0):
            raise ValueError("cache view rows must be contiguous "
                             "[L,K,h] with one slot stride for K and V")
        if t.data_ptr() % 16 or (t.stride(0) * t.element_size()) % 16:
            raise ValueError("cache view must be 16-byte aligned")
    return k_cache.stride(0)


def decode_attention(q, k_cache, v_cache, index, *,
                     window: int = GLOBAL_WINDOW):
    """Single-token GQA flash decode. q [B,N,h] f32/bf16; caches [B,S,K,h]
    f32/bf16; index: position of the token being decoded, int or per-slot [B]
    (each < S). Returns [B,N,h] in q's dtype; head n reads KV head n // G.
    """
    _check(q, k_cache, v_cache)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, index, window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, N, h = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    q = q.contiguous()
    idx = slot_index(index, B, q.device)
    out = torch.empty_like(q)
    _build.launch("decode_attention_launch", q.data_ptr(),
                  k_cache.data_ptr(), v_cache.data_ptr(), idx.data_ptr(),
                  out.data_ptr(), int(q.dtype == torch.bfloat16),
                  KV_CODES[k_cache.dtype], B, S, N, K, h,
                  kv_batch_stride(k_cache, v_cache), int(window),
                  torch.cuda.current_stream(q.device).cuda_stream)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
