"""Decode attention: the wrapper of the CUDA kernel and its plain version.

``decode_attention`` launches ``csrc/decode_attention.cu`` (which replaces
the TPU kernel ``repro/kernels/decode_attention/decode_attention.py:
decode_attention_kernel``) for CUDA tensors and runs
``decode_attention_ref`` for CPU tensors; nothing else chooses between
them. ``decode_attention.launches`` counts calls of the kernel's C entry,
which launches the split-key kernel and its combine pass.
``decode_attention_split_ref`` models that split and combine in plain
PyTorch, for the tests.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.kernels import _build, count_launches, runs_plain

HEAD_DIMS = (16, 64, 128)
MAX_GROUP = 32          # query heads per KV head the kernel holds
KV_CODES = {torch.float32: 0, torch.bfloat16: 1}   # the kernels' kv_dtype
# keys a block of the kernels reads: split j covers the absolute positions
# [j * SPLIT, (j + 1) * SPLIT). Must equal csrc/decode_tile.cuh's SPLIT:
# the C entries derive the split count from theirs and write that many
# partials into the scratch sized from this one
SPLIT = 128


def split_scratch(q, length: int):
    """The kernels' f32 partials for a cache of ``length`` rows: (m, l,
    acc[h]) per (slot, query head, split), ceil(length / SPLIT) splits."""
    B, N, h = q.shape
    return torch.empty(B * N * -(-length // SPLIT) * (h + 2),
                       dtype=torch.float32, device=q.device)


def slot_index(index, B: int, device) -> torch.Tensor:
    """A decode position (int, 0-d or [B] tensor) as a [B] int32 tensor on
    ``device`` (the tensor itself when it already is one)."""
    if (isinstance(index, torch.Tensor) and index.dtype == torch.int32
            and index.shape == (B,) and index.device == device
            and index.is_contiguous()):
        return index
    if isinstance(index, int):     # a fill, not a copy from the host
        return torch.full((B,), index, dtype=torch.int32, device=device)
    idx = torch.as_tensor(index, dtype=torch.int32, device=device)
    return idx.reshape(-1).expand(B).contiguous()


def cuda_stream(device) -> int:
    """The handle of PyTorch's current stream on a CUDA ``device``, for a
    C entry's stream argument."""
    return torch._C._cuda_getCurrentRawStream(device.index)


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


def decode_attention_split_ref(q, k_cache, v_cache, index,
                               window: int = GLOBAL_WINDOW,
                               split: int = SPLIT):
    """Plain model of the kernels' split and combine, for the tests: f32
    partials (m, l, acc) of each split [j * split, (j + 1) * split) of
    absolute positions, then out = sum_j e^(m_j - M) acc_j / max(sum_j
    e^(m_j - M) l_j, 1e-30) over the splits holding a live key. Same
    arguments and result as ``decode_attention_ref``."""
    B, N, h = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    G = N // K
    ns = -(-S // split)
    idx = slot_index(index, B, q.device).long()
    kpos = torch.arange(ns * split, device=q.device)
    valid = (kpos[None] <= idx[:, None]) & (kpos[None] < S)   # [B, ns*split]
    if window != GLOBAL_WINDOW:
        valid &= (idx[:, None] - kpos[None]) < window
    pad = (0, 0, 0, 0, 0, ns * split - S)
    kf = torch.nn.functional.pad(k_cache.float(), pad)
    vf = torch.nn.functional.pad(v_cache.float(), pad)
    qg = q.float().reshape(B, K, G, h)
    s = torch.einsum("bkgh,btkh->bkgt", qg, kf) * (1.0 / math.sqrt(h))
    s = torch.where(valid[:, None, None], s, -1e30)
    s = s.reshape(B, K, G, ns, split)
    vmask = valid.reshape(B, 1, 1, ns, split)
    m = s.amax(-1)                                          # [B,K,G,ns]
    p = torch.exp(s - m[..., None]) * vmask
    l = p.sum(-1)
    v = torch.where(valid[:, :, None, None], vf, 0.0)
    acc = torch.einsum("bkgjt,bjtkh->bkgjh", p,
                       v.reshape(B, ns, split, K, h))
    live = vmask.any(-1)                                    # [B,1,1,ns]
    big = torch.where(live, m, -1e30).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - big), 0.0)
    out = (w[..., None] * acc).sum(-2) \
        / (w * l).sum(-1, keepdim=True).clamp(min=1e-30)
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
    ks, vs = k_cache.stride(), v_cache.stride()
    if ks[1:] != (K * h, h, 1) or vs != ks:
        raise ValueError("cache view rows must be contiguous "
                         "[L,K,h] with one slot stride for K and V")
    if (k_cache.data_ptr() | v_cache.data_ptr()
            | ks[0] * k_cache.element_size()) % 16:
        raise ValueError("cache view must be 16-byte aligned")
    return ks[0]


def decode_attention(q, k_cache, v_cache, index, *,
                     window: int = GLOBAL_WINDOW):
    """Single-token GQA flash decode. q [B,N,h] f32/bf16; caches [B,S,K,h]
    f32/bf16; index: position of the token being decoded, int or per-slot [B]
    (each < S). Returns [B,N,h] in q's dtype; head n reads KV head n // G.
    """
    _check(q, k_cache, v_cache)
    dev = q.device
    if runs_plain(q):
        return decode_attention_ref(q, k_cache, v_cache, index, window)
    B, N, h = q.shape
    _, S, K, _ = k_cache.shape
    q = q.contiguous()
    idx = slot_index(index, B, dev)
    scratch = split_scratch(q, S)
    out = torch.empty_like(q)
    _build.launch("decode_attention_launch", q.data_ptr(),
                  k_cache.data_ptr(), v_cache.data_ptr(), idx.data_ptr(),
                  scratch.data_ptr(), out.data_ptr(),
                  int(q.dtype == torch.bfloat16), KV_CODES[k_cache.dtype], B,
                  S, N, K, h, kv_batch_stride(k_cache, v_cache), int(window),
                  cuda_stream(dev))
    count_launches(decode_attention)
    return out


decode_attention.launches = 0
