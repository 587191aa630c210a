"""Flash attention over fresh rows: the wrapper of the CUDA kernel, its
plain version, and the autograd Function the training forward runs.

``flash_attention`` launches ``csrc/flash_attention.cu`` (which replaces
the TPU kernel ``repro/kernels/flash_attention/flash_attention.py:
flash_attention_kernel``) for CUDA tensors and runs the plain
``attention_ref`` for CPU tensors; nothing else chooses between them.
``flash_attention.launches`` counts the kernel's launches. Both sides go
through ``FlashAttention``, whose backward is the attention gradient
written out in tensor operations from the saved log-sum-exp (the TPU
kernel is forward only; a backward kernel is later work).

Like the TPU kernel's grid, which takes ``S // min(128, S)`` query blocks,
a sequence (of queries or of keys) longer than 128 must be a multiple of
128: the reference leaves the rows past the last whole block unwritten, so
the wrapper refuses such lengths.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import GLOBAL_WINDOW
from repro_torch.kernels import _build, count_launches, runs_plain

BLOCK = 128                     # the TPU kernel's block: the length rule
HEAD_DIMS = (16, 64, 128)       # head widths the kernel is built for
DTYPES = (torch.float32, torch.bfloat16)
NEG_INF = -1e30


def _mask(S: int, Sk: int, window: int, causal: bool, device):
    """[S, Sk] bool: row s sees key t (positions from 0 on both axes)."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None]
    mask = torch.ones(S, Sk, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window != GLOBAL_WINDOW:
        mask &= (qpos - kpos) < window
    return mask


def _scores(q, k, window: int, causal: bool):
    """Masked f32 logits [B,K,G,S,Sk] as the oracle forms them: q scaled
    in its own type, the grouped product, then f32."""
    B, S, N, h = q.shape
    K = k.shape[2]
    qg = (q * (1.0 / math.sqrt(h))).reshape(B, S, K, N // K, h)
    s = torch.einsum("bskgh,btkh->bkgst", qg, k).float()
    return torch.where(_mask(S, k.shape[1], window, causal, q.device), s,
                       NEG_INF)


def attention_ref(q, k, v, window: int = GLOBAL_WINDOW, causal: bool = True):
    """Plain version (the oracle ``repro/kernels/flash_attention/ref.py:
    attention_ref``): q [B,S,N,h]; k, v [B,Sk,K,h] (GQA). f32 softmax,
    returns q's dtype."""
    B, S, N, h = q.shape
    w = torch.softmax(_scores(q, k, window, causal), dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(B, S, N, h)


def _attention_lse(q, k, v, window: int, causal: bool):
    """``attention_ref`` and each row's f32 log-sum-exp [B,N,S]."""
    B, S, N, h = q.shape
    s = _scores(q, k, window, causal)
    lse = torch.logsumexp(s, dim=-1)                        # [B,K,G,S]
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v).reshape(B, S, N, h)
    return out, lse.reshape(B, N, S)


def check_len(n: int, what: str) -> None:
    """The TPU kernel's length rule: at most one block, or whole blocks."""
    if n <= 0 or (n > BLOCK and n % BLOCK):
        raise ValueError(f"flash attention over {n} {what}: a sequence "
                         f"longer than {BLOCK} must be a multiple of "
                         f"{BLOCK} (the kernel's blocks)")


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q [B,S,N,h] and k, v "
                         f"[B,Sk,K,h]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, N, h = q.shape
    if k.shape[0] != B or k.shape[3] != h or N % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch or head_dim, or N is not a "
                         f"multiple of K")
    check_len(S, "query rows")
    check_len(k.shape[1], "keys")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _aligned(t):
    """``t`` contiguous with 16-byte aligned data (the kernel's vector
    loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, window: int, causal: bool):
    """One kernel launch on the current stream -> (out, lse [B,N,S] f32)."""
    B, S, N, h = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if h not in HEAD_DIMS:
        raise ValueError(f"head_dim {h} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one type, float32 or "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty(B, N, S, dtype=torch.float32, device=q.device)
    _build.launch("flash_attention_launch", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                  int(q.dtype == torch.bfloat16), B, S, Sk, N, K, h,
                  int(window), int(causal),
                  torch.cuda.current_stream(q.device).cuda_stream)
    count_launches(flash_attention)
    return out, lse


def attention_grad(q, k, v, out, lse, dout, window: int, causal: bool):
    """The attention gradient from the saved log-sum-exp, in f32 tensor
    operations: P = exp(s - lse) on live lanes, dV = P^T dO, dP = dO V^T,
    dS = P (dP - rowsum(dO O)), dQ = dS K / sqrt(h), dK = dS^T Q / sqrt(h),
    with dK and dV summed over the G query heads of each KV head. P is
    [B,K,G,S,Sk] in f32 for one layer at a time. Returns (dq, dk, dv) in
    the inputs' types."""
    B, S, N, h = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = N // K
    scale = 1.0 / math.sqrt(h)
    qf = q.float().reshape(B, S, K, G, h)
    kf, vf = k.float(), v.float()
    do = dout.float().reshape(B, S, K, G, h)
    mask = _mask(S, Sk, window, causal, q.device)
    s = torch.einsum("bskgh,btkh->bkgst", qf, kf) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(B, K, G, S, 1)), 0.0)
    del s
    dv = torch.einsum("bkgst,bskgh->btkh", p, do)
    dp = torch.einsum("bskgh,btkh->bkgst", do, vf)
    delta = (do * out.float().reshape(B, S, K, G, h)).sum(-1)   # [B,S,K,G]
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    del p, dp
    dq = torch.einsum("bkgst,btkh->bskgh", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgh->btkh", ds, qf) * scale
    return (dq.reshape(B, S, N, h).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel on the card, ``attention_ref`` (with its
    log-sum-exp) on the CPU. Backward: ``attention_grad``."""

    @staticmethod
    def forward(ctx, q, k, v, window: int, causal: bool):
        if runs_plain(q):
            out, lse = _attention_lse(q, k, v, window, causal)
        else:
            out, lse = _launch(q, k, v, window, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.window, ctx.causal = window, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_grad(q, k, v, out, lse, dout, ctx.window,
                                    ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, window: int = GLOBAL_WINDOW,
                    causal: bool = True):
    """Causal (or not) sliding-window GQA attention over fresh rows.
    q [B,S,N,h]; k, v [B,Sk,K,h], N % K == 0; S and Sk at most 128 or
    multiples of 128. The kernel for CUDA tensors (f32 or bf16, h in
    ``HEAD_DIMS``), ``attention_ref`` for CPU tensors; differentiable
    through ``FlashAttention``. Returns [B,S,N,h] in q's dtype."""
    _check(q, k, v)
    return FlashAttention.apply(q, k, v, int(window), bool(causal))


flash_attention.launches = 0
