"""Quantized KV page format: int8 / fp8 pool leaves with per-page scales
(the port of ``repro.models.kv_quant``).

- ``kv_dtype`` names the pool storage: ``"bf16"`` (unquantized: pages keep
  the cache dtype the caller picks, f32 in the serving engine), ``"int8"``
  (symmetric codes in [-127, 127]) or ``"fp8"`` (``float8_e4m3fn``, max
  448).
- A quantized K/V pool leaf ``[num_pages, page_size, K, h]`` has a sibling
  f32 scale leaf: ``"head"`` granularity stores ``[num_pages, K]`` (one
  scale per (page, KV head)), ``"token"`` stores ``[num_pages, page_size,
  K]`` (one per row). A code ``c`` stands for ``c * scale``.
- Scales are amax-derived (``amax / qmax``); an all-zero page has scale 0
  and codes 0 (``EPS`` guards the division).

Rounding follows the reference: int8 rounds half to even (``torch.round``
as ``jnp.round``) and clips to +-127; fp8 clamps to +-448 first, then
casts with round-to-nearest-even. ``fake_quantize_tree`` comes with
speculative decode (ROADMAP item 9).
"""
from __future__ import annotations

from typing import Optional

import torch

KV_DTYPES = ("bf16", "int8", "fp8")
SCALE_GRANULARITIES = ("head", "token")

# guard against 0/0 on all-zero pages; far below any real KV magnitude
EPS = 1e-30
FP8_MAX = 448.0                 # torch.finfo(torch.float8_e4m3fn).max


def quant_dtype(kv_dtype: str) -> Optional[torch.dtype]:
    """Pool storage dtype for a ``kv_dtype`` name; None means unquantized."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, "
                         f"got {kv_dtype!r}")
    return {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(kv_dtype)


def is_quantized(dtype) -> bool:
    """Whether a tensor dtype is a quantized pool storage dtype."""
    return dtype in (torch.int8, torch.float8_e4m3fn)


def qmax(dtype) -> float:
    """Largest code magnitude of a storage dtype (int8: 127, fp8: 448)."""
    if dtype == torch.int8:
        return 127.0
    if dtype == torch.float8_e4m3fn:
        return FP8_MAX
    raise ValueError(f"not a quantized KV dtype: {dtype}")


def amax_scale(rows, dtype, granularity: str = "head"):
    """Amax scale of page rows ``[..., ps, K, h]``: ``"head"`` reduces the
    row and head-dim axes -> ``[..., K]``; ``"token"`` only the head-dim
    axis -> ``[..., ps, K]``."""
    dims = (-3, -1) if granularity == "head" else (-1,)
    return rows.float().abs().amax(dim=dims) / qmax(dtype)


def encode(x, scale, dtype):
    """Codes of ``x`` under ``scale`` (broadcastable); scale 0 gives 0."""
    y = x.float() / torch.clamp(scale, min=EPS)
    if dtype == torch.int8:
        return torch.clamp(torch.round(y), -127.0, 127.0).to(torch.int8)
    return torch.clamp(y, -FP8_MAX, FP8_MAX).to(dtype)


def decode(codes, scale):
    """Codes back to f32 under ``scale`` (broadcastable)."""
    return codes.float() * scale


def quantize_page_rows(rows, dtype, granularity: str = "head"):
    """Quantize page rows ``[..., ps, K, h]`` in one shot. Returns
    ``(codes, scales)``, scales ``[..., K]`` ("head") or ``[..., ps, K]``
    ("token")."""
    scales = amax_scale(rows, dtype, granularity)
    bcast = (scales[..., None, :, None] if granularity == "head"
             else scales[..., None])
    return encode(rows, bcast, dtype), scales
