"""Gradient compression: per-tensor int8 quantization with error feedback
(the port's copy of ``repro.training.compress``). The residual is carried
in the train state, so compression error does not bias the long-run
gradient estimate.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import map_tree


def quantize_int8(x):
    """(codes int8, scale): round half to even, as ``jnp.round``."""
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_grads(grads, error_state):
    """Quantize grads + error feedback. Returns (decompressed, new_error)."""
    def one(g, e):
        g32 = g.float() + e
        q, s = quantize_int8(g32)
        dq = dequantize_int8(q, s)
        return dq.to(g.dtype), g32 - dq
    out = map_tree(one, grads, error_state)
    return (map_tree(lambda t: t[0], out), map_tree(lambda t: t[1], out))


def init_error_state(params):
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
