"""Token samplers for the serving path (the port of
``repro.serving.sampler``).

Temperature sampling is the Gumbel-max form of a categorical draw:
``argmax(l / T + g)`` with ``g = -log(-log(u))``. The uniforms ``u`` are
counter-based: a hash of (row key, position, vocabulary id), so a row's
draw depends on nothing but its own key and position, never on how many
other draws ran before it (masked tick steps, tick sizes, other slots), and
it is made on the logits' device without a host sync. ``noise`` injects
``g`` directly, so a test can hand both frameworks the same draw.
``spec_accept`` comes with speculative decode (ROADMAP item 9).
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def greedy(logits):
    """logits [B,1,V] -> argmax tokens [B] (int64)."""
    return logits[:, -1].argmax(-1)


def _mul32(x, c: int):
    """(x * c) mod 2**32 for int64 tensors x in [0, 2**32), without leaving
    the int64 range: the high half of x is multiplied mod 2**16 first."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """An invertible 32-bit integer mix (xor-shift / multiply rounds) on
    int64 tensors holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel(keys, pos, vocab: int):
    """Standard Gumbel noise [B, vocab] for rows with int keys [B] at
    positions [B]: ``u`` in (0, 1) from 24 bits of a hash of (key, pos,
    vocabulary id), on the keys' device."""
    keys = torch.as_tensor(keys).long() & _M32
    pos = torch.as_tensor(pos, device=keys.device).long() & _M32
    row = _hash32(_hash32(keys) ^ _hash32((pos + 0x9E3779B9) & _M32))
    col = _hash32(torch.arange(vocab, device=keys.device) + 0x85EBCA6B)
    bits = _hash32(row[:, None] ^ col[None, :]) >> 8
    u = (bits.float() + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def sample(logits, noise, temperature: float = 1.0, top_k: int = 0):
    """Temperature + optional top-k sampling with Gumbel ``noise`` [B,V].
    logits [B,1,V] -> [B]."""
    if temperature <= 0:
        return greedy(logits)
    l = logits[:, -1].float() / temperature
    if top_k:
        kth = torch.sort(l, dim=-1).values[:, -top_k][:, None]
        l = torch.where(l < kth, -1e30, l)
    return (l + noise).argmax(-1)


def sample_token(logits, temperature: float = 0.0, top_k: int = 0,
                 keys=None, pos=None, noise=None):
    """The sampler of the engine's decode tick: logits [B,1,V] -> tokens
    [B]; temperature <= 0 selects greedy (no draw), else the noise is
    ``noise`` or ``gumbel(keys, pos, V)``."""
    if temperature <= 0:
        return greedy(logits)
    if noise is None:
        noise = gumbel(keys, pos, logits.shape[-1])
    return sample(logits, noise, temperature, top_k)
