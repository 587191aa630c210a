"""The DiT action head (the paper's third subsystem, §2 "Action
Transformer"), the port of ``repro.models.action``.

- discrete: action tokens live in the LM vocabulary; action generation is
  continued autoregressive decode (``core.vla``). No extra parameters.
- dit: a small Diffusion Transformer decodes a continuous [horizon,
  action_dim] trajectory, conditioned (AdaLN) on the embedding of the last
  CoT token, over ``dit_steps`` denoising steps.

Plain functions over the parameter dict, like the rest of ``models``; the
leaves and shapes are the reference's (``params.from_jax`` carries them
across). Types follow the reference: the timestep embedding, the RMS norm
and the attention softmax run in f32 and are cast back; GELU is the tanh
approximation (``jax.nn.gelu``'s default). With f32 weights every
activation is f32, as in the reference. With bf16 weights the residual
stream runs in bf16 and the denoising carry stays in f32, the type the
reference's update ``x - eps / dit_steps`` promotes it to.

The DiT attends over ``horizon`` rows (8 at full width): plain tensor ops,
no kernel, as in the reference (``einsum``, no Pallas call).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ActionConfig
from repro_torch.models.params import PSpec, stack

T_EMBED = 256          # width of the sinusoidal timestep embedding


def dit_template(a: ActionConfig, d_lm: int) -> Dict:
    d, n = a.dit_d_model, a.dit_heads
    h = d // n
    layer = {
        "ada": PSpec((d, 6 * d), (None, None), "zeros"),    # AdaLN-zero
        "wq": PSpec((d, n, h), (None, "heads", "head_dim"), fan_in=d),
        "wk": PSpec((d, n, h), (None, "heads", "head_dim"), fan_in=d),
        "wv": PSpec((d, n, h), (None, "heads", "head_dim"), fan_in=d),
        "wo": PSpec((n, h, d), ("heads", "head_dim", None), fan_in=d),
        "wi": PSpec((d, 4 * d), (None, "mlp"), fan_in=d),
        "wo_mlp": PSpec((4 * d, d), ("mlp", None), fan_in=4 * d),
    }
    return {
        "in_proj": PSpec((a.action_dim, d), (None, None),
                         fan_in=a.action_dim),
        "cond_proj": PSpec((d_lm, d), (None, None), fan_in=d_lm),
        "t_proj": PSpec((T_EMBED, d), (None, None), fan_in=T_EMBED),
        "pos": PSpec((a.horizon, d), (None, None), "pos"),
        "stack": stack(layer, a.dit_layers, "layers"),
        "final_ada": PSpec((d, 2 * d), (None, None), "zeros"),
        "out_proj": PSpec((d, a.action_dim), (None, None), "zeros"),
    }


def _timestep_embed(t, dim: int = T_EMBED):
    """[B] timesteps -> [B, dim] f32 (cos, sin) features over ``dim / 2``
    geometric frequencies."""
    half = dim // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    ang = t.float()[..., None] * freqs
    return torch.cat([torch.cos(ang), torch.sin(ang)], -1)


def timesteps(a: ActionConfig, device) -> torch.Tensor:
    """The sampler's timesteps x 1000, [dit_steps] f32: 1 down to
    1 / dit_steps, evenly spaced, by ``jnp.linspace``'s formula
    (start * (1 - s) + stop * s, the endpoint exact)."""
    n = a.dit_steps
    stop = torch.tensor(1.0 / n, dtype=torch.float32)
    s = torch.arange(n - 1, dtype=torch.float32) / max(n - 1, 1)
    ts = torch.cat([1.0 * (1 - s) + stop * s, stop.reshape(1)])
    return (ts * 1000.0).to(device)


def _modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def _rms(x, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _block(x, c, pl, a: ActionConfig):
    """One AdaLN-zero transformer block over the trajectory rows."""
    B, H, d = x.shape
    n, h = a.dit_heads, a.dit_d_model // a.dit_heads
    s1, g1, b1, s2, g2, b2 = (c @ pl["ada"]).reshape(B, 6, d).unbind(1)
    y = _modulate(_rms(x), b1, s1)
    q, k, v = ((y @ pl[w].reshape(d, n * h)).reshape(B, H, n, h)
               .transpose(1, 2) for w in ("wq", "wk", "wv"))   # [B,n,H,h]
    logits = (q @ k.transpose(-1, -2)) * float(1.0 / math.sqrt(h))
    w = torch.softmax(logits.float(), -1).to(x.dtype)
    o = (w @ v).transpose(1, 2).reshape(B, H, n * h)
    x = x + g1[:, None] * (o @ pl["wo"].reshape(n * h, d))
    y = _modulate(_rms(x), b2, s2)
    y = F.gelu(y @ pl["wi"], approximate="tanh")
    return x + g2[:, None] * (y @ pl["wo_mlp"])


def dit_denoise(p, noisy, t, cond, a: ActionConfig):
    """One denoiser evaluation. noisy [B, horizon, action_dim], t [B]
    timesteps (x 1000), cond [B, d_lm] (the last CoT token's embedding).
    Returns the predicted noise, in the weights' type."""
    dtype = p["in_proj"].dtype
    x = noisy.to(dtype) @ p["in_proj"] + p["pos"][None]
    c = cond.to(dtype) @ p["cond_proj"] \
        + _timestep_embed(t).to(dtype) @ p["t_proj"]
    c = F.silu(c)
    for i in range(a.dit_layers):
        x = _block(x, c, {k: v[i] for k, v in p["stack"].items()}, a)
    scale, shift = (c @ p["final_ada"]).reshape(x.shape[0], 2, -1).unbind(1)
    x = _modulate(_rms(x), shift, scale)
    return x @ p["out_proj"]


def denoise_loop(p, noise, cond, a: ActionConfig, ts):
    """The deterministic sampling loop: ``dit_steps`` denoiser steps from
    ``noise`` at the timesteps ``ts`` (``timesteps``), the carry in f32.
    Returns the trajectory [B, horizon, action_dim] f32."""
    B = noise.shape[0]
    x = noise.float()
    for i in range(a.dit_steps):
        eps = dit_denoise(p, x, ts[i].expand(B), cond, a)
        x = x - eps.float() * (1.0 / a.dit_steps)
    return x


def draw_noise(a: ActionConfig, cond, generator: torch.Generator):
    """Initial noise [B, horizon, action_dim] in ``cond``'s type: a
    standard normal draw of ``generator`` (on ``cond``'s device)."""
    return torch.randn((cond.shape[0], a.horizon, a.action_dim),
                       generator=generator, device=cond.device,
                       dtype=torch.float32).to(cond.dtype)


def dit_generate(p, cond, a: ActionConfig, *,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None):
    """DDIM-style deterministic sampling (``dit_steps`` iterations) from
    ``noise`` [B, horizon, action_dim], or from a standard normal draw of
    ``generator`` in ``cond``'s type (never the global RNG). Returns the
    trajectory [B, horizon, action_dim] f32."""
    if noise is None:
        if generator is None:
            raise ValueError("dit_generate needs noise= or generator=")
        noise = draw_noise(a, cond, generator)
    return denoise_loop(p, noise.to(cond.device), cond, a,
                        timesteps(a, cond.device))
