"""AdamW written out over the port's nested parameter dicts (the port's
copy of ``repro.training.optimizer``).

Parameters, gradients and moments are nested dicts of tensors with one
layout; the moments can be kept in bf16 (``moment_dtype``). The update
returns new tensors and leaves its inputs as they are, or, ``inplace``,
writes them into the parameters and moments slice by slice (the same
arithmetic), so that it holds no second copy of them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.params import leaves, map_tree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: torch.dtype = torch.float32


def lr_at(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay, in f32 (``step`` an int or a 0-d
    tensor; the result lies on its device)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(cfg: AdamWConfig, params):
    def zeros(p):       # placed as ``p`` (a DTensor's moments too)
        return torch.zeros_like(p, dtype=cfg.moment_dtype,
                                memory_format=torch.contiguous_format)
    dev = next(t for _, t in leaves(params)).device
    return {"mu": map_tree(zeros, params), "nu": map_tree(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in f32, summed leaf by
    leaf in the tree's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in leaves(tree)))


INPLACE_CHUNK = 1 << 24     # elements of a leaf updated at once in place


def adamw_update(cfg: AdamWConfig, grads, opt_state, params,
                 inplace: bool = False):
    """One AdamW step with global-norm clipping. Weight decay applies to
    leaves of two or more dimensions only; bias corrections are f32.
    Returns (new_params, new_opt_state, metrics); ``inplace`` writes the
    new values into ``params`` and the moments (contiguous leaves), runs
    INPLACE_CHUNK elements of a leaf at a time, and returns those trees."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = lr_at(cfg, count)
    b1c = 1 - cfg.b1 ** count.float()
    b2c = 1 - cfg.b2 ** count.float()

    def upd(p, g, mu, nu, decay):
        g = g.float() * scale
        mu32 = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu32 = cfg.b2 * nu.float() + (1 - cfg.b2) * torch.square(g)
        step = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
        if decay:
            step = step + cfg.weight_decay * p.float()
        new_p = p.float() - lr * step
        return (new_p.to(p.dtype), mu32.to(cfg.moment_dtype),
                nu32.to(cfg.moment_dtype))

    if inplace:
        for (_, p), (_, g), (_, mu), (_, nu) in zip(
                leaves(params), leaves(grads), leaves(opt_state["mu"]),
                leaves(opt_state["nu"])):
            flat = [p.view(-1), g.reshape(-1), mu.view(-1), nu.view(-1)]
            for i in range(0, p.numel(), INPLACE_CHUNK):
                part = [t[i:i + INPLACE_CHUNK] for t in flat]
                for dst, new in zip(part[:1] + part[2:],
                                    upd(*part, p.dim() >= 2)):
                    dst.copy_(new)
        return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                        "count": count}, {"grad_norm": gnorm, "lr": lr}
    out = map_tree(lambda p, g, mu, nu: upd(p, g, mu, nu, p.dim() >= 2),
                   params, grads, opt_state["mu"], opt_state["nu"])
    pick = [map_tree(lambda t, i=i: t[i], out) for i in range(3)]
    return pick[0], {"mu": pick[1], "nu": pick[2], "count": count}, \
        {"grad_norm": gnorm, "lr": lr}

