"""Scaling-law model family (paper §4.2: "We scale VLA models upto 100B
parameters, following scaling laws in [1, 8]").

Width and depth are scaled jointly (depth ~ N^(1/3), width to hit the target
count), keeping the MolmoAct/Qwen2 architectural ratios: d_ff ~ 5.3*d,
head_dim=128, GQA 7:1, and the same vision tower + phase lengths.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig


def scaled_vla(target_params: float, base: str = "molmoact-7b") -> ModelConfig:
    cfg = get_config(base)
    base_n = cfg.param_counts()["total"]
    ratio = target_params / base_n
    L = max(8, int(round(cfg.num_layers * ratio ** (1 / 3))))
    # pick width (multiple of 256) to hit the target under depth L
    best = None
    for d in range(1024, 20481, 256):
        heads = max(4, d // 128)
        kv = max(1, heads // 7)
        heads = kv * (heads // kv)
        c = dataclasses.replace(
            cfg, name=f"vla-{target_params/1e9:.0f}b",
            num_layers=L, d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=128, d_ff=int(round(d * 5.3 / 256) * 256))
        n = c.param_counts()["total"]
        err = abs(n - target_params) / target_params
        if best is None or err < best[0]:
            best = (err, c)
    return best[1]


def scaling_sweep(sizes=(7e9, 14e9, 30e9, 50e9, 70e9, 100e9)) -> List[ModelConfig]:
    out = []
    for s in sizes:
        if abs(s - 7e9) / 7e9 < 0.15:
            out.append(get_config("molmoact-7b"))
        else:
            out.append(scaled_vla(s))
    return out
