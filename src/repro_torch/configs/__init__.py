"""Architecture registry of the port: every config of the reference's
registry (attention decoders with a dense MLP or mixture-of-experts FFN,
sliding-window and global layers, vision towers, the attention-free
Mamba2 stack, the attention / Mamba2 / MoE hybrid and the whisper
encoder-decoder), and ``molmoact-7b-dit``, molmoact-7b with the DiT
action head."""
from __future__ import annotations

import importlib
from typing import Iterator, Tuple

from repro_torch.configs.base import (GLOBAL_WINDOW, SHAPES, ActionConfig,
                                      ModelConfig, ShapeConfig, VisionConfig,
                                      shape_supported)

_MODULES = {
    "whisper-small": "whisper_small",
    "qwen1.5-0.5b": "qwen15_05b",
    "smollm-135m": "smollm_135m",
    "granite-3-2b": "granite_3_2b",
    "gemma3-27b": "gemma3_27b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "arctic-480b": "arctic_480b",
    "internvl2-1b": "internvl2_1b",
    "jamba-1.5-large-398b": "jamba_15_large",
    "mamba2-780m": "mamba2_780m",
    "molmoact-7b": "molmoact_7b",
}

# the dry run's ten architectures (the paper's molmoact-7b is not one)
ASSIGNED_ARCHS = tuple(k for k in _MODULES if k != "molmoact-7b")


def get_config(name: str) -> ModelConfig:
    if name == "molmoact-7b-dit":
        return importlib.import_module(
            "repro_torch.configs.molmoact_7b").CONFIG_DIT
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(_MODULES)}")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG


def list_archs():
    """Every registered name, in the reference's order (not the DiT
    variant, which ``get_config`` also takes)."""
    return tuple(_MODULES)


def cells(include_skipped: bool = False
          ) -> Iterator[Tuple[ModelConfig, ShapeConfig, bool, str]]:
    """The 40 assigned (arch x shape) cells, as (cfg, shape, supported,
    skip_reason); the unsupported ones only with ``include_skipped``."""
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = shape_supported(cfg, shape)
            if ok or include_skipped:
                yield cfg, shape, ok, why


__all__ = ["ASSIGNED_ARCHS", "ActionConfig", "GLOBAL_WINDOW", "ModelConfig",
           "SHAPES", "ShapeConfig", "VisionConfig", "cells", "get_config",
           "list_archs", "shape_supported"]
