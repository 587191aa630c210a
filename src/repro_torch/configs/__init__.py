"""Architecture registry of the port: the attention decoders (dense MLP or
mixture-of-experts FFN), the attention-free Mamba2 stack and the
attention / Mamba2 / MoE hybrid, whose decode and serving paths this
package runs, and ``molmoact-7b-dit``, molmoact-7b with the DiT action
head."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (GLOBAL_WINDOW, ActionConfig,
                                      ModelConfig, VisionConfig)

_MODULES = {
    "qwen1.5-0.5b": "qwen15_05b",
    "smollm-135m": "smollm_135m",
    "molmoact-7b": "molmoact_7b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "arctic-480b": "arctic_480b",
    "mamba2-780m": "mamba2_780m",
    "jamba-1.5-large-398b": "jamba_15_large",
}


def get_config(name: str) -> ModelConfig:
    if name == "molmoact-7b-dit":
        return importlib.import_module(
            "repro_torch.configs.molmoact_7b").CONFIG_DIT
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choices: {sorted(_MODULES)} "
                       "(the other configs come with ROADMAP item 12)")
    return importlib.import_module(
        f"repro_torch.configs.{_MODULES[name]}").CONFIG


__all__ = ["ActionConfig", "GLOBAL_WINDOW", "ModelConfig", "VisionConfig",
           "get_config"]
