"""The system under test: the port's configuration object built from a
``configs/*.json`` file, and the run's weights, drawn on the device from
the seed. The weights are the benchmark's: the program and the reference
are handed the same tensors."""
from __future__ import annotations

import math

from harness.traffic import stream_seed

ALIGN = 128          # elements: every leaf starts on a 256-byte boundary
DRAW = 1 << 30       # elements a draw: four calls for molmoact-7b


def port_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file."""
    from repro_torch.configs.base import (ActionConfig, ModelConfig,
                                          VisionConfig)
    if cfg.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{cfg['name']}: the decoder's MLP is SiLU-gated "
                         "in the program")
    vision = None
    if cfg.get("vision"):
        v = cfg["vision"]
        if v.get("layer_norm_eps", 1e-6) != 1e-6 or \
                v.get("hidden_act", "gelu_tanh") != "gelu_tanh":
            raise ValueError(f"{cfg['name']}: the program's tower uses "
                             "LayerNorm eps 1e-6 and tanh GELU")
        vision = VisionConfig(num_layers=v["num_hidden_layers"],
                              d_model=v["hidden_size"],
                              num_heads=v["num_attention_heads"],
                              d_ff=v["intermediate_size"],
                              num_tokens=v["num_patches"],
                              embed_dim=v["patch_embed_dim"])
    action = None
    if cfg.get("action"):
        a = cfg["action"]
        if a["mode"] == "discrete":
            action = ActionConfig(mode="discrete",
                                  num_action_tokens=a["num_action_tokens"])
        else:
            action = ActionConfig(mode="dit", dit_layers=a["dit_layers"],
                                  dit_d_model=a["dit_hidden_size"],
                                  dit_heads=a["dit_num_heads"],
                                  dit_steps=a["dit_steps"],
                                  action_dim=a["action_dim"],
                                  horizon=a["horizon"])
    return ModelConfig(
        name=cfg["name"], family="vlm" if vision else "dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg.get("head_dim", 0),
        qkv_bias=cfg.get("attention_bias", False),
        rope_theta=cfg["rope_theta"], norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        vision=vision, action=action,
        n_prompt_tokens=cfg.get("n_text_tokens", 64),
        n_cot_tokens=cfg.get("n_cot_tokens", 128))


def _scale(spec) -> float:
    fan_in = spec.fan_in
    if fan_in is None:
        fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


class Weights:
    """Every parameter of ``pcfg`` in one flat buffer of ``dtype`` on
    ``device``, laid out as the program's parameter template names them
    (``tree``: a nested dict of views). ``draw(seed)`` fills it anew in
    place, so the views keep their addresses: a standard normal in a few
    large draws of one generator, then each leaf scaled by its kind
    (normal / sqrt(fan_in); position tables 0.02; norm scales 1 + 0.02
    normal; biases and zero-initialised leaves 0.02 normal, so that the
    comparison reaches every leaf)."""

    def __init__(self, pcfg, dtype, device):
        import torch
        from repro_torch.models import model as M
        from repro_torch.models.params import leaves, set_leaf
        self.device = torch.device(device)
        self.specs = list(leaves(M.model_template(pcfg)))
        offsets, off = [], 0
        for _, spec in self.specs:
            offsets.append(off)
            off += -(-math.prod(spec.shape) // ALIGN) * ALIGN
        self.flat = torch.empty(off, dtype=dtype, device=self.device)
        self.tree: dict = {}
        self.views = []
        for (path, spec), o in zip(self.specs, offsets):
            view = self.flat[o:o + math.prod(spec.shape)].view(spec.shape)
            set_leaf(self.tree, path, view)
            self.views.append(view)

    def draw(self, seed: int):
        import torch
        gen = torch.Generator(device=self.device)
        gen.manual_seed(stream_seed(seed, "weights"))
        for o in range(0, self.flat.numel(), DRAW):
            self.flat[o:o + DRAW].normal_(generator=gen)
        for (path, spec), view in zip(self.specs, self.views):
            if spec.init == "normal":
                view.mul_(_scale(spec))
            elif spec.init in ("pos", "zeros"):
                view.mul_(0.02)
            elif spec.init == "ones":
                view.mul_(0.02).add_(1.0)
            else:
                raise ValueError(f"{path}: init {spec.init!r} has no draw "
                                 "in the benchmark")
        return self.tree
