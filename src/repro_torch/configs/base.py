"""Config dataclasses (the port's own copy of ``repro.configs.base``).

The model code is driven entirely by these fields; the values, defaults and
``reduced()`` are kept identical to the reference so that the same name
yields the same shapes in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

GLOBAL_WINDOW = 0  # sentinel: "no sliding window" (full causal attention)


@dataclass(frozen=True)
class VisionConfig:
    """Vision/audio encoder tower over stubbed frontend embeddings with
    ``embed_dim`` features (the patchify/conv frontend is not modelled)."""
    num_layers: int
    d_model: int
    num_heads: int
    d_ff: int
    num_tokens: int          # frames (audio) or patches (image)
    embed_dim: int           # dim of the stubbed frontend embeddings
    use_layernorm: bool = True


@dataclass(frozen=True)
class ActionConfig:
    """Action generation head (the paper's bottleneck phase).

    mode='discrete': actions are tokens in the LM vocab (MolmoAct-style).
    mode='dit':      a small Diffusion Transformer decodes continuous
                     trajectories conditioned on LM hidden states.
    """
    mode: str = "discrete"            # 'discrete' | 'dit'
    num_action_tokens: int = 24       # tokens decoded per control step
    dit_layers: int = 6
    dit_d_model: int = 512
    dit_heads: int = 8
    dit_steps: int = 10               # diffusion denoising iterations
    action_dim: int = 7               # e.g. 7-DoF end effector
    horizon: int = 8                  # trajectory length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    qkv_bias: bool = False
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    pos: str = "rope"                 # rope | absolute
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"                 # silu (gated) | gelu (gated) | gelu_plain
    tie_embeddings: bool = False
    window_pattern: Tuple[int, ...] = (GLOBAL_WINDOW,)
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1
    dense_residual: bool = False
    num_experts_padded: int = 0
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0
    encoder: Optional[VisionConfig] = None
    vision: Optional[VisionConfig] = None
    action: Optional[ActionConfig] = None
    n_prompt_tokens: int = 64
    n_cot_tokens: int = 128

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))
        if self.family not in ("dense", "moe", "ssm", "hybrid", "encdec",
                               "vlm"):
            raise ValueError(f"unknown family {self.family!r}")
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads must divide by "
                             "num_kv_heads")

    def layer_window(self, i: int) -> int:
        return self.window_pattern[i % len(self.window_pattern)]

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "ssm":
            return False
        if self.attn_every:
            return i % self.attn_every == self.attn_every // 2
        return True

    def is_moe_layer(self, i: int) -> bool:
        if not self.num_experts:
            return False
        return i % self.moe_every == self.moe_every - 1

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid or mostly-sliding-window."""
        if self.family in ("ssm", "hybrid"):
            return True
        return any(w != GLOBAL_WINDOW for w in self.window_pattern)

    def param_counts(self) -> dict:
        """Analytical parameter counts, split by component (the analytical
        model's, ``core.scaling`` and ``core.workload``)."""
        d, hd = self.d_model, self.head_dim
        counts = {"embed": self.vocab_size * d,
                  "lm_head": 0 if self.tie_embeddings
                  else self.vocab_size * d}
        attn = mlp = moe = ssm = 0.0
        for i in range(self.num_layers):
            if self.is_attn_layer(i):
                q = d * self.num_heads * hd
                kv = 2 * d * self.num_kv_heads * hd
                o = self.num_heads * hd * d
                attn += q + kv + o
            elif self.family in ("ssm", "hybrid"):
                d_in = self.ssm_expand * d
                nheads = d_in // self.ssm_head_dim
                ssm += (d * (2 * d_in + 2 * self.ssm_state + nheads)
                        + d_in * d)
            if self.is_moe_layer(i):
                moe += (self.num_experts * 3 * d * self.moe_d_ff
                        + d * self.num_experts)
                if self.dense_residual and self.d_ff:
                    mlp += 3 * d * self.d_ff
            elif self.d_ff and self.family != "ssm":
                gate = 3 if self.act in ("silu", "gelu") else 2
                mlp += gate * d * self.d_ff
        tower = 0.0
        for enc in (self.encoder, self.vision):
            if enc is not None:
                # MHA (4 d^2) + plain-gelu MLP (2 d d_ff) per layer + projector
                tower += enc.num_layers * (4 * enc.d_model ** 2
                                           + 2 * enc.d_model * enc.d_ff)
                tower += enc.embed_dim * enc.d_model + enc.d_model * d
        counts.update(attn=attn, mlp=mlp, moe=moe, ssm=ssm, tower=tower)
        counts["total"] = sum(counts.values())
        # active params per token (MoE: only top_k experts fire)
        active = counts["total"] - moe
        for i in range(self.num_layers):
            if self.is_moe_layer(i):
                active += (self.top_k * 3 * d * self.moe_d_ff
                           + d * self.num_experts)
        counts["active"] = active
        return counts

    def reduced(self) -> "ModelConfig":
        """Same family/topology, tiny dimensions (the CPU test size)."""
        kv = max(1, min(self.num_kv_heads, 2))
        heads = kv * max(1, (self.num_heads // max(self.num_kv_heads, 1)))
        heads = min(heads, 4)
        heads = max(kv, (heads // kv) * kv)
        updates = dict(
            name=self.name + "-reduced",
            num_layers=(min(self.num_layers, 4) if self.attn_every == 0
                        else min(self.num_layers,
                                 2 * max(self.attn_every, 1))),
            d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=16,
            d_ff=96 if self.d_ff else 0, vocab_size=256,
            num_experts=min(self.num_experts, 4), top_k=min(self.top_k, 2),
            moe_d_ff=48 if self.num_experts else 0,
            ssm_state=min(self.ssm_state, 16), ssm_head_dim=16,
            window_pattern=tuple(min(w, 32) if w != GLOBAL_WINDOW else w
                                 for w in self.window_pattern),
        )
        if self.encoder:
            updates["encoder"] = dataclasses.replace(
                self.encoder, num_layers=2, d_model=64, num_heads=4, d_ff=96,
                num_tokens=24, embed_dim=32)
        if self.vision:
            updates["vision"] = dataclasses.replace(
                self.vision, num_layers=2, d_model=64, num_heads=4, d_ff=96,
                num_tokens=8, embed_dim=32)
        if self.action:
            updates["action"] = dataclasses.replace(
                self.action, num_action_tokens=4, dit_layers=2,
                dit_d_model=32, dit_heads=2, dit_steps=2, horizon=2)
        return dataclasses.replace(self, **updates)


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry run: a global batch of ``seq_len``
    positions for a train step, a prefill, or one decode step against a
    ``seq_len``-deep cache."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_supported(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether this (arch, shape) cell runs, and why not if skipped (the
    reference's reason, word for word)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; " \
                      f"{cfg.name} is pure full-attention (see DESIGN.md)"
    return True, ""
