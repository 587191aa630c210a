"""molmoact-7b — the paper's own workload (MolmoAct-7B, arXiv:2508.07917).

Qwen2-7B reasoning backbone + ViT-L/14 vision tower (frontend stubbed as
patch embeddings) + discrete action-token head; ``CONFIG_DIT`` swaps the
head for a Diffusion Transformer (``molmoact-7b-dit``).
"""
import dataclasses as _dc

from repro_torch.configs.base import ActionConfig, ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="molmoact-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    vision=VisionConfig(num_layers=24, d_model=1024, num_heads=16, d_ff=4096,
                        num_tokens=576, embed_dim=1024),
    action=ActionConfig(mode="discrete", num_action_tokens=48),
    n_prompt_tokens=64,
    n_cot_tokens=144,       # depth tokens + visual trace ("reason in space")
)

# Continuous-action variant with a DiT head (paper §2: "specialized decoders
# such as Diffusion Transformers (DiT)").
CONFIG_DIT = _dc.replace(
    CONFIG,
    name="molmoact-7b-dit",
    action=ActionConfig(mode="dit", dit_layers=6, dit_d_model=512,
                        dit_heads=8, dit_steps=10, action_dim=7, horizon=8),
)
