"""internvl2-1b [vlm] — InternViT frontend + Qwen2-0.5B-class backbone.
Backbone: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
[arXiv:2404.16821]

The ViT *frontend* (patchify + conv) is a stub: requests carry
precomputed patch embeddings; the vision tower transformer + MLP projector
into the LLM embedding space are real.
"""
from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    qkv_bias=True,
    tie_embeddings=True,
    vision=VisionConfig(num_layers=24, d_model=1024, num_heads=16, d_ff=4096,
                        num_tokens=256, embed_dim=1024),
)
