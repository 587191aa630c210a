"""whisper-small [audio] — enc-dec, conv frontend stubbed.

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865. [arXiv:2212.04356]
The audio conv frontend is a stub: ``batch['frames']`` holds 1500
precomputed frame embeddings; the 12-layer encoder tower and 12-layer
decoder are real.
"""
from repro_torch.configs.base import ModelConfig, VisionConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    qkv_bias=True,
    norm="layernorm",
    pos="absolute",
    act="gelu_plain",
    tie_embeddings=True,
    encoder=VisionConfig(num_layers=12, d_model=768, num_heads=12, d_ff=3072,
                         num_tokens=1500, embed_dim=768),
)
