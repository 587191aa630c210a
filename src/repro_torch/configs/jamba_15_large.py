"""jamba-1.5-large-398b [hybrid] — 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536, MoE 16 experts top-2 on every other layer,
Mamba:attention 7:1 interleave. [arXiv:2403.19887]

The state mixer is the Mamba2/SSD block (state=128) rather than Jamba's
Mamba-1, as in the reference configuration.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24_576,
    vocab_size=65_536,
    head_dim=128,
    num_experts=16,
    top_k=2,
    moe_d_ff=24_576,
    moe_every=2,            # MoE on odd layers, dense MLP on even
    attn_every=8,           # 1 attention layer per 8 (7 mamba : 1 attn)
    ssm_state=128,
)
