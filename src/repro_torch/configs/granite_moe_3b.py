"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8)
expert d_ff=512 vocab=49155, MoE 40 experts top-8, every layer.
[hf:ibm-granite/granite-3.0-3b-a800m-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=0,                 # no dense MLP path; every layer is MoE
    vocab_size=49_155,
    num_experts=40,
    top_k=8,
    moe_d_ff=512,
    moe_every=1,
    tie_embeddings=True,
)
