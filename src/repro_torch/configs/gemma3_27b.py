"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144; 5:1 local:global attention (window=1024), 128k context.
[hf:google/gemma-3-*]

Under ``ModelOptions(window_cache=True)`` each local layer keeps a ring
cache of 1024 rows; the global layers keep a full-length one.
"""
from repro_torch.configs.base import GLOBAL_WINDOW, ModelConfig

LOCAL_WINDOW = 1024

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21_504,
    vocab_size=262_144,
    head_dim=128,
    act="gelu",
    rope_theta=1_000_000.0,
    window_pattern=(LOCAL_WINDOW,) * 5 + (GLOBAL_WINDOW,),
    tie_embeddings=True,
)
