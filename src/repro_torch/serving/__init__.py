"""Serving layer of the port: the continuous-batching engine with its
fused decode tick, the paged KV pool, samplers and queue order."""
from repro_torch.serving.engine import (EngineStats, Request, ServingEngine,
                                        prefix_page_keys)
from repro_torch.serving.kv_pool import KVPool, PoolExhausted

__all__ = ["EngineStats", "KVPool", "PoolExhausted", "Request",
           "ServingEngine", "prefix_page_keys"]
