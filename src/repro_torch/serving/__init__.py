"""Serving layer of the port: the continuous-batching engine with its
fused decode tick, the paged KV pool, samplers, queue order and the
asyncio front end over replicas."""
from repro_torch.serving.engine import (EngineStats, Request, ServingEngine,
                                        prefix_page_keys)
from repro_torch.serving.frontend import (AsyncFrontend, Backpressure,
                                          FrontendStats, TokenStream)
from repro_torch.serving.kv_pool import KVPool, PoolExhausted

__all__ = ["AsyncFrontend", "Backpressure", "EngineStats", "FrontendStats",
           "KVPool", "PoolExhausted", "Request", "ServingEngine",
           "TokenStream", "prefix_page_keys"]
