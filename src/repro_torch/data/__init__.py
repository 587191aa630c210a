"""Synthetic data of the port (numpy)."""
from repro_torch.data.pipeline import Prefetcher, lm_batches, vla_batches

__all__ = ["Prefetcher", "lm_batches", "vla_batches"]
