"""Synthetic data pipelines with host-side prefetch (the port's copy of
``repro.data.pipeline``, numpy only: the same seed gives the reference's
arrays bit for bit).

Two sources:
- ``lm_batches``: deterministic synthetic token streams (seeded per shard,
  so every data-parallel host draws disjoint data — the multi-host layout).
- ``vla_batches``: synthetic VLA episodes (image patch embeddings +
  instruction tokens + action-token labels) matching the stubbed frontends.

``Prefetcher`` double-buffers batches on a background thread so host data
production overlaps device compute (the standard input-pipeline overlap).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


def lm_batches(cfg: ModelConfig, batch: int, seq: int, *, seed: int = 0,
               shard: int = 0, num_shards: int = 1,
               steps: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic causal-LM batches: [batch, seq] int32 in [0, vocab)."""
    rng = np.random.default_rng(seed * 100_003 + shard)
    local = batch // num_shards
    i = 0
    while steps is None or i < steps:
        tokens = rng.integers(0, cfg.vocab_size, (local, seq), dtype=np.int32)
        out = {"tokens": tokens}
        if cfg.vision is not None:
            out["patches"] = rng.standard_normal(
                (local, cfg.vision.num_tokens, cfg.vision.embed_dim),
                dtype=np.float32) * 0.1
        if cfg.encoder is not None:
            out["frames"] = rng.standard_normal(
                (local, cfg.encoder.num_tokens, cfg.encoder.embed_dim),
                dtype=np.float32) * 0.1
        yield out
        i += 1


def vla_batches(cfg: ModelConfig, batch: int, *, seed: int = 0,
                steps: Optional[int] = None) -> Iterator[Dict[str, np.ndarray]]:
    """Synthetic VLA episodes: instruction + image patches + action labels
    (action tokens drawn from the top of the vocab, MolmoAct-style binning)."""
    if cfg.vision is None:
        raise ValueError("vla_batches needs a config with a vision tower")
    a = cfg.action
    n_act = a.num_action_tokens if a else 24
    rng = np.random.default_rng(seed + 17)
    i = 0
    while steps is None or i < steps:
        instr = rng.integers(0, cfg.vocab_size, (batch, cfg.n_prompt_tokens),
                             dtype=np.int32)
        cot = rng.integers(0, cfg.vocab_size, (batch, cfg.n_cot_tokens),
                           dtype=np.int32)
        act = rng.integers(cfg.vocab_size - 256, cfg.vocab_size,
                           (batch, n_act), dtype=np.int32)
        yield {
            "tokens": np.concatenate([instr, cot, act], axis=1),
            "patches": rng.standard_normal(
                (batch, cfg.vision.num_tokens, cfg.vision.embed_dim),
                dtype=np.float32) * 0.1,
        }
        i += 1


class Prefetcher:
    """Background-thread double buffering over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()

        def worker():
            for item in it:
                self._q.put(item)
            self._q.put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
