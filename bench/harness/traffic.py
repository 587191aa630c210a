"""The one traffic generator: every mix is a ``traffic/<mix>.json`` of
parameters that this module reads.

Arrivals (open loops) are the Poisson process of the program's
``core/workload.fleet_trace`` (exponential gaps from one
``numpy.random.default_rng``), frozen here, drawn from the mix's own
``arrival_seed``: every run offers the same arrival times and the same
sizes, and ``--seed`` changes which observation arrives at each time.
(With the gaps' order drawn from ``--seed`` too, the fleet's tails moved
15-33% from seed to seed, where the bursts fell: the seed changed the
work.) Observations (instruction tokens uniform over the vocabulary,
image patches standard normal, rounded to bf16) are drawn on the device
from ``--seed``: the same seed gives the same inputs."""
from __future__ import annotations

import numpy as np


def stream_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one named stream of a run's ``--seed``."""
    words = [int(seed) & (2 ** 64 - 1), int(seed) >> 64]
    for s in stream:
        words += [ord(c) for c in s] if isinstance(s, str) else [int(s)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def poisson_arrivals(rate: float, n: int, arrival_seed: int) -> np.ndarray:
    """``n`` arrival times (s from the process's start): a Poisson
    process of ``rate`` a second drawn from ``arrival_seed``."""
    if rate <= 0 or n < 1:
        raise ValueError(f"rate {rate} and n {n} must be positive")
    rng = np.random.default_rng(arrival_seed)
    return np.cumsum([float(rng.exponential(1.0 / rate)) for _ in range(n)])


def generator(device, seed: int, *stream):
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, *stream))
    return gen


def observation(cfg: dict, robots: int, text: int, seed: int, key,
                device):
    """Observation ``key`` (an index, or a tuple) of a run: instruction
    tokens [robots, text] (int64) and image patches [robots, patches,
    patch_embed_dim] (bf16), drawn on ``device`` from a generator of
    their own."""
    import torch
    key = key if isinstance(key, tuple) else (key,)
    gen = generator(device, seed, "obs", *key)
    v = cfg["vision"]
    tokens = torch.randint(0, cfg["vocab_size"], (robots, text),
                           generator=gen, device=device)
    patches = torch.randn((robots, v["num_patches"], v["patch_embed_dim"]),
                          generator=gen, device=device, dtype=torch.bfloat16)
    return tokens, patches
