"""Closed-loop control steps (``"kind": "control_loop"``): a batch of
robots sends an observation, waits for its actions, and sends the next;
each step is one ``repro_torch.core.vla.vla_control_step`` through one
kept ``PrefillGraph``, ``DecodeGraph`` and (DiT head) ``DiTGraph``, as a
deployment keeps them. Mix parameters: ``robots``, ``text_tokens``,
``warm_steps`` (set-up), ``check_steps`` (steps judged)."""
from __future__ import annotations

import gc
import time

import numpy as np

from harness import judge, trace
from harness.traffic import generator, observation, stream_seed


def run(ctx) -> dict:
    import torch
    from repro_torch.core import vla
    from repro_torch.models import model as M
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    B, T = tr["robots"], tr["text_tokens"]
    act = cfg["action"]
    dit = act["mode"] == "dit"
    opts = M.ModelOptions()
    logits = []

    class KeptPrefill(M.PrefillGraph):
        """The control step's prefill graph, keeping the logits each run
        returns (the first served token is their argmax)."""

        def run(self, *a, **k):
            out = super().run(*a, **k)
            logits.append(out[0])
            return out

    prefill, graph = KeptPrefill(dev), M.DecodeGraph(dev)
    dit_graph = M.DiTGraph(dev) if dit else None

    def noise(key):
        if not dit:
            return None
        key = key if isinstance(key, tuple) else (key,)
        return torch.randn((B, act["horizon"], act["action_dim"]),
                           generator=generator(dev, ctx.seed, "noise", *key),
                           device=dev, dtype=torch.bfloat16)

    def step(key):
        tokens, patches = observation(cfg, B, T, ctx.seed, key, dev)
        out = vla.vla_control_step(
            ctx.pcfg, opts, ctx.params, {"tokens": tokens,
                                         "patches": patches},
            device=dev, graph=graph, prefill_graph=prefill,
            dit_graph=dit_graph, noise=noise(key))
        # the robots read their actions back: one host sync a step
        (out.trajectory if dit else out.action_tokens).cpu()
        return out

    for k in range(tr["warm_steps"]):
        step(("warm", k))
    logits.clear()
    outs = []
    ctx.sync()
    t_open = time.perf_counter()
    while True:
        outs.append(step(len(outs)))
        t_close = time.perf_counter()
        if t_close - t_open >= ctx.seconds:
            break
    n = len(outs)
    memory_peak = ctx.memory_peak()
    prompt = cfg["vision"]["num_patches"] + T
    n_decode = cfg["n_cot_tokens"] + (0 if dit else act["num_action_tokens"])
    traced = None
    if ctx.trace and dev.type == "cuda":
        traced = trace.traced(lambda: step(n))
    failed = 0
    for o in outs:
        bad = (o.cot_tokens.min(1).values < 0) \
            | (o.cot_tokens.max(1).values >= cfg["vocab_size"])
        if dit:
            bad |= ~o.trajectory.isfinite().flatten(1).all(1)
        else:
            bad |= (o.action_tokens.min(1).values < 0) \
                | (o.action_tokens.max(1).values >= cfg["vocab_size"])
        failed += int(bad.sum())
    rng = np.random.default_rng(stream_seed(ctx.seed, "check"))
    picks = sorted(rng.choice(n, min(n, tr["check_steps"]), replace=False))
    kept = [(j, outs[j], logits[j][:, -1].argmax(-1, keepdim=True))
            for j in picks]
    del outs, logits, prefill, graph, dit_graph
    gc.collect()
    ctx.empty_cache()
    readings = {}
    for j, o, first in kept:
        tokens, patches = observation(cfg, B, T, ctx.seed, j, dev)
        served = torch.cat([first, o.cot_tokens]
                           + ([] if dit else [o.action_tokens]), 1)
        got = judge.token_readings(ctx.params, cfg, tokens, patches, served,
                                   ctx.readings)
        if dit:
            cond = ctx.params["embed"][o.cot_tokens[:, -1]]
            got.update(judge.trajectory_readings(
                ctx.params["action_dit"], cfg, cond, noise(j), o.trajectory,
                ctx.readings))
        # the worst of the steps judged
        for k, v in got.items():
            readings[k] = max(readings.get(k, 0.0), v)
    return {
        "e2e": {"control_step_ms": (t_close - t_open) / n * 1e3},
        "window": {"control_steps": n, "robots": B, "text_tokens": T,
                   "step_s": (t_close - t_open) / n},
        "traced": {"robots": B, "prompt": prompt,
                   "decode_positions": [prompt + j for j in range(n_decode)],
                   "graph_launches": 1 + n_decode + (1 if dit else 0)},
        "trace": traced, "t_open": t_open, "memory_peak": memory_peak,
        "attempted": n * B, "failed": failed, "readings": readings}
