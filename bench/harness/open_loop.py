"""Open-loop robot fleet (``"kind": "open_loop"``): requests arrive on a
Poisson schedule, whatever the engine's state, into one
``repro_torch.serving.ServingEngine`` driven through ``submit`` and
``step_fused`` (each a fresh observation: image patches and instruction
tokens). Every request is timed from its due time, by this module's own
clock, to what the client sees after a tick returns: its first token
(TTFT) and its last (latency), so a stall counts against every request
that waits behind it.

Mix parameters: ``rate_per_s``, ``arrival_seed``, ``lead_s`` (arrivals
before the window opens, at least a request's lifetime: set-up),
``text_tokens``, ``max_tokens``, ``drain`` (wait for the window's requests
after it closes, at most ``wait_s``; without it the run ends with the
window and reports the work the window completed), ``tail_s`` (arrivals
generated past the window), ``check_requests``, ``trace_s`` (the traced
slice after the window) and ``engine`` (the engine's options)."""
from __future__ import annotations

import gc
import math
import time

import numpy as np

from harness import judge, trace
from harness.stats import percentile
from harness.traffic import generator, poisson_arrivals, stream_seed

OBS_BLOCK = 32       # observations drawn on the device at a time


def observations(cfg, n, text, seed, dev):
    """``n`` requests' instruction tokens [n, text] (int32) and image
    patches [n, P, E] (float32 holding bf16 values), on the host."""
    import torch
    gen = generator(dev, seed, "fleet-obs")
    v = cfg["vision"]
    tokens = torch.randint(0, cfg["vocab_size"], (n, text), generator=gen,
                           device=dev).to(torch.int32).cpu().numpy()
    patches = np.empty((n, v["num_patches"], v["patch_embed_dim"]),
                       np.float32)
    for i in range(0, n, OBS_BLOCK):
        m = min(OBS_BLOCK, n - i)
        patches[i:i + m] = torch.randn(
            (m, v["num_patches"], v["patch_embed_dim"]), generator=gen,
            device=dev, dtype=torch.bfloat16).float().cpu().numpy()
    return tokens, patches


def run(ctx) -> dict:
    import torch
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Request, ServingEngine
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    eng = ServingEngine(ctx.pcfg, M.ModelOptions(), ctx.params, device=dev,
                        **tr["engine"])
    eng.capture()
    horizon = tr["lead_s"] + ctx.seconds + tr.get("tail_s", 0.0)
    n = int(math.ceil(tr["rate_per_s"] * horizon)) + 1
    arrivals = poisson_arrivals(tr["rate_per_s"], n, tr["arrival_seed"])
    tokens, patches = observations(cfg, n, tr["text_tokens"], ctx.seed, dev)
    reqs, first, done = {}, {}, {}
    live = {}
    st = eng.stats
    state = {"next": 0}
    ctx.sync()
    origin = time.perf_counter() + 0.01
    due = origin + arrivals

    def tick() -> float:
        """Submit what is due, run one engine tick (or wait for the next
        arrival when there is nothing to do), note what the clients see."""
        now = time.perf_counter()
        i = state["next"]
        while i < n and due[i] <= now:
            r = Request(uid=i, prompt=tokens[i], max_tokens=tr["max_tokens"],
                        patches=patches[i])
            eng.submit(r)
            reqs[i] = live[i] = r
            i += 1
        state["next"] = i
        if not eng.pending:
            if i < n:
                time.sleep(max(0.0, min(due[i] - now, 0.002)))
            return time.perf_counter()
        eng.step_fused()
        t = time.perf_counter()
        for uid, r in list(live.items()):
            if uid not in first and r.out_tokens:
                first[uid] = t
            if r.done:
                done[uid] = t
                del live[uid]
        return t

    def snapshot(t):
        return {"t": t, "ticks": len(st.tick_s),
                "decoded": st.tokens_decoded, "steps": st.device_steps,
                "prefill": st.prefill_tokens,
                "served": sum(len(r.out_tokens) for r in reqs.values()),
                "waiting": sum(not (r.queue_s > 0 or r.t_prefill > 0)
                               for r in reqs.values())}

    t = time.perf_counter()
    while t < origin + tr["lead_s"]:
        t = tick()
    w0 = snapshot(time.perf_counter())
    while t < w0["t"] + ctx.seconds:
        t = tick()
    w1 = snapshot(t)
    memory_peak = ctx.memory_peak()
    traced = None
    if ctx.trace and dev.type == "cuda":
        def body():
            end = time.perf_counter() + tr["trace_s"]
            while time.perf_counter() < end:
                tick()
        traced = trace.traced(body)
    window = [i for i in range(n) if w0["t"] <= due[i] < w1["t"]]
    if tr["drain"]:
        cutoff = w1["t"] + tr["wait_s"]
        while t < cutoff and any(i not in done for i in window):
            t = tick()
    end = time.perf_counter()
    span = w1["t"] - w0["t"]
    prompt = cfg["vision"]["num_patches"] + tr["text_tokens"]
    e2e = {"tokens_per_s": (w1["served"] - w0["served"]) / span}
    failed = 0
    if not window:
        raise RuntimeError("no request was due in the window")
    if tr["drain"]:
        lat, ttft = [], []
        for i in window:
            ok = i in done and len(reqs[i].out_tokens) == tr["max_tokens"]
            failed += not ok
            # a request that never finished counts as missing: its wait
            # runs to the end of the run
            lat.append((done[i] if ok else end) - due[i])
            ttft.append(first.get(i, end) - due[i])
        e2e["request_latency_p95_ms"] = percentile(lat, 95) * 1e3
        e2e["ttft_p95_ms"] = percentile(ttft, 95) * 1e3
    admitted = {i: r.t_submit + r.queue_s for i, r in reqs.items()
                if r.queue_s > 0 or r.t_prefill > 0}
    late = [reqs[i].t_submit - due[i] for i in window if i in reqs]
    win = {
        "tick_s": list(st.tick_s[w0["ticks"]:w1["ticks"]]),
        "queue_wait_s": [admitted[i] - due[i] for i in window
                         if i in admitted],
        "tokens_decoded": w1["decoded"] - w0["decoded"],
        "device_steps": w1["steps"] - w0["steps"],
        "prefill_positions": w1["prefill"] - w0["prefill"],
        "images": sum(w0["t"] <= a < w1["t"] for a in admitted.values()),
        "heads": sum(w0["t"] <= f < w1["t"] for f in first.values()),
        "prompt": prompt, "max_tokens": tr["max_tokens"],
        "requests": len(window), "span_s": span,
        "backlog_open": w0["waiting"], "backlog_close": w1["waiting"],
        "tokens_per_s": e2e["tokens_per_s"], "drain_s": end - w1["t"],
        "admitted_per_s": sum(w0["t"] <= a < w1["t"]
                              for a in admitted.values()) / span,
        "tick_p50_s": percentile(st.tick_s[w0["ticks"]:w1["ticks"]], 50)
        if w1["ticks"] > w0["ticks"] else None,
        "lateness_p95_s": percentile(late, 95) if late else None,
        "due_s": [due[i] - w0["t"] for i in window], "t_open": w0["t"]}
    if tr["drain"]:
        win.update(latency_s=lat, ttft_s=ttft)
    finished = sorted(i for i in (window if tr["drain"] else done)
                      if i in done
                      and len(reqs[i].out_tokens) == tr["max_tokens"])
    rng = np.random.default_rng(stream_seed(ctx.seed, "check"))
    picks = sorted(rng.choice(finished, min(len(finished),
                                            tr["check_requests"]),
                              replace=False)) if finished else []
    served = {i: list(reqs[i].out_tokens) for i in picks}
    attempted = len(window)
    del eng, reqs, live
    gc.collect()
    ctx.empty_cache()
    readings = {}
    if picks:
        tok = torch.as_tensor(np.stack([tokens[i] for i in picks]),
                              device=dev, dtype=torch.long)
        px = torch.as_tensor(np.stack([patches[i] for i in picks]),
                             device=dev)
        out = torch.as_tensor([served[i] for i in picks], device=dev)
        readings = judge.token_readings(ctx.params, cfg, tok, px, out,
                                        ctx.readings)
    else:
        failed = max(failed, 1)
    return {"e2e": e2e, "window": win,
            "traced": {"prompt": prompt}, "trace": traced,
            "t_open": w0["t"], "memory_peak": memory_peak,
            "attempted": attempted, "failed": failed, "readings": readings}
