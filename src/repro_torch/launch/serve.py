"""Serving driver of the port: the continuous-batching engine over
synthetic requests, optionally fronted by the asyncio fleet front end.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --requests 16 --slots 4 --reduced

    # two replicas behind the async front end, replaying a Poisson x
    # 10 Hz control-loop fleet trace with prefix-aware routing
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --paged \
        --chunked-prefill --frontend --replicas 2 --fleet --robots 6

Reports per-request phase latencies (queue / prefill / decode) plus
aggregate throughput, in the lines ``repro.launch.serve`` prints. Front-end
mode adds client-observed TTFT/latency percentiles, routing and
backpressure counters, and control-frequency SLO attainment.

The reference's flags, with these differences:

- ``--device`` (default ``cuda``; ``cpu`` runs the plain PyTorch path).
  The weights are seeded f32 (``torch.Generator`` seed 0 on the device).
- no ``--pallas``: on the card the port's kernels always run.
- ``--mesh-model N`` (N > 1) starts N - 1 worker processes for each
  engine (``serving.sharded.spawn_mesh``; gloo, on the same device as
  this process, so on one card N ranks share it) and each rank draws its
  own shard of the seeded weights.
- an encoder-decoder ``--arch`` (whisper-small) exits at once with the
  engine's refusal (``engine.check_servable``): a request carries no
  audio frames. The reference's engine fails at the first admission.
- ``--page-size`` defaults to 32, not 16: on the card the paged kernels
  take pages of 32, and a paged chunked engine needs ``page_size ==
  --prefill-band`` (32). ``--chunk-size`` (32) must divide by 32 there.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import time
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.workload import fleet_trace
from repro_torch.models import model as M
from repro_torch.models.layers import ModelOptions
from repro_torch.serving import (AsyncFrontend, Backpressure, Request,
                                 ServingEngine)
from repro_torch.launch.mesh import Mesh
from repro_torch.serving.engine import check_mesh, check_servable
from repro_torch.serving.sharded import SeededWeights, spawn_mesh


def _engine_snapshot(eng):
    """Flat float dict for a single bare engine (no front-end): the phase
    report plus the headline counters, list-valued entries expanded to
    indexed keys so the payload stays scrape-flat."""
    snap = {"tokens_decoded": float(eng.stats.tokens_decoded),
            "prefill_tokens": float(eng.stats.prefill_tokens),
            "device_steps": float(eng.stats.device_steps),
            "pages_hwm": float(eng.stats.pages_hwm)}
    for k, v in eng.stats.phase_report().items():
        if isinstance(v, (list, tuple)):
            for j, x in enumerate(v):
                snap[f"{k}_{j}"] = float(x)
        else:
            snap[k] = float(v)
    return snap


def _dump_stats(path: str, snap):
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"[serve] stats snapshot -> {path} ({len(snap)} keys)")


async def replay_fleet(fe: AsyncFrontend, trace) -> Tuple[List, float]:
    """Replay ``trace`` (``core.workload.fleet_trace``) through ``fe`` in
    real time: each event is submitted at its time; a Backpressure drops
    it and backs off for its retry-after estimate. Waits for every
    accepted stream and drains. Returns ([(event, stream)], wall s)."""
    t0 = time.time()
    served = []         # (event, stream)
    for e in trace:
        delay = e.t - (time.time() - t0)
        if delay > 0:
            await asyncio.sleep(delay)
        try:
            served.append((e, await fe.submit(
                e.prompt, e.max_tokens, priority=e.priority,
                deadline_s=e.deadline_s)))
        except Backpressure as exc:
            # a control step re-sent after its period is stale: drop it,
            # back off for the retry-after estimate, driven by the
            # replica's measured per-tick EWMA
            await asyncio.sleep(exc.retry_after_s)
    for _, s in served:
        await s.tokens()
    await fe.drain()
    return served, time.time() - t0


def fleet_slo(served) -> Tuple[int, int]:
    """(requests within their deadline, control steps within theirs) of a
    fleet replay's [(event, stream)]."""
    met = sum(s.t_done - s.t_submit <= e.deadline_s for e, s in served)
    ctrl_met = sum(s.t_done - s.t_submit <= e.deadline_s
                   for e, s in served if e.kind == "control")
    return met, ctrl_met


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="qwen1.5-0.5b")
    p.add_argument("--requests", type=int, default=8)
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--max-tokens", type=int, default=16)
    p.add_argument("--max-seq", type=int, default=128)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--reference", action="store_true",
                   help="per-token decode path instead of the fused tick")
    p.add_argument("--tick-tokens", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; needs a card) or cpu (the "
                        "plain PyTorch path)")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="shard the engine over a model=N serving mesh: "
                        "attention heads, MLP width, vocab and the KV "
                        "pool's heads partition across N ranks (N - 1 "
                        "worker processes an engine, joined over gloo; "
                        "ranks may share one card), with two all-reduces "
                        "a layer and one lm-head all-gather a step; heads "
                        "replicate when N does not divide both head "
                        "counts; the tick runs eagerly")
    p.add_argument("--paged", action="store_true",
                   help="paged KV cache (shared page pool + per-slot page "
                        "tables, prefix caching) instead of dense per-slot "
                        "buffers")
    p.add_argument("--page-size", type=int, default=32,
                   help="tokens per KV page (paged mode; the card's paged "
                        "kernels take 32)")
    p.add_argument("--num-pages", type=int, default=0,
                   help="pool capacity in pages (0 = worst-case sizing)")
    p.add_argument("--kv-dtype", default="bf16",
                   choices=["bf16", "int8", "fp8"],
                   help="paged KV pool storage: bf16 keeps the engine cache "
                        "dtype; int8/fp8 store 1-byte codes with per-page "
                        "scales, shrinking cache_bytes_hwm and decode HBM "
                        "traffic (requires --paged)")
    p.add_argument("--chunked-prefill", action="store_true",
                   help="token-budget scheduler: prompts prefill in fixed "
                        "chunks packed between decode ticks instead of "
                        "admit-stall; prefix-cache hits skip the shared "
                        "prefill compute)")
    p.add_argument("--chunk-size", type=int, default=32,
                   help="prefill chunk tokens (must divide by --page-size "
                        "when --paged)")
    p.add_argument("--token-budget", type=int, default=64,
                   help="tokens one tick may spend across decode steps and "
                        "prefill chunks")
    p.add_argument("--spec-decode", action="store_true",
                   help="self-speculative decode: a cheap draft pass of the "
                        "same model proposes spec-k tokens per slot and one "
                        "banded verify chunk checks them all in a single "
                        "full-model pass (greedy only)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="speculation depth: tokens per draft+verify round "
                        "(requires --spec-decode)")
    p.add_argument("--draft-layers", type=int, default=0,
                   help="decoder layers the draft pass runs (0 = half the "
                        "stack; requires --spec-decode)")
    p.add_argument("--draft-quant", default="none",
                   choices=["none", "int8", "fp8"],
                   help="fake-quantize the draft pass's weights to this "
                        "dtype — models a 1-byte-weight draft stream "
                        "(requires --spec-decode)")
    p.add_argument("--stats-json", default="",
                   help="write a flat JSON stats snapshot here on exit "
                        "(frontend mode: AsyncFrontend.stats_snapshot(); "
                        "engine mode: the engine's phase report)")
    p.add_argument("--prefill-band", type=int, default=32,
                   help="key-block size of the banded prefill-with-cache "
                        "attention core: prefill key-axis work covers the "
                        "live prefix rounded up to this block instead of "
                        "max_seq; a paged chunked engine on the card "
                        "needs it equal to --page-size)")
    p.add_argument("--frontend", action="store_true",
                   help="drive the engine(s) through the asyncio front-end "
                        "(streaming, cancellation, bounded admission, "
                        "prefix-aware replica routing)")
    p.add_argument("--replicas", type=int, default=1,
                   help="engine replicas behind the front-end (requires "
                        "--frontend)")
    p.add_argument("--queue-limit", type=int, default=64,
                   help="per-replica admission bound: staged + pending "
                        "requests beyond this are rejected with a "
                        "retry-after estimate (requires --frontend)")
    p.add_argument("--inline-ticks", action="store_true",
                   help="tick replicas inline on the event loop instead of "
                        "worker threads: fully deterministic, but replicas "
                        "no longer tick in parallel (requires --frontend)")
    p.add_argument("--fleet", action="store_true",
                   help="replay a Poisson-arrivals x control-loop fleet "
                        "trace in real time instead of the synthetic batch "
                        "(requires --frontend); reports control-frequency "
                        "SLO attainment")
    p.add_argument("--robots", type=int, default=6,
                   help="fleet robots (requires --fleet)")
    p.add_argument("--steps-per-robot", type=int, default=4,
                   help="control-loop steps per robot, episode included "
                        "(requires --fleet)")
    p.add_argument("--control-hz", type=float, default=10.0,
                   help="control-loop frequency: one repeat-observation "
                        "request per robot per period, deadline one period "
                        "(requires --fleet)")
    p.add_argument("--arrival-rate", type=float, default=4.0,
                   help="Poisson robot-arrival rate, robots/s (requires "
                        "--fleet)")
    p.add_argument("--slo-hz", type=float, default=0.0,
                   help="deadline-aware scheduling: target control "
                        "frequency the engine's SLO controller defends — "
                        "realtime requests admit first (EDF within class), "
                        "decode depth and the best-effort prefill-chunk "
                        "quota are derived from slack vs the per-tick EWMA "
                        "wall time, and stalled best-effort prefill may be "
                        "preempted (never realtime). 0 = static budget "
                        "(requires --chunked-prefill)")
    p.add_argument("--priority", default="best_effort",
                   choices=["best_effort", "realtime"],
                   help="scheduling class for synthetic (non-fleet) "
                        "requests; fleet traces carry their own per-request "
                        "classes (control steps are realtime)")
    p.add_argument("--realtime-reserve", type=int, default=0,
                   help="front-end admission slots per replica reserved "
                        "for realtime traffic: best-effort admits against "
                        "queue-limit minus this (requires --frontend)")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    try:
        check_servable(cfg)
    except ValueError as e:
        p.error(str(e))
    opts = ModelOptions(prefill_band=args.prefill_band)
    sharded = args.mesh_model > 1
    if sharded:         # the engine's refusals, before any worker starts
        check_mesh(cfg, Mesh({"model": args.mesh_model}))
    # sharded: every rank draws the same seeded leaves and keeps its slice
    params = (SeededWeights(0, torch.float32) if sharded else
              M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            torch.float32, device=dev))

    def make_engine():
        mesh = spawn_mesh(args.mesh_model, device=dev) if sharded else None
        try:
            return _engine(mesh)
        except BaseException:
            if mesh is not None:
                mesh.shutdown()
            raise

    def _engine(mesh):
        return ServingEngine(cfg, opts, params, n_slots=args.slots,
                             mesh=mesh,
                             max_seq=args.max_seq, eos=-1,
                             fused=not args.reference,
                             tick_tokens=args.tick_tokens,
                             paged=args.paged, page_size=args.page_size,
                             num_pages=args.num_pages or None,
                             kv_dtype=args.kv_dtype,
                             chunked_prefill=args.chunked_prefill,
                             chunk_size=args.chunk_size,
                             token_budget=args.token_budget,
                             spec_decode=args.spec_decode,
                             spec_k=args.spec_k,
                             draft_layers=args.draft_layers or None,
                             draft_quant=(None if args.draft_quant == "none"
                                          else args.draft_quant),
                             slo_hz=args.slo_hz, device=dev)

    if args.frontend:
        return asyncio.run(_main_frontend(args, cfg, make_engine))
    eng = make_engine()
    rng = np.random.default_rng(0)
    t0 = time.time()
    # synthetic requests all share --priority; a realtime batch gets one
    # SLO period as its deadline when the controller is on
    deadline = (1.0 / args.slo_hz
                if args.slo_hz > 0 and args.priority == "realtime" else 0.0)
    for i in range(args.requests):
        eng.submit(Request(
            uid=i,
            prompt=rng.integers(0, cfg.vocab_size, args.prompt_len,
                                dtype=np.int32),
            max_tokens=args.max_tokens,
            priority=args.priority, deadline_s=deadline))
    try:
        done = eng.run()
    finally:
        eng.close()
    wall = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s aggregate)")
    st = eng.stats
    print(f"[serve] {st.decode_syncs} decode host syncs / "
          f"{st.device_steps} device steps "
          f"({'fused' if not args.reference else 'reference'} path)")
    ph = st.phase_report()
    if st.prefill_key_lanes_full:
        print(f"[serve] banded prefill: band={args.prefill_band} "
              f"key_lane_ratio={ph['prefill_key_lane_ratio']:.3f} "
              f"(banded live-prefix lanes / max_seq-view equivalent)")
    if args.chunked_prefill:
        print(f"[serve] scheduler: chunk={args.chunk_size} "
              f"budget={args.token_budget} "
              f"prefill_tokens={st.prefill_tokens} "
              f"skipped={st.prefill_skipped} "
              f"ttft_mean={np.mean(st.ttft_s):.3f}s "
              f"decode_tick_p99={ph.get('decode_tick_p99', 0.0):.4f}s")
    if args.slo_hz > 0:
        att = {k[len("deadline_attainment_"):]: v for k, v in ph.items()
               if k.startswith("deadline_attainment_")}
        pre = {k[len("preemptions_"):]: v for k, v in ph.items()
               if k.startswith("preemptions_")}
        print(f"[serve] SLO controller: target={args.slo_hz} Hz "
              f"tick_ewma={ph.get('tick_ewma_s', 0.0):.4f}s "
              f"attainment={att or '(no deadlined requests)'} "
              f"preemptions={pre or '{}'}")
    if args.paged:
        print(f"[serve] paged KV: page_size={args.page_size} "
              f"kv_dtype={args.kv_dtype} "
              f"pages_hwm={st.pages_hwm} "
              f"cache_bytes_hwm={st.cache_bytes_hwm} "
              f"prefix_hits={st.prefix_hits}")
    if st.mesh_shape:
        print(f"[serve] mesh: "
              f"{'x'.join(f'{a}={n}' for a, n in st.mesh_shape)} "
              f"cache_bytes_hwm_shard={st.cache_bytes_hwm_shard}")
    if args.spec_decode:
        print(f"[serve] speculative: K={args.spec_k} "
              f"draft_quant={args.draft_quant} "
              f"verify_passes={st.spec_verify_passes} "
              f"accept/pass={ph.get('spec_accept_per_pass', 0.0):.3f} "
              f"draft_frac={ph.get('spec_draft_frac', 0.0):.3f} "
              f"hist={ph.get('spec_accept_hist', [])}")
    if args.stats_json:
        _dump_stats(args.stats_json, _engine_snapshot(eng))
    for r in done[:4]:
        print(f"  req {r.uid}: queue {r.t_prefill - r.t_submit:.3f}s "
              f"decode {r.t_done - r.t_prefill:.3f}s "
              f"({len(r.out_tokens)} tokens)")
    return done


async def _main_frontend(args, cfg, make_engine):
    """Front-end mode: replicas behind AsyncFrontend, fed either the
    synthetic batch or a real-time fleet-trace replay (--fleet)."""
    engines = [make_engine() for _ in range(args.replicas)]
    async with AsyncFrontend(engines, queue_limit=args.queue_limit,
                             offload_ticks=not args.inline_ticks,
                             realtime_reserve=args.realtime_reserve) as fe:
        t0 = time.time()
        if args.fleet:
            # prompt (ctx + 4-token tail) + generated actions must fit the
            # engine's max_seq
            ctx_max = args.max_seq - args.max_tokens - 8
            trace = fleet_trace(n_robots=args.robots,
                                steps_per_robot=args.steps_per_robot,
                                control_hz=args.control_hz,
                                arrival_rate=args.arrival_rate,
                                ctx_max=ctx_max,
                                action_tokens=args.max_tokens,
                                vocab_size=cfg.vocab_size, seed=0)
            served, _ = await replay_fleet(fe, trace)
            streams = [s for _, s in served]
        else:
            rng = np.random.default_rng(0)
            deadline = (1.0 / args.slo_hz
                        if args.slo_hz > 0 and args.priority == "realtime"
                        else 0.0)
            streams = [await fe.submit(
                rng.integers(0, cfg.vocab_size, args.prompt_len,
                             dtype=np.int32), args.max_tokens,
                priority=args.priority, deadline_s=deadline)
                for _ in range(args.requests)]
            for s in streams:
                await s.tokens()
            await fe.drain()
        wall = time.time() - t0
    toks = sum(len(s.request.out_tokens) for s in streams)
    rep = fe.stats.report()
    print(f"[serve] frontend: {rep['completed']} requests, {toks} tokens "
          f"in {wall:.2f}s ({toks / wall:.1f} tok/s aggregate, "
          f"{args.replicas} replica(s))")
    print(f"[serve] routing: prefix={rep['routed_prefix']} "
          f"load={rep['routed_load']} rejected={rep['rejected']} "
          f"cancelled={rep['cancelled']}")
    if "ttft_p50_s" in rep:
        print(f"[serve] client TTFT p50={rep['ttft_p50_s']:.3f}s "
              f"p99={rep['ttft_p99_s']:.3f}s "
              f"latency_p99={rep.get('latency_p99_s', 0.0):.3f}s")
    if args.fleet:
        met, ctrl_met = fleet_slo(served)
        ctrl = [e for e, _ in served if e.kind == "control"]
        print(f"[serve] fleet SLO: {met}/{len(served)} in deadline "
              f"(control {ctrl_met}/{len(ctrl)} at {args.control_hz} Hz)")
        if args.slo_hz > 0:
            snap = fe.stats_snapshot()
            att = {k: v for k, v in snap.items()
                   if "deadline_attainment" in k or "preemptions" in k}
            print(f"[serve] SLO controller ({args.slo_hz} Hz): {att}")
    for i, eng in enumerate(engines):
        st = eng.stats
        print(f"  replica {i}: decode_tokens={st.tokens_decoded} "
              f"prefill_tokens={st.prefill_tokens} "
              f"skipped={st.prefill_skipped} prefix_hits={st.prefix_hits}")
    if args.stats_json:
        _dump_stats(args.stats_json, fe.stats_snapshot())
    return streams


if __name__ == "__main__":
    main()
