"""The port's asyncio front end (``repro_torch.serving.frontend``) and
serve driver (``repro_torch.launch.serve``) on the CPU, mirroring the
reference's ``tests/test_frontend.py`` on the port's engine.

Weights come from the reference (reduced smollm-135m) through
``from_jax``; prompts are made with numpy from a seed. Streams are held
equal to the port's synchronous engine and to the reference front end's
streams for the same requests (greedy, f32): cancellation frees slots
and pool pages (mid-prefill, mid-decode, staged, queued), bounded
admission rejects instead of deadlocking, the retry-after estimate tracks
the tick EWMA, the realtime reserve splits admission, prefix-aware
routing sends a twin to the replica that holds its pages, offloaded
ticks give the same streams as inline ticks, and a driver whose engine
raises ends its streams with the error. The serve driver's tokens equal
the port's engine run directly with the same weights.
"""
import asyncio
import json
import sys

import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.models.layers import ModelOptions as JOptions
from repro.serving import AsyncFrontend as JFrontend
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import model as TM
from repro_torch.models.layers import ModelOptions
from repro_torch.serving import (AsyncFrontend, Backpressure, Request,
                                 ServingEngine)
from test_torch_serving import port_params

ARCH = "smollm-135m"
SHAPES = [(11, 5), (23, 4), (7, 6)]
PAGED_CHUNKED = dict(paged=True, page_size=8, chunked_prefill=True,
                     chunk_size=16, token_budget=16)


def _engine(**kw):
    cfg, params = port_params(ARCH)
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    return ServingEngine(cfg, ModelOptions(), params, eos=-999, fused=True,
                         tick_tokens=4, device="cpu", **kw)


def _ref_engine(**kw):
    cfg, params = reduced_params(ARCH)
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    return JEngine(cfg, JOptions(remat=False), params, eos=-999, fused=True,
                   tick_tokens=4, **kw)


def _prompts(seed, shapes=SHAPES):
    rng = np.random.default_rng(seed)
    vocab = get_config(ARCH).reduced().vocab_size
    return [(rng.integers(0, vocab, n, dtype=np.int32), m)
            for n, m in shapes]


async def _serve(frontend, engines, reqs, **kw):
    """Each request through a front end over ``engines``; its streamed
    tokens, in order, and the front end."""
    async with frontend(engines, **kw) as fe:
        streams = [await fe.submit(p, m) for p, m in reqs]
        outs = [await s.tokens() for s in streams]
        await fe.drain()
    return outs, fe


# ---------------------------------------------------------------------------
# engine-level cancellation (ServingEngine.cancel)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["mid-prefill", "mid-decode", "queued"])
def test_engine_cancel_frees_slot_and_pages(where):
    """A request cancelled mid-prefill (its task dropped), mid-decode (its
    slot freed) or still queued: the pool returns to baseline and the
    engine goes on serving; an unknown uid reports False."""
    eng = _engine(**PAGED_CHUNKED)
    (long, _), (short, _) = _prompts(0, [(48, 8), (12, 5)])
    if where == "queued":
        for uid in range(2):
            eng.submit(Request(uid=uid, prompt=short.copy(), max_tokens=4))
        assert eng.cancel(1) is True and eng.cancel(99) is False
        assert [r.uid for r in eng.run(max_ticks=500)] == [0]
        return
    eng.submit(Request(uid=0, prompt=(long if where == "mid-prefill"
                                      else short).copy(), max_tokens=40))
    for _ in range(10):
        eng.step_fused()
        if where == "mid-prefill" or not eng.scheduler.tasks:
            break
    if where == "mid-prefill":
        assert eng.scheduler.tasks, "prefill should still be in flight"
    else:
        assert eng.pending == 1 and not eng.scheduler.tasks
    assert eng.pool.pages_in_use > 0
    assert eng.cancel(0) is True
    assert eng.pool.pages_in_use == 0 and eng.pending == 0
    eng.submit(Request(uid=1, prompt=short.copy(), max_tokens=5))
    done = eng.run(max_ticks=500)
    assert [r.uid for r in done] == [1] and len(done[0].out_tokens) == 5


# ---------------------------------------------------------------------------
# front end: streaming, cancellation, backpressure, routing
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_streams():
    """The reference front end's streams for _prompts(3), inline ticks."""
    outs, _ = asyncio.run(_serve(JFrontend, [_ref_engine()], _prompts(3),
                                 offload_ticks=False))
    return outs


@pytest.mark.parametrize("offload", [False, True],
                         ids=["inline", "offloaded"])
def test_frontend_streams_equal_sync_engine_and_reference(
        reference_streams, offload):
    eng = _engine()
    reqs = _prompts(3)
    for i, (p, m) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=p.copy(), max_tokens=m))
    base = {r.uid: r.out_tokens for r in eng.run(max_ticks=500)}
    outs, fe = asyncio.run(_serve(AsyncFrontend, [_engine()], reqs,
                                  offload_ticks=offload))
    assert outs == [base[i] for i in range(len(reqs))] == reference_streams
    rep = fe.stats.report()
    assert rep["completed"] == 3 and rep["routed_load"] == 3
    assert rep["ttft_p50_s"] > 0


def test_offloaded_ticks_on_four_threads():
    """Four replicas ticked on four worker threads, the interpreter
    switching threads every 10 us: every stream equals the synchronous
    engine's, and every replica served its share."""
    reqs = _prompts(13, [(9 + 3 * k, 4 + k % 3) for k in range(8)])
    eng = _engine()
    for i, (p, m) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=p.copy(), max_tokens=m))
    base = {r.uid: r.out_tokens for r in eng.run(max_ticks=500)}
    engines = [_engine() for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        outs, fe = asyncio.run(asyncio.wait_for(
            _serve(AsyncFrontend, engines, reqs, offload_ticks=True), 120))
    finally:
        sys.setswitchinterval(interval)
    assert outs == [base[i] for i in range(len(reqs))]
    assert fe.stats.report()["completed"] == len(reqs)
    assert all(e.stats.tokens_decoded > 0 and e.pending == 0
               for e in engines)


@pytest.mark.parametrize("when", ["mid-decode", "staged"])
def test_frontend_cancel_returns_pool_to_baseline(when):
    """A stream cancelled after 3 tokens stops short and its pages go back;
    one cancelled while still staged never reaches the engine."""
    (prompt, _), = _prompts(4, [(16, 40)])

    async def go():
        eng = _engine(**PAGED_CHUNKED)
        async with AsyncFrontend([eng], offload_ticks=False) as fe:
            stream = await fe.submit(prompt, 40 if when == "mid-decode"
                                     else 8)
            got = []
            if when == "staged":
                stream.cancel()
                got = await stream.tokens()
            else:
                async for tok in stream:
                    got.append(tok)
                    if len(got) == 3:
                        stream.cancel()
            await fe.drain()
        return eng, stream, got, fe

    eng, stream, got, fe = asyncio.run(go())
    assert stream.cancelled is True and eng.pending == 0
    assert eng.stats.pages_in_use == 0 and eng.pool.pages_in_use == 0
    assert fe.stats.cancelled == 1 and fe.stats.completed == 0
    if when == "staged":
        assert got == [] and eng.stats.ticks == 0
    else:
        assert 3 <= len(got) < 40


def test_frontend_over_limit_rejects_without_deadlock():
    """Submissions past queue_limit raise Backpressure with a positive
    retry estimate; every accepted request still completes in full."""
    limit = 2
    reqs = _prompts(6, [(12, 6)] * (limit + 4))

    async def go():
        async with AsyncFrontend([_engine(**PAGED_CHUNKED)],
                                 queue_limit=limit,
                                 offload_ticks=False) as fe:
            accepted, errors = [], []
            for p, m in reqs:
                try:
                    accepted.append(await fe.submit(p, m))
                except Backpressure as exc:
                    errors.append(exc)
            outs = [await asyncio.wait_for(s.tokens(), timeout=60)
                    for s in accepted]
            await fe.drain()
        return accepted, errors, outs, fe

    accepted, errors, outs, fe = asyncio.run(go())
    assert len(accepted) == limit
    assert len(errors) == 4 and fe.stats.rejected == 4
    assert all(e.retry_after_s > 0 for e in errors)
    assert all(len(o) == 6 for o in outs), "accepted requests must finish"


def test_backpressure_retry_tracks_tick_ewma():
    """The retry-after estimate is the depth times the engine's measured
    tick EWMA, and the driver's own estimate before the engine ticked."""
    eng = _engine(**PAGED_CHUNKED)
    (p0, _), (p1, _), (prompt, _) = _prompts(8, [(12, 4), (12, 4), (8, 4)])
    for uid, p in enumerate((p0, p1)):
        eng.submit(Request(uid=uid, prompt=p, max_tokens=4))
    fe = AsyncFrontend([eng], queue_limit=2)
    retry = {}
    for ewma in (0.5, 0.05, 0.0):
        eng.stats.tick_ewma_s = ewma
        with pytest.raises(Backpressure) as exc:
            fe._route(prompt, None)
        retry[ewma] = exc.value.retry_after_s
    assert retry[0.5] == pytest.approx(2 * 0.5)
    assert retry[0.05] == pytest.approx(2 * 0.05)
    assert retry[0.0] == pytest.approx(max(1e-3, 2 * fe._tick_ewma[0]))


def test_realtime_reserve_class_admission():
    """Best-effort admits against queue_limit - realtime_reserve (its
    Backpressure names the class); realtime sees the full limit."""
    eng = _engine(**PAGED_CHUNKED)
    fe = AsyncFrontend([eng], queue_limit=3, realtime_reserve=1)
    assert fe.class_limit("realtime") == 3
    assert fe.class_limit("best_effort") == 2
    reqs = _prompts(9, [(12, 4), (12, 4), (8, 4)])
    for uid, (p, m) in enumerate(reqs[:2]):
        eng.submit(Request(uid=uid, prompt=p, max_tokens=m))
    prompt = reqs[2][0]
    with pytest.raises(Backpressure) as exc:
        fe._route(prompt, None)
    assert exc.value.priority == "best_effort"
    assert fe._route(prompt, None, priority="realtime") == 0
    with pytest.raises(ValueError, match="realtime_reserve"):
        AsyncFrontend([eng], queue_limit=2, realtime_reserve=2)


def test_prefix_routing_matches_reference_front_end():
    """Two paged replicas, inline ticks: three prompts, then their twins
    once the first wave finished. Each twin is routed by prefix affinity
    to the replica that holds its pages (the first wave by load), with the
    reference front end's routing, counters and streams; the snapshot is
    flat floats."""
    shapes = [(21, 4), (30, 5), (17, 3)]
    reqs = _prompts(10, shapes)

    async def go(frontend, make):
        engines = [make(**PAGED_CHUNKED), make(**PAGED_CHUNKED)]
        async with frontend(engines, offload_ticks=False) as fe:
            outs, where = [], []
            for wave in range(2):
                streams = [await fe.submit(p, m) for p, m in reqs]
                outs += [await s.tokens() for s in streams]
                where += [s.replica for s in streams]
            await fe.drain()
        return outs, where, fe

    outs, where, fe = asyncio.run(go(AsyncFrontend, _engine))
    r_outs, r_where, r_fe = asyncio.run(go(JFrontend, _ref_engine))
    assert outs == r_outs and where == r_where
    assert where[3:] == where[:3]
    rep = fe.stats.report()
    for k in ("routed_prefix", "routed_load", "completed"):
        assert rep[k] == r_fe.stats.report()[k], k
    assert rep["routed_prefix"] == 3 and rep["routed_load"] == 3
    snap = fe.stats_snapshot()
    assert all(isinstance(v, float) for v in snap.values())
    assert snap["replicas"] == 2.0
    assert sum(snap[f"replica{i}_tokens_decoded"] for i in range(2)) == \
        2 * sum(m for _, m in shapes) - 6     # first tokens: the prefill's


def test_failed_driver_ends_its_streams_with_the_error():
    """An engine that raises in a tick (a vision model given no patches)
    ends its streams with the error instead of leaving them waiting; the
    next submission and ``stop`` raise too."""
    cfg, params = port_params("molmoact-7b")
    eng = ServingEngine(cfg, ModelOptions(), params, n_slots=2, max_seq=64,
                        eos=-999, device="cpu")
    (prompt, m), = _prompts(12, [(10, 4)])

    async def go():
        fe = AsyncFrontend([eng], offload_ticks=True)
        await fe.start()
        stream = await fe.submit(prompt, m)
        with pytest.raises(KeyError, match="patches"):
            await asyncio.wait_for(stream.tokens(), timeout=60)
        with pytest.raises(RuntimeError, match="driver failed"):
            await fe.submit(prompt, m)
        with pytest.raises(KeyError, match="patches"):
            await fe.stop()

    asyncio.run(go())


# ---------------------------------------------------------------------------
# the serve driver
# ---------------------------------------------------------------------------

SERVE_ARGS = ["--device", "cpu", "--reduced", "--arch", ARCH,
              "--requests", "3", "--slots", "2", "--prompt-len", "10",
              "--max-tokens", "5", "--paged", "--chunked-prefill",
              "--page-size", "8", "--chunk-size", "16"]


@pytest.mark.parametrize("mode", ["engine", "frontend"])
def test_serve_driver_tokens_equal_direct_engine(mode, tmp_path):
    """``python -m repro_torch.launch.serve`` in engine and front-end mode
    gives the tokens of the port's engine run directly with the same
    seeded weights and prompts; ``--stats-json`` writes flat floats."""
    path = tmp_path / "stats.json"
    args = SERVE_ARGS + ["--stats-json", str(path)]
    if mode == "frontend":
        args += ["--frontend", "--replicas", "2"]
    out = serve.main(args)
    got = ([r.out_tokens for r in sorted(out, key=lambda r: r.uid)]
           if mode == "engine" else [s.request.out_tokens for s in out])
    cfg = get_config(ARCH).reduced()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            torch.float32, device="cpu")
    eng = ServingEngine(cfg, ModelOptions(), params, n_slots=2, max_seq=128,
                        eos=-1, tick_tokens=8, paged=True, page_size=8,
                        chunked_prefill=True, chunk_size=16,
                        token_budget=64, device="cpu")
    rng = np.random.default_rng(0)
    for i in range(3):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, 10, dtype=np.int32), max_tokens=5))
    want = {r.uid: r.out_tokens for r in eng.run()}
    assert got == [want[i] for i in range(3)]
    snap = json.loads(path.read_text())
    assert snap and all(isinstance(v, float) for v in snap.values())
    assert ("frontend_completed" in snap) == (mode == "frontend")


def test_serve_driver_refuses_a_mesh():
    """``--mesh-model`` is ported (tests/test_torch_sharded.py runs it);
    the driver refuses a mesh the engine cannot shard, an SSM stack, with
    the reference engine's words, before any worker process starts."""
    with pytest.raises(ValueError, match="attention-only decoders"):
        serve.main(["--device", "cpu", "--reduced", "--mesh-model", "2",
                    "--arch", "mamba2-780m"])
