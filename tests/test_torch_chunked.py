"""The port's chunked prefill and token-budget scheduler against the JAX
reference.

Inputs are made with numpy from seeds and handed to both frameworks: the
copied scheduler must plan the same ticks; the chunk write paths must give
the same codes and scales (exactly) and rows (within 1e-6, f32 copies and
f32 dequantization); the paged chunk kernel's plain version must agree with
the reference's Pallas kernel in interpret mode within 1e-5 relative to
max(1, |ref|) (f32 sums in another order); positioned prefill and
``prefill_chunk`` logits within 1e-4 (the same stack as the port's other
logit tests); and the chunked engine's greedy streams and prefill counters
must equal the reference engine's. The last group holds the port to the
reference's own chunked-scheduler contracts (``tests/test_scheduler.py``):
chunked streams equal monolithic ones, preemption and cancellation with
chunks in flight, and the SLO controller as a no-op without deadlines.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.kernels.chunk_prefill import ops as jcp
from repro.models import kv_quant as jkq
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.layers import ModelOptions as JOpts
from repro.serving import scheduler as JS
from repro_torch.kernels.chunk_prefill import paged as pcp
from repro_torch.models import kv_quant as tkq
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import scheduler as TS
from test_torch_serving import (LAYOUTS, _requests, assert_same_run,
                                port_params, run_port, run_ref)

JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
TDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _codes(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(seed, *shape, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(
        shape, dtype=np.float32)


# ---------------------------------------------------------------------------
# the copied policy: plan_tick and SLOController.plan
# ---------------------------------------------------------------------------

class _Req:
    def __init__(self, priority, t_deadline):
        self.priority, self.t_deadline = priority, t_deadline


def _sched_pair(seed):
    """The same scheduler state in both modules: 0-5 in-flight tasks with
    mixed classes, deadlines, progress and stall flags."""
    rng = np.random.default_rng(seed)
    chunk, budget = int(rng.integers(1, 40)), int(rng.integers(1, 96))
    pair = (JS.ChunkedScheduler(chunk, budget),
            TS.ChunkedScheduler(chunk, budget))
    for slot in rng.permutation(8)[:int(rng.integers(0, 6))]:
        rt = bool(rng.random() < 0.4)
        req = _Req(JS.REALTIME if rt else JS.BEST_EFFORT,
                   float(rng.integers(1, 5)) if rt else math.inf)
        total = int(rng.integers(1, 200))
        skip = int(rng.integers(0, total))
        done = int(rng.integers(0, total - skip))
        stalled = bool(rng.random() < 0.3)
        for mod, sched in zip((JS, TS), pair):
            t = sched.start_task(mod.PrefillTask(req=req, slot=int(slot),
                                                 total=total, n_skip=skip))
            t.pos += done
            t.stalled = stalled
    return rng, pair


def _plan_key(plan):
    return ([(c.task.slot, c.start, c.n_tok) for c in plan.chunks],
            plan.decode_steps, plan.budget_used)


@pytest.mark.parametrize("seed", range(6))
def test_plan_tick_matches_reference(seed):
    rng, (js, ts) = _sched_pair(seed)
    for _ in range(8):
        n_active, tick = int(rng.integers(0, 9)), int(rng.integers(1, 12))
        slo = None
        if rng.random() < 0.5:
            need = int(rng.integers(0, 12))
            quota = [None, 0, int(rng.integers(1, 40))][rng.integers(0, 3)]
            slo = (JS.SLOTick(need, quota), TS.SLOTick(need, quota))
        jp = js.plan_tick(n_active, tick, slo=slo and slo[0])
        tp = ts.plan_tick(n_active, tick, slo=slo and slo[1])
        assert _plan_key(tp) == _plan_key(jp)
        assert tp.budget_used <= max(ts.token_budget,
                                     n_active * tp.decode_steps)


@pytest.mark.parametrize("seed", range(2))
def test_slo_controller_and_victims_match_reference(seed):
    rng = np.random.default_rng(100 + seed)
    hz = float(rng.uniform(1, 30))
    jc, tc = JS.SLOController(hz), TS.SLOController(hz)
    for _ in range(20):
        now, ewma = float(rng.uniform(0, 10)), float(rng.uniform(0, 0.5))
        rt = [(int(rng.integers(-1, 50)),
               float(now + rng.uniform(-1, 5)) if rng.random() < 0.8
               else math.inf) for _ in range(int(rng.integers(0, 5)))]
        pending = bool(rng.random() < 0.3)
        j, t = jc.plan(now, ewma, rt, pending), tc.plan(now, ewma, rt, pending)
        assert (t.decode_need, t.be_chunk_quota) == (j.decode_need,
                                                     j.be_chunk_quota)
    _, (js, ts) = _sched_pair(seed + 7)
    assert TS.eviction_victims(ts.tasks) == JS.eviction_victims(js.tasks)
    assert ([t.slot for t in sorted(ts.tasks.values(),
                                    key=TS.task_order_key)]
            == [t.slot for t in sorted(js.tasks.values(),
                                       key=JS.task_order_key)])


# ---------------------------------------------------------------------------
# the chunk write paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,n_valid", [(5, 7), ((3, 17), (4, 7)),
                                           (14, 2)])
def test_update_cache_chunk_drops_padding_rows(start, n_valid):
    """Rows at or past n_valid are dropped, also where they would land past
    the cache (start 14 + 7 rows > Smax 20); device start and n_valid."""
    cache = _rand(0, 2, 20, 2, 16)
    new = _rand(1, 2, 7, 2, 16)
    want = JL.update_cache_chunk(jnp.asarray(cache), jnp.asarray(new),
                                 jnp.asarray(start, jnp.int32),
                                 jnp.asarray(n_valid, jnp.int32))
    tc = torch.from_numpy(cache.copy())
    TL.update_cache_chunk(tc, torch.from_numpy(new), torch.tensor(start),
                          torch.tensor(n_valid))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(want))


def _chunk_writes(policy):
    """Two chunk writes of B=2 slots into a pool of page size 4: the first
    from an unaligned start with padding rows, the second larger (a head
    scale grows on a page the first one wrote)."""
    table = np.array([[3, 1, 5, 7, 0], [2, 4, 6, 8, 9]], np.int32)
    writes = [(np.array([2, 5]), np.array([5, 3]), _rand(20, 2, 6, 2, 16)),
              (np.array([7, 8]), np.array([6, 6]),
               _rand(21, 2, 6, 2, 16, scale=4.0))]
    return table, writes


@pytest.mark.parametrize("policy", ["f32", "int8-head", "int8-token",
                                    "fp8-head", "fp8-token"])
def test_update_cache_paged_chunk_matches_reference(policy):
    table, writes = _chunk_writes(policy)
    P, ps, K, h = 10, 4, 2, 16
    kv_dtype, _, gran = policy.partition("-")
    quant = kv_dtype != "f32"
    jpages = jnp.zeros((P, ps, K, h), JDT[kv_dtype] if quant
                       else jnp.float32)
    tpages = torch.zeros((P, ps, K, h), dtype=TDT[kv_dtype] if quant
                         else torch.float32)
    sshape = (P, ps, K) if gran == "token" else (P, K)
    jsc = jnp.zeros(sshape, jnp.float32) if quant else None
    tsc = torch.zeros(sshape) if quant else None
    for start, nv, new in writes:
        jpages, jsc = JL.update_cache_paged_chunk(
            jpages, jnp.asarray(new), jnp.asarray(table),
            jnp.asarray(start, jnp.int32), jnp.asarray(nv, jnp.int32), jsc)
        TL.update_cache_paged_chunk(tpages, torch.from_numpy(new),
                                    torch.from_numpy(table),
                                    torch.from_numpy(start),
                                    torch.from_numpy(nv), tsc)
    np.testing.assert_array_equal(_codes(tpages), _codes(jpages))
    assert not tpages[0].float().abs().max()     # padding rows sank as 0
    if quant:
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        bc = (lambda s: s[:, None, :, None]) if gran == "head" \
            else (lambda s: s[..., None])
        np.testing.assert_allclose(
            tkq.decode(tpages, bc(tsc)).numpy(),
            np.asarray(jkq.decode(jpages, bc(jsc))), rtol=1e-6, atol=1e-6)
    if gran == "head":          # the second write grew page 5's scale
        assert float(tsc[5].min()) > 0


# ---------------------------------------------------------------------------
# the paged chunk kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["f32", "bf16", "int8-head",
                                     "int8-token", "fp8-head", "fp8-token"])
def test_paged_chunk_plain_matches_pallas_kernel(storage):
    """B=2 slots of 5 pages of 8 in a shuffled pool, chunks of 9 rows at
    starts 24 and 3; window 0 and 10."""
    rng = np.random.default_rng(7)
    P, ps, K, h, N, B, S = 12, 8, 2, 16, 4, 2, 9
    table = rng.permutation(np.arange(1, P))[:B * 5].reshape(B, 5) \
        .astype(np.int32)
    index = np.array([24, 3], np.int32)
    q = rng.standard_normal((B, S, N, h), dtype=np.float32)
    kind, _, gran = storage.partition("-")
    pools = []
    for _ in range(2):
        rows = rng.standard_normal((P, ps, K, h), dtype=np.float32)
        if kind in ("f32", "bf16"):
            jt = jnp.asarray(rows, jnp.bfloat16 if kind == "bf16"
                             else jnp.float32)
            pools.append((jt, torch.from_numpy(_codes(jt)).to(
                torch.bfloat16 if kind == "bf16" else torch.float32),
                None, None))
            continue
        jc, js = jkq.quantize_page_rows(jnp.asarray(rows), JDT[kind], gran)
        tc, ts = tkq.quantize_page_rows(torch.from_numpy(rows), TDT[kind],
                                        gran)
        pools.append((jc, tc, js, ts))
    (jk, tk, jks, tks), (jv, tv, jvs, tvs) = pools
    for window in (0, 10):
        ref = jcp.paged_chunk_prefill_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(table),
            jnp.asarray(index), k_scales=jks, v_scales=jvs, window=window,
            interpret=True)
        got = pcp.paged_chunk_prefill_attention(
            torch.from_numpy(q), tk, tv, torch.from_numpy(table),
            torch.from_numpy(index), k_scales=tks, v_scales=tvs,
            window=window)
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref) / np.maximum(1.0, np.abs(ref))
        assert err.max() <= 1e-5, (window, err.max())


# ---------------------------------------------------------------------------
# positioned prefill and prefill_chunk
# ---------------------------------------------------------------------------

def _bridge(name):
    _, jparams = reduced_params(name)
    tcfg, tparams = port_params(name)
    return reduced_params(name)[0], jparams, tcfg, tparams


def test_positioned_prefill_matches_reference():
    """A 5-token prefill, then the 7-token suffix at cache_index 5, dense
    f32 caches: logits within 1e-4 of the reference's, and the port's
    suffix logits within 1e-4 of its own monolithic prefill. Positioned
    prefill without caches raises."""
    jcfg, jparams, tcfg, tparams = _bridge("smollm-135m")
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size, (1, 12))
    jo = JOpts(remat=False)
    jl_a, jc = JM.prefill(jcfg, jo, jparams, {"tokens": prompt[:, :5]}, 32,
                          cache_dtype=jnp.float32)
    jl_b, _ = JM.prefill(jcfg, jo, jparams, {"tokens": prompt[:, 5:]}, 32,
                         caches=jc, cache_index=5)
    to = TOpts()
    tl_m, _ = TM.prefill(tcfg, to, tparams, {"tokens": prompt}, 32,
                         cache_dtype=torch.float32, device="cpu")
    tl_a, tc = TM.prefill(tcfg, to, tparams, {"tokens": prompt[:, :5]}, 32,
                          cache_dtype=torch.float32, device="cpu")
    tl_b, _ = TM.prefill(tcfg, to, tparams, {"tokens": prompt[:, 5:]}, 32,
                         caches=tc, cache_index=5, device="cpu")
    for got, want in ((tl_a, jl_a), (tl_b, jl_b), (tl_b, tl_m)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=1e-4)
    with pytest.raises(ValueError, match="existing caches"):
        TM.prefill(tcfg, to, tparams, {"tokens": prompt}, 32, cache_index=5,
                   device="cpu")


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_prefill_chunk_matches_reference(layout):
    """molmoact-7b's embedded prompt (vision prefix + 6 tokens = 14
    positions) in chunks of 8: the second chunk holds 6 valid rows and 2
    padding rows, with a device start and n_valid. Last-valid-row logits
    within 1e-4 of the reference's, and the caches' rows (dense) or pool
    (paged, page size 8) too."""
    jcfg, jparams, tcfg, tparams = _bridge("molmoact-7b")
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (1, 6)),
             "patches": rng.standard_normal(
                 (1, tcfg.vision.num_tokens, tcfg.vision.embed_dim),
                 dtype=np.float32)}
    jo, to = JOpts(remat=False), TOpts()
    je = JM.embed_prompt(jcfg, jo, jparams, batch)
    te = TM.embed_prompt(tcfg, to, tparams, batch, device="cpu")
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5)
    paged = layout == "paged"
    kw = dict(paged=True, num_pages=5, page_size=8) if paged else {}
    jc = JM.init_caches(jcfg, 1, 32, jnp.float32, jo, **kw)
    tc = TM.init_caches(tcfg, 1, 32, torch.float32, device="cpu", **kw)
    table = np.array([[3, 1, 4, 2]], np.int32) if paged else None
    for start in (0, 8):
        n = min(8, te.shape[1] - start)
        jch = jnp.zeros((1, 8, je.shape[-1])).at[:, :n].set(
            je[:, start:start + n])
        tch = torch.zeros(1, 8, te.shape[-1])
        tch[:, :n] = te[:, start:start + n]
        jkw = dict(page_table=jnp.asarray(table)) if paged else {}
        jl, jc = JM.prefill_chunk(jcfg, jo, jparams, jch, jc,
                                  jnp.asarray(start, jnp.int32),
                                  n_valid=jnp.asarray(n, jnp.int32),
                                  live_len=start + 8, **jkw)
        tl, tc = TM.prefill_chunk(
            tcfg, to, tparams, tch, tc, torch.tensor(start, dtype=torch.int32),
            n_valid=torch.tensor(n, dtype=torch.int32),
            page_table=torch.from_numpy(table) if paged else None,
            live_len=start + 8, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    jk = np.asarray(jc["blocks"]["sub0"]["k"])
    tk = tc["blocks"]["sub0"]["k"].numpy()
    # paged: padding rows sank into page 0 as zeros, in both
    np.testing.assert_allclose(tk, jk, atol=1e-5)
    if not paged:
        assert not np.abs(tk[:, :, 14:]).max()


# ---------------------------------------------------------------------------
# the chunked engine against the reference engine
# ---------------------------------------------------------------------------

CHUNK_LAYOUTS = ["dense", "paged-bf16", "int8-head", "fp8-token"]


def assert_same_chunked_run(port, ref):
    assert_same_run(port, ref)
    (_, pe), (_, re) = port, ref
    for f in ("prefill_tokens", "prefill_skipped", "tick_prefill_tokens",
              "prefill_syncs", "prefill_key_lanes"):
        assert getattr(pe.stats, f) == getattr(re.stats, f), f


@pytest.mark.parametrize("chunk", [8, 32], ids=["page", "whole_prompt"])
@pytest.mark.parametrize("layout", CHUNK_LAYOUTS)
def test_chunked_engine_matches_reference(layout, chunk):
    """smollm-135m, 5 requests of mixed lengths on 2 slots (chunks of a page,
    or one padded chunk per prompt); a budget of 16 splits prompts across
    ticks beside decoding slots."""
    cfg, _ = port_params("smollm-135m")
    reqs = _requests(cfg, 2, [(4, 7), (19, 3), (6, 12), (11, 5), (8, 9)])
    kw = dict(chunked_prefill=True, chunk_size=chunk,
              token_budget=max(16, chunk), **LAYOUTS[layout])
    port = run_port("smollm-135m", reqs, **kw)
    assert_same_chunked_run(port, run_ref("smollm-135m", reqs, **kw))
    assert max(port[1].stats.tick_prefill_tokens) <= max(16, chunk)


@pytest.mark.parametrize("layout", CHUNK_LAYOUTS)
def test_chunked_vla_engine_matches_reference(layout):
    """molmoact-7b with a vision prefix per request, each observation sent
    twice: in the paged engines a twin admitted after its original's
    chunks registered their pages skips them (prefill_skipped > 0)."""
    cfg, _ = port_params("molmoact-7b")
    reqs = _requests(cfg, 4, [(8, 6), (5, 9), (7, 4)], patches=True,
                     repeat=True)
    kw = dict(n_slots=3, chunked_prefill=True, chunk_size=8, token_budget=16,
              **LAYOUTS[layout])
    port = run_port("molmoact-7b", reqs, **kw)
    assert_same_chunked_run(port, run_ref("molmoact-7b", reqs, **kw))
    st = port[1].stats
    total = sum(cfg.vision.num_tokens + len(p) for p, _, _ in reqs)
    assert st.prefill_tokens + st.prefill_skipped == total
    if layout != "dense":
        assert st.prefill_skipped > 0


# ---------------------------------------------------------------------------
# the reference's chunked-scheduler contracts, inside the port
# ---------------------------------------------------------------------------

def _streams(reqs, n_slots=2, max_seq=64, **kw):
    cfg, params = port_params("smollm-135m")
    eng = ServingEngine(cfg, TOpts(), params, n_slots=n_slots,
                        max_seq=max_seq, eos=-999, tick_tokens=4,
                        device="cpu", **kw)
    for i, (prompt, m) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=prompt.copy(), max_tokens=m))
    done = eng.run(max_ticks=2_000)
    assert len(done) == len(reqs)
    return {r.uid: r.out_tokens for r in done}, eng


def _prompts(seed, shape):
    rng = np.random.default_rng(seed)
    cfg, _ = port_params("smollm-135m")
    return [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m)
            for n, m in shape]


def test_chunked_matches_monolithic_dense_and_paged():
    """A chunk size that divides nothing (5 into 13/9/21/5) and a page-sized
    one: greedy streams equal the admit-stall engine's."""
    reqs = _prompts(0, [(13, 7), (9, 5), (21, 8), (5, 6)])
    base, _ = _streams(reqs)
    dense, e_d = _streams(reqs, chunked_prefill=True, chunk_size=5,
                          token_budget=20)
    paged, e_p = _streams(reqs, chunked_prefill=True, chunk_size=8,
                          token_budget=20, paged=True, page_size=8)
    assert dense == base and paged == base
    total = sum(len(p) for p, _ in reqs)
    for e in (e_d, e_p):
        assert e.stats.prefill_tokens + e.stats.prefill_skipped == total
        assert len(e.stats.ttft_s) == len(e.stats.queue_s) == len(reqs)
        assert e.stats.decode_syncs <= e.stats.ticks


def test_prefix_hit_covering_entire_prompt():
    """A repeat of a 2-page prompt skips all but its final page and emits
    the first run's stream."""
    (prompt, _), = _prompts(2, [(16, 5)])
    cfg, params = port_params("smollm-135m")
    eng = ServingEngine(cfg, TOpts(), params, n_slots=2, max_seq=64,
                        eos=-999, tick_tokens=4, chunked_prefill=True,
                        chunk_size=8, token_budget=24, paged=True,
                        page_size=8, device="cpu")
    eng.submit(Request(uid=0, prompt=prompt.copy(), max_tokens=5))
    eng.run()
    eng.submit(Request(uid=1, prompt=prompt.copy(), max_tokens=5))
    r0, r1 = sorted(eng.run(), key=lambda r: r.uid)
    assert r1.out_tokens == r0.out_tokens
    assert r1.prefill_skipped == 8 and eng.stats.prefill_tokens == 16 + 8
    assert r1.pages_shared >= 1


def test_preempt_requeue_with_inflight_chunks():
    """A pool too small for everyone preempts mid-prefill tasks; every
    stream still matches the ample-pool admit-stall run, and the pool
    drains."""
    reqs = _prompts(3, [(20, 8), (24, 6), (12, 5)])
    base, _ = _streams(reqs, n_slots=3)
    tiny, eng = _streams(reqs, n_slots=3, chunked_prefill=True, chunk_size=8,
                         token_budget=16, paged=True, page_size=8,
                         num_pages=9, reserve_pages=1)
    assert tiny == base
    assert eng.pool.pages_in_use == 0
    assert sum(eng.stats.preemptions.values()) > 0


def test_decode_tick_does_not_clobber_inflight_prefill():
    """A decoding slot's ticks interleave with another slot's chunks: the
    mid-prefill slot's page-table row is nulled in the decode snapshot."""
    reqs = _prompts(4, [(6, 12), (24, 5)])
    base, _ = _streams(reqs)
    ch, _ = _streams(reqs, chunked_prefill=True, chunk_size=8,
                     token_budget=10, paged=True, page_size=8)
    assert ch == base


@pytest.mark.parametrize("paged", [False, True])
def test_cancel_mid_prefill(paged):
    """cancel() of a task with chunks in flight drops it, frees its pages,
    and leaves the other request's stream as if alone."""
    reqs = _prompts(5, [(30, 6), (9, 6)])
    alone, _ = _streams(reqs[1:])
    cfg, params = port_params("smollm-135m")
    kw = dict(paged=True, page_size=8) if paged else {}
    eng = ServingEngine(cfg, TOpts(), params, n_slots=2, max_seq=64,
                        eos=-999, tick_tokens=4, chunked_prefill=True,
                        chunk_size=8, token_budget=12, device="cpu", **kw)
    for i, (p, m) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=p.copy(), max_tokens=m))
    eng.step_fused()
    assert 0 in eng.scheduler.tasks and eng.scheduler.tasks[0].pos < 30
    assert eng.cancel(0) and not eng.cancel(0)
    done = eng.run()
    assert [r.uid for r in done] == [1]
    assert done[0].out_tokens == alone[0]
    if paged:
        assert eng.stats.pages_in_use == 0


@pytest.mark.parametrize("case", ["admit-stall-finish", "chunked-finish",
                                  "cancel", "cancel-paged", "preempt"])
def test_slot_device_state_freed(case):
    """A request that leaves before the stage that consumes its batch-1
    cache or prompt embeddings (it finishes at prefill, is cancelled or is
    preempted mid-prefill) leaves neither behind in the engine."""
    chunked = dict(chunked_prefill=True, chunk_size=8, token_budget=12)
    if case.endswith("finish"):
        reqs = [(p, 1) for p, _ in _prompts(6, [(13, 1), (9, 1)])]
        _, eng = _streams(reqs, **(chunked if case.startswith("chunked")
                                   else {}))
    else:
        cfg, params = port_params("smollm-135m")
        kw = (dict(paged=True, page_size=8) if case != "cancel" else {})
        eng = ServingEngine(cfg, TOpts(), params, n_slots=2, max_seq=64,
                            eos=-999, tick_tokens=4, device="cpu",
                            **chunked, **kw)
        for i, (p, m) in enumerate(_prompts(5, [(30, 6), (9, 6)])):
            eng.submit(Request(uid=i, prompt=p.copy(), max_tokens=m))
        eng.step_fused()
        assert 0 in eng.scheduler.tasks and 0 in eng._embeds
        if case == "preempt":
            eng._preempt_slot(0)
            assert sum(eng.stats.preemptions.values()) == 1
        else:
            assert eng.cancel(0)
        assert 0 not in eng._embeds and 0 not in eng._cache1
        eng.run()
    assert eng._cache1 == {} and eng._embeds == {}


def test_slo_engine_bit_equal_on_best_effort_workload():
    reqs = _prompts(10, [(13, 6), (29, 4), (7, 7)])
    kw = dict(chunked_prefill=True, chunk_size=16, token_budget=16,
              paged=True, page_size=8)
    base, _ = _streams(reqs, **kw)
    slo, _ = _streams(reqs, slo_hz=10.0, **kw)
    assert slo == base


def test_realtime_jumps_best_effort_backlog():
    reqs = _prompts(9, [(48, 6)] * 3)
    cfg, params = port_params("smollm-135m")
    eng = ServingEngine(cfg, TOpts(), params, n_slots=2, max_seq=64,
                        eos=-999, tick_tokens=4, paged=True, page_size=8,
                        chunked_prefill=True, chunk_size=16, token_budget=16,
                        slo_hz=20.0, device="cpu")
    for i, (p, m) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=p.copy(), max_tokens=m))
    (rt_prompt, _), = _prompts(19, [(8, 4)])
    eng.submit(Request(uid=99, prompt=rt_prompt, max_tokens=4,
                       priority="realtime", deadline_s=60.0))
    done = eng.run(max_ticks=2_000)
    assert len(done) == 4 and done[0].uid == 99
    rep = eng.stats.phase_report()
    assert rep["deadline_attainment_realtime"] == 1.0
    assert rep["tick_ewma_s"] > 0


def test_chunked_engine_validations():
    cfg, params = port_params("smollm-135m")
    for kw, match in ((dict(fused=False), "fused"),
                      (dict(paged=True, page_size=16, chunk_size=24),
                       "page_size"),
                      (dict(slo_hz=-1.0), "slo_hz")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(cfg, TOpts(), params, max_seq=64,
                          chunked_prefill=True, device="cpu", **kw)
    eng = ServingEngine(cfg, TOpts(), params, max_seq=64,
                        chunked_prefill=True, device="cpu")
    with pytest.raises(RuntimeError, match="step_fused"):
        eng.step()
