"""The port's serving engine against the JAX reference engine.

Both engines get the reference's weights (the port's through ``from_jax``)
and the same requests, made with numpy from seeds: mixed prompt lengths and
budgets, more requests than slots (so slots free and refill at different
ticks). Greedy streams must be equal, and so must the counters the
reference defines (``device_steps``, ``ticks``, ``prefix_hits``,
``pages_hwm``), for the dense layout, paged unquantized pools and int8/fp8
pools at both scale granularities, fused and per-token. Quantized streams
are compared with the reference's quantized streams, never with bf16.
"""
import math

import jax
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.models.layers import ModelOptions as JOpts
from repro.serving import Request as JReq
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models.layers import ModelOptions as TOpts
from repro_torch.models.params import leaves
from repro_torch.models.stacks import is_paged_leaf, is_scale_leaf
from repro_torch.serving import PoolExhausted, Request, ServingEngine

LAYOUTS = {
    "dense": {},
    "paged-bf16": dict(paged=True, page_size=8),
    "int8-head": dict(paged=True, page_size=8, kv_dtype="int8"),
    "int8-token": dict(paged=True, page_size=8, kv_dtype="int8",
                       scale_granularity="token"),
    "fp8-head": dict(paged=True, page_size=8, kv_dtype="fp8"),
    "fp8-token": dict(paged=True, page_size=8, kv_dtype="fp8",
                      scale_granularity="token"),
}
_PORT = {}


def port_params(name):
    if name not in _PORT:
        jcfg, jparams = reduced_params(name)
        tcfg = get_config(name).reduced()
        _PORT[name] = (tcfg, TP.from_jax(TM.model_template(tcfg),
                                         jax.tree.map(np.asarray, jparams),
                                         device="cpu"))
    return _PORT[name]


def _requests(cfg, seed, shape, patches=False, repeat=False):
    """(prompt, max_tokens, patches) triples; ``repeat`` submits each
    observation twice in a row, so its twin hits the prefix cache."""
    rng = np.random.default_rng(seed)
    out = []
    for length, budget in shape:
        px = (rng.standard_normal((cfg.vision.num_tokens,
                                   cfg.vision.embed_dim), dtype=np.float32)
              if patches else None)
        req = (rng.integers(0, cfg.vocab_size, length, dtype=np.int32),
               budget, px)
        out += [req, req] if repeat else [req]
    return out


MIXED = [(4, 7), (9, 3), (6, 12), (3, 5), (8, 9)]


def run_port(name, reqs, n_slots=2, max_seq=48, tick_tokens=4, opts=None,
             **kw):
    """``opts``: ModelOptions fields the two frameworks share."""
    cfg, params = port_params(name)
    params = kw.pop("weights", params)
    eng = ServingEngine(cfg, TOpts(**(opts or {})), params, n_slots=n_slots,
                        max_seq=max_seq, eos=kw.pop("eos", -999),
                        tick_tokens=tick_tokens, device="cpu", **kw)
    for i, (prompt, m, px) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=prompt.copy(), max_tokens=m,
                           patches=px))
    done = eng.run()
    assert len(done) == len(reqs)
    return {r.uid: r.out_tokens for r in done}, eng


def run_ref(name, reqs, n_slots=2, max_seq=48, tick_tokens=4, pallas=False,
            opts=None, **kw):
    cfg, params = reduced_params(name)
    jopts = JOpts(remat=False, use_pallas=pallas, pallas_interpret=pallas,
                  **(opts or {}))
    eng = JEngine(cfg, jopts, params, n_slots=n_slots, max_seq=max_seq,
                  eos=kw.pop("eos", -999), tick_tokens=tick_tokens, **kw)
    for i, (prompt, m, px) in enumerate(reqs):
        eng.submit(JReq(uid=i, prompt=prompt.copy(), max_tokens=m,
                        patches=px))
    done = eng.run()
    return {r.uid: r.out_tokens for r in done}, eng


def assert_same_run(port, ref):
    (pt, pe), (rt, re) = port, ref
    assert pt == rt
    for f in ("device_steps", "ticks", "decode_syncs", "tokens_decoded",
              "prefix_hits", "pages_hwm", "pages_in_use", "cache_bytes_hwm"):
        assert getattr(pe.stats, f) == getattr(re.stats, f), f


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "per_token"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_engine_matches_reference(layout, fused):
    """Mixed lengths and budgets, 5 requests on 2 slots (mid-stream
    admission); the fused tick stops at each finish, so later steps of a
    tick run masked."""
    cfg, _ = port_params("qwen1.5-0.5b")
    reqs = _requests(cfg, 2, MIXED)
    port = run_port("qwen1.5-0.5b", reqs, fused=fused, **LAYOUTS[layout])
    assert_same_run(port, run_ref("qwen1.5-0.5b", reqs, fused=fused,
                                  **LAYOUTS[layout]))
    assert all(len(port[0][i]) == m for i, (_, m, _) in enumerate(reqs))
    if fused:
        assert port[1].masked_steps > 0
    else:
        assert port[1].masked_steps == 0


@pytest.mark.parametrize("layout", ["dense", "paged-bf16", "int8-head",
                                    "fp8-token"])
def test_engine_matches_reference_pallas_path(layout):
    """The reference engine through its Pallas kernels (interpret mode)."""
    cfg, _ = port_params("qwen1.5-0.5b")
    reqs = _requests(cfg, 3, MIXED[:4])
    assert_same_run(run_port("qwen1.5-0.5b", reqs, **LAYOUTS[layout]),
                    run_ref("qwen1.5-0.5b", reqs, pallas=True,
                            **LAYOUTS[layout]))


@pytest.mark.parametrize("layout", ["dense", "paged-bf16", "int8-token"])
def test_vla_engine_matches_reference(layout):
    """molmoact-7b with a vision prefix per request; each observation is
    sent twice, so the paged engine's twins share its full prompt pages."""
    cfg, _ = port_params("molmoact-7b")
    reqs = _requests(cfg, 4, [(8, 6), (5, 9), (7, 4)], patches=True,
                     repeat=True)
    port = run_port("molmoact-7b", reqs, n_slots=3, **LAYOUTS[layout])
    assert_same_run(port, run_ref("molmoact-7b", reqs, n_slots=3,
                                  **LAYOUTS[layout]))
    if layout != "dense":
        assert port[1].stats.prefix_hits >= 3
        assert port[1].stats.vision_time > 0


@pytest.mark.parametrize("paged", [False, True])
def test_fused_host_sync_bound(paged):
    """One readback per fused tick: ceil(N/K) decode syncs for an N-token
    decode, N on the per-token path."""
    cfg, _ = port_params("smollm-135m")
    N, K = 10, 4
    reqs = _requests(cfg, 4, [(5, N + 1)])
    kw = LAYOUTS["paged-bf16"] if paged else {}
    _, ref = run_port("smollm-135m", reqs, n_slots=1, tick_tokens=K,
                      fused=False, **kw)
    _, fus = run_port("smollm-135m", reqs, n_slots=1, tick_tokens=K, **kw)
    assert ref.stats.decode_syncs == N
    assert fus.stats.decode_syncs == fus.stats.ticks == math.ceil(N / K)
    assert fus.stats.tokens_decoded == ref.stats.tokens_decoded == N
    assert fus.stats.prefill_syncs == 1


def test_pool_exhaustion_defers_and_growth_preempts():
    """An under-provisioned pool defers admission, and decode growth
    preempts a slot and retries it; streams and page counts match the
    reference's."""
    cfg, _ = port_params("smollm-135m")
    defer = _requests(cfg, 9, [(8, 6)] * 4)
    grow = _requests(cfg, 13, [(8, 17)] * 2)
    for reqs, max_seq in ((defer, 48), (grow, 32)):
        kw = dict(max_seq=max_seq, num_pages=6, **LAYOUTS["int8-head"])
        port = run_port("smollm-135m", reqs, **kw)
        assert_same_run(port, run_ref("smollm-135m", reqs, **kw))
        assert port[1].stats.pages_hwm <= 5
        assert port[1].stats.pages_in_use == 0
    assert port[1].stats.preemptions.get("best_effort", 0) > 0
    with pytest.raises(PoolExhausted, match="too small"):
        run_port("smollm-135m", _requests(cfg, 14, [(20, 4)]), max_seq=32,
                 num_pages=3, paged=True, page_size=8)


def test_quantized_null_page_stays_zero_and_growth_scales_are_clean():
    """Retired slots riding the tick leave page 0 all zero; pages granted
    by decode growth start from zero scales."""
    cfg, params = port_params("smollm-135m")
    eng = ServingEngine(cfg, TOpts(), params, n_slots=2, max_seq=32,
                        eos=-999, paged=True, page_size=8, kv_dtype="int8",
                        device="cpu")
    eng.submit(Request(uid=0, prompt=np.arange(8, dtype=np.int32),
                       max_tokens=10))
    eng._admit()
    held = list(eng.pool.slot_pages[0])
    for path, leaf in leaves(eng.caches):
        if is_scale_leaf(path):
            leaf += 7.0
    eng._ensure_pages(eng.tick_tokens)
    grown = [p for p in eng.pool.slot_pages[0] if p not in held]
    assert grown
    for path, leaf in leaves(eng.caches):
        if is_scale_leaf(path):
            assert not leaf[:, grown].abs().max()
            assert float(leaf[:, held].min()) >= 7.0
            leaf[:, held] -= 7.0
            leaf[:, 0] = 0.0
    eng.run()
    for path, leaf in leaves(eng.caches):
        if is_paged_leaf(path):
            assert not leaf[:, 0].float().abs().max(), path


def test_cancel_and_temperature_sampling():
    """cancel() frees a live slot's pages; temperature sampling is keyed on
    the engine's seed (same seed, same streams; another seed, others)."""
    cfg, params = port_params("smollm-135m")
    reqs = _requests(cfg, 15, [(6, 6), (6, 6)])
    a, _ = run_port("smollm-135m", reqs, temperature=0.8, seed=5)
    b, _ = run_port("smollm-135m", reqs, temperature=0.8, seed=5)
    c, _ = run_port("smollm-135m", reqs, temperature=0.8, seed=6)
    assert a == b and a != c
    eng = ServingEngine(cfg, TOpts(), params, n_slots=2, max_seq=48,
                        eos=-999, paged=True, page_size=8, tick_tokens=4,
                        device="cpu")
    for i, (prompt, m, _) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=prompt, max_tokens=m))
    eng.step_fused()
    assert eng.cancel(0) and not eng.cancel(99)
    eng.run()
    assert [r.uid for r in eng.finished] == [1]
    assert eng.stats.pages_in_use == 0


@pytest.mark.parametrize("layout", ["dense", "int8-head"])
def test_sampled_streams_do_not_depend_on_masked_steps(layout):
    """At temperature > 0 a request's stream is the same whatever the tick
    size, so whatever the number of masked steps, and in per-token mode."""
    cfg, _ = port_params("qwen1.5-0.5b")
    reqs = _requests(cfg, 2, MIXED)
    kw = dict(temperature=1.5, top_k=40, seed=3, **LAYOUTS[layout])
    runs = [run_port("qwen1.5-0.5b", reqs, tick_tokens=k, fused=fused, **kw)
            for k, fused in ((1, False), (3, True), (8, True))]
    streams = [r[0] for r in runs]
    assert streams[0] == streams[1] == streams[2]
    assert runs[1][1].masked_steps != runs[2][1].masked_steps
    assert streams[0] != run_port("qwen1.5-0.5b", reqs,
                                  **LAYOUTS[layout])[0]


@pytest.mark.parametrize("option", [dict(mesh=1)], ids=["mesh"])
def test_unported_options_name_their_roadmap_item(option):
    """No engine option is left unported: the last one refused, ``mesh``
    (sharded serving), now serves. A one-rank serving mesh (no worker)
    gives the unsharded streams and reports its shape; more ranks are
    tests/test_torch_sharded.py's."""
    cfg, params = port_params("smollm-135m")
    reqs = _requests(cfg, 2, MIXED)
    kw = dict(LAYOUTS["paged-bf16"])
    want = run_port("smollm-135m", reqs, **kw)[0]
    mesh = make_serving_mesh(option["mesh"])
    got, eng = run_port("smollm-135m", reqs, mesh=mesh, graphs=False,
                        weights=lambda c, device, shard: params, **kw)
    assert got == want
    assert eng.stats.mesh_shape == (("model", 1),)
    assert eng.stats.cache_bytes_hwm_shard == eng.stats.cache_bytes_hwm


def test_chunked_prefill_option_is_accepted():
    """chunked_prefill (ROADMAP item 8) is ported: the engine takes it,
    with its chunk size, budget and decode reserve, and validates it."""
    cfg, params = port_params("smollm-135m")
    eng = ServingEngine(cfg, TOpts(), params, device="cpu", max_seq=64,
                        chunked_prefill=True, chunk_size=16, token_budget=48,
                        paged=True, page_size=8)
    assert (eng.scheduler.chunk_size, eng.scheduler.token_budget) == (16, 48)
    assert eng.pool.reserve == eng.n_slots
    with pytest.raises(ValueError, match="must divide by page_size"):
        ServingEngine(cfg, TOpts(), params, device="cpu", max_seq=64,
                      chunked_prefill=True, chunk_size=12, paged=True,
                      page_size=8)


def test_engine_validations():
    cfg, params = port_params("smollm-135m")
    for kw, match in ((dict(max_seq=50, paged=True, page_size=16),
                       "must divide"),
                      (dict(kv_dtype="int8"), "requires paged"),
                      (dict(scale_granularity="token"), "only to quantized"),
                      (dict(slo_hz=5.0), "requires chunked_prefill"),
                      (dict(tick_tokens=0), "tick_tokens")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(cfg, TOpts(), params, device="cpu", **kw)
