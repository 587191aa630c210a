"""The port's self-speculative decode against the JAX reference, on the
CPU, and the repair of a decode write past a full cache.

- ``sampler.spec_accept`` on edge batches and on random ones (hypothesis)
  equals the reference's rule.
- ``kv_quant.fake_quantize_tree`` through ``params.from_jax`` equals the
  reference's round trip bit for bit (int8 and fp8; the port's fp8 clamp
  at +-448 changes no weight).
- ``model.draft_step`` and ``model.verify_chunk`` from per-slot starts,
  rows past the cache and a dead slot, dense and paged: logits (of the
  rows inside the cache) and caches within f32 tolerance (1e-4 relative
  to max(1, |ref|)) of the reference's; ``verify_chunk`` over the whole
  view equals it over the live band bit for bit (what the graphed tick
  relies on).
- The spec engine's greedy streams and ``spec_accept_hist`` equal the
  reference spec engine's on reduced smollm-135m (dense K=4, paged K=2,
  int8-token K=8), and equal the port's own fused streams over {dense,
  paged, int8-token} x K in {2, 4, 8}, eagerly and through the round's
  runner; ctor refusals; a cancel between rounds drains the pool.
- A decode write past a full cache (a budget clamped to the cache, then
  more ticks): the streams equal the reference engine's, dense, paged and
  MoE, and a paged write past the table is dropped as the reference's is.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.models import kv_quant as JQ
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import sampler as JS
from repro_torch.configs import get_config
from repro_torch.models import kv_quant as TQ
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import sampler as TS
from test_torch_serving import (MIXED, _requests, port_params, run_port,
                                run_ref)

ARCH = "smollm-135m"
LOGIT_TOL = 1e-4
PAGED = dict(paged=True, page_size=8)
INT8_TOKEN = dict(paged=True, page_size=8, kv_dtype="int8",
                  scale_granularity="token")
SPEC_LAYOUTS = {"dense": {}, "paged": PAGED, "int8-token": INT8_TOKEN}


# ---------------------------------------------------------------------------
# spec_accept
# ---------------------------------------------------------------------------

# the reference's rule as its engine runs it, compiled
_JACCEPT = jax.jit(JS.spec_accept, static_argnames=("eos",))


def _accept_both(draft, verify, eos, budget=None, room=None, live=None):
    draft, verify = np.asarray(draft), np.asarray(verify)
    B = draft.shape[0]
    budget = np.full(B, 100) if budget is None else np.asarray(budget)
    room = np.full(B, 100) if room is None else np.asarray(room)
    live = np.ones(B, bool) if live is None else np.asarray(live, bool)
    jn, jd = _JACCEPT(jnp.asarray(draft, jnp.int32),
                      jnp.asarray(verify, jnp.int32), eos=eos,
                      budget=jnp.asarray(budget, jnp.int32),
                      room=jnp.asarray(room, jnp.int32),
                      live=jnp.asarray(live))
    tn, td = TS.spec_accept(torch.as_tensor(draft), torch.as_tensor(verify),
                            eos=eos, budget=torch.as_tensor(budget),
                            room=torch.as_tensor(room),
                            live=torch.as_tensor(live))
    assert tn.dtype == torch.int32 and td.dtype == torch.bool
    return (tn.numpy(), td.numpy()), (np.asarray(jn), np.asarray(jd))


EDGES = {
    "full run and bonus": ([[5, 7, 9, 11]], [[7, 9, 11, 13]], {}),
    "first miss stops": ([[5, 7, 8, 11]], [[7, 9, 11, 13]], {}),
    "no resurrection": ([[5, 0, 11, 11]], [[7, 9, 11, 13]], {}),
    "eos inside the run": ([[5, 7, -1, 11]], [[7, -1, 11, 13]], {}),
    "budget cap": ([[5, 7, 9, 11]], [[7, 9, 11, 13]], dict(budget=[2])),
    "room cap": ([[5, 7, 9, 11]], [[7, 9, 11, 13]], dict(room=[3])),
    "dead slot": ([[5, 7, 9, 11]], [[7, 9, 11, 13]], dict(live=[False])),
    "K = 1": ([[5]], [[9]], {}),
    "spent budget": ([[5, 7]], [[7, 9]], dict(budget=[0])),
    "mixed batch": ([[5, 7, 9], [5, 0, 0], [5, 7, 9]],
                    [[7, 9, 11], [7, 9, 11], [7, -1, 11]],
                    dict(live=[True, False, True], room=[3, 1, 2])),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_spec_accept_edge_batches_match_reference(case):
    draft, verify, kw = EDGES[case]
    (tn, td), (jn, jd) = _accept_both(draft, verify, -1, **kw)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(td, jd)


def test_spec_accept_random_batches_match_reference():
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.settings(max_examples=30, deadline=None)
    @hyp.given(st.integers(1, 6), st.integers(1, 4), st.data())
    def inner(K, B, data):
        toks = st.lists(st.lists(st.integers(0, 3), min_size=K, max_size=K),
                        min_size=B, max_size=B)
        ints = st.lists(st.integers(-1, K + 2), min_size=B, max_size=B)
        draft, verify = data.draw(toks), data.draw(toks)
        budget, room = data.draw(ints), data.draw(ints)
        live = data.draw(st.lists(st.booleans(), min_size=B, max_size=B))
        (tn, td), (jn, jd) = _accept_both(draft, verify, 0, budget, room,
                                          live)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(td, jd)

    inner()


# ---------------------------------------------------------------------------
# fake_quantize_tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_fake_quantize_tree_matches_reference(kind):
    jcfg, jparams = reduced_params(ARCH)
    tcfg = get_config(ARCH).reduced()
    tmpl = TM.model_template(tcfg)
    want = TP.from_jax(tmpl, jax.tree.map(
        np.asarray, JQ.fake_quantize_tree(jparams, kind)), device="cpu")
    got = TQ.fake_quantize_tree(
        TP.from_jax(tmpl, jax.tree.map(np.asarray, jparams), device="cpu"),
        kind)
    changed = 0
    for path, t in TP.leaves(want):
        g = dict(TP.leaves(got))[path]
        assert g.dtype == t.dtype and torch.equal(g, t), path
        changed += g.dim() >= 2
    assert changed and TQ.fake_quantize_tree(got, "bf16") is got
    # bf16 weights keep their type; the fp8 clamp at +-448 is no-op under
    # an amax scale, also where the quotient rounds past 448
    w = torch.tensor([[448.0, -3.0], [1e-3, 2.0]]).bfloat16()
    q = TQ.fake_quantize_tree({"w": w}, "fp8")["w"]
    assert q.dtype == torch.bfloat16 and float(q[0, 0]) == 448.0
    assert float(TQ.encode(torch.tensor(470.0), torch.tensor(1.0),
                           torch.float8_e4m3fn).float()) == 448.0


# ---------------------------------------------------------------------------
# draft_step and verify_chunk
# ---------------------------------------------------------------------------

def _caches(paged: bool, seed: int = 5):
    """The same randomly filled caches of reduced smollm in both
    frameworks: dense [3, 48] rows, or a pool of 19 pages of 8."""
    jcfg, _ = reduced_params(ARCH)
    tcfg = get_config(ARCH).reduced()
    kw = dict(paged=True, num_pages=19, page_size=8) if paged else {}
    jc = JM.init_caches(jcfg, 3, 48, jnp.float32, JL.ModelOptions(), **kw)
    tc = TM.init_caches(tcfg, 3, 48, torch.float32, device="cpu", **kw)
    flat, treedef = jax.tree_util.tree_flatten_with_path(jc)
    rng = np.random.default_rng(seed)
    filled = []
    for path, leaf in flat:
        vals = rng.standard_normal(leaf.shape, dtype=np.float32)
        filled.append(jnp.asarray(vals))
        TP.set_leaf(tc, "/".join(p.key for p in path),
                    torch.from_numpy(vals.copy()))
    return jax.tree_util.tree_unflatten(treedef, filled), tc


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want)
    assert (err <= LOGIT_TOL * np.maximum(1, np.abs(want))).all(), \
        f"{what}: max err {err.max()}"


def _assert_caches_close(jc, tc):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        key = "/".join(p.key for p in path)
        _close(dict(TP.leaves(tc))[key], leaf, key)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_draft_and_verify_match_reference(paged):
    """Three slots from their own starts: a live one, one whose rows run
    past the cache (n_valid cuts them) and a dead one (n_valid 0)."""
    jcfg, jparams = reduced_params(ARCH)
    tcfg, tparams = port_params(ARCH)
    opts, jopts = TL.ModelOptions(), JL.ModelOptions(remat=False)
    table = np.arange(1, 19, dtype=np.int32).reshape(3, 6) if paged \
        else None
    jpt = None if table is None else jnp.asarray(table)
    tpt = None if table is None else torch.from_numpy(table)
    rng = np.random.default_rng(9)
    jc, tc = _caches(paged)
    # draft: one token a slot; slot 2 sits past the cache, masked
    tok = rng.integers(0, tcfg.vocab_size, (3, 1))
    idx, nv = np.array([5, 47, 48]), np.array([1, 1, 0])
    jl, jc = JM.draft_step(jcfg, jopts, jparams, jnp.asarray(tok, jnp.int32),
                           jc, jnp.asarray(idx, jnp.int32), 2,
                           page_table=jpt, n_valid=jnp.asarray(nv, jnp.int32))
    tl, tc = TM.draft_step(tcfg, opts, tparams, torch.from_numpy(tok), tc,
                           torch.from_numpy(idx).int(), 2, tpt,
                           n_valid=torch.from_numpy(nv).int(), device="cpu")
    _close(tl, jl, "draft logits")
    _assert_caches_close(jc, tc)
    # verify: K = 4 rows from per-slot starts
    toks = rng.integers(0, tcfg.vocab_size, (3, 4))
    idx, nv = np.array([5, 45, 9]), np.array([4, 3, 0])
    jl, jc = JM.verify_chunk(jcfg, jopts, jparams,
                             jnp.asarray(toks, jnp.int32), jc,
                             jnp.asarray(idx, jnp.int32),
                             n_valid=jnp.asarray(nv, jnp.int32),
                             page_table=jpt, live_len=48)
    args = (tcfg, opts, tparams, torch.from_numpy(toks))
    kw = dict(n_valid=torch.from_numpy(nv).int(), page_table=tpt,
              device="cpu")
    whole, tc = TM.verify_chunk(*args, tc, torch.from_numpy(idx).int(), **kw)
    assert whole.shape == (3, 4, tcfg.vocab_size)
    # a row past the cache (slot 1's last) has logits nothing reads
    inside = torch.from_numpy(idx[:, None] + np.arange(4) < 48)
    _close(whole[inside], np.asarray(jl)[inside.numpy()], "verify logits")
    _assert_caches_close(jc, tc)
    # from starts whose live band (rows up to 16, one band of 32) is
    # shorter than the view: the band gives the same bits as the whole view
    start, kw["n_valid"] = torch.tensor([5, 13, 9]).int(), \
        torch.tensor([4, 4, 0]).int()
    outs = []
    for live in (None, 32):
        _, fresh = _caches(paged)
        outs.append(TM.verify_chunk(*args, fresh, start, live_len=live,
                                    **kw)[0])
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the spec engine
# ---------------------------------------------------------------------------

_REF, _FUSED = {}, {}
# (layout, spec_k, draft_layers, draft_quant): the reference spec engines
REF_CASES = {"dense-k4": ("dense", 4, None, None),
             "paged-k2": ("paged", 2, 4, "int8"),
             "int8-token-k8": ("int8-token", 8, 4, "int8")}


def _reqs():
    return _requests(get_config(ARCH).reduced(), 3, MIXED)


def _spec_kw(layout, K, draft_layers=4, draft_quant="int8"):
    return dict(SPEC_LAYOUTS[layout], spec_decode=True, spec_k=K,
                draft_layers=draft_layers, draft_quant=draft_quant)


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_spec_engine_matches_reference(case):
    layout, K, dl, dq = REF_CASES[case]
    if case not in _REF:
        _REF[case] = run_ref(ARCH, _reqs(), **_spec_kw(layout, K, dl, dq))
    (rt, re) = _REF[case]
    pt, pe = run_port(ARCH, _reqs(), **_spec_kw(layout, K, dl, dq))
    assert pt == rt
    for f in ("spec_accept_hist", "spec_verify_passes", "spec_draft_steps",
              "device_steps", "ticks", "tokens_decoded", "pages_hwm",
              "spec_key_lanes", "spec_key_lanes_full"):
        assert getattr(pe.stats, f) == getattr(re.stats, f), f
    rep, want = pe.stats.phase_report(), re.stats.phase_report()
    for k in ("spec_accept_per_pass", "spec_draft_frac",
              "spec_key_lane_ratio"):
        assert rep[k] == pytest.approx(want[k], rel=1e-12), k
    assert pe.stats.decode_syncs >= re.stats.decode_syncs
    assert pe.stats.pages_in_use == 0


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "runner"])
@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("layout", sorted(SPEC_LAYOUTS))
def test_spec_streams_equal_fused_streams(layout, K, graphs):
    """The full-depth int8 draft (high acceptance: bonus and rejection
    edges fire) against the port's plain fused engine on the same
    layout."""
    if layout not in _FUSED:
        _FUSED[layout] = run_port(ARCH, _reqs(), **SPEC_LAYOUTS[layout])[0]
    got, eng = run_port(ARCH, _reqs(), graphs=graphs,
                        **_spec_kw(layout, K))
    assert got == _FUSED[layout]
    rep = eng.stats.phase_report()
    assert sum(rep["spec_accept_hist"][1:]) == eng.stats.spec_verify_passes
    assert sum(n * c for n, c in enumerate(rep["spec_accept_hist"])) == \
        sum(map(len, got.values())) - len(got)
    assert rep["spec_accept_per_pass"] >= 1.0
    # each readback is a sync; rounds after go fell are masked steps
    assert eng.stats.decode_syncs >= eng.stats.ticks
    assert eng.masked_steps >= 0 and eng.stats.pages_in_use == 0


def test_spec_ctor_refusals_and_defaults():
    cfg, params = port_params(ARCH)
    base = dict(n_slots=2, max_seq=32, eos=-1, device="cpu",
                spec_decode=True)
    for kw, match in ((dict(temperature=0.7), "greedy"),
                      (dict(fused=False), "fused"),
                      (dict(spec_k=0), "spec_k"),
                      (dict(draft_layers=99), "draft_layers"),
                      (dict(draft_layers=0), "draft_layers"),
                      (dict(draft_quant="int4"), "draft_quant"),
                      (dict(paged=True, page_size=8, kv_dtype="int8",
                            scale_granularity="head"),
                       "scale_granularity")):
        with pytest.raises(ValueError, match=match):
            ServingEngine(cfg, TL.ModelOptions(), params, **base, **kw)
    mcfg = get_config("mamba2-780m").reduced()
    mparams = TM.init_params(mcfg, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(ValueError, match="attention-only"):
        ServingEngine(mcfg, TL.ModelOptions(), mparams, **base)
    eng = ServingEngine(cfg, TL.ModelOptions(), params, paged=True,
                        page_size=8, kv_dtype="int8", **base)
    assert eng.scale_granularity == "token"
    assert (eng.draft_layers, eng.draft_params) == (2, params)
    plain = ServingEngine(cfg, TL.ModelOptions(), params, n_slots=2,
                          max_seq=32, paged=True, page_size=8,
                          kv_dtype="int8", device="cpu")
    assert plain.scale_granularity == "head"


def test_spec_cancel_between_rounds_drains_the_pool():
    """A request cancelled mid-decode between speculative ticks returns
    its pages; the survivor's stream equals its solo stream."""
    cfg, params = port_params(ARCH)
    rng = np.random.default_rng(11)
    p0 = rng.integers(0, cfg.vocab_size, 12, dtype=np.int32)
    p1 = rng.integers(0, cfg.vocab_size, 9, dtype=np.int32)

    def make():
        return ServingEngine(cfg, TL.ModelOptions(), params, n_slots=2,
                             max_seq=64, eos=-999, tick_tokens=4,
                             device="cpu", **_spec_kw("int8-token", 4, 1,
                                                      None))
    solo = make()
    solo.submit(Request(uid=1, prompt=p1.copy(), max_tokens=20))
    want = solo.run()[0].out_tokens
    eng = make()
    req0 = Request(uid=0, prompt=p0.copy(), max_tokens=24)
    eng.submit(req0)
    eng.submit(Request(uid=1, prompt=p1.copy(), max_tokens=20))
    for _ in range(3):
        eng.step_fused()
    assert eng.stats.spec_verify_passes > 0 and all(eng.slots)
    assert eng.cancel(0) and req0.cancelled and not req0.done
    done = eng.run()
    assert [r.uid for r in done] == [1] and done[0].out_tokens == want
    assert eng.stats.pages_in_use == 0 and eng.pool.pages_in_use == 0


# ---------------------------------------------------------------------------
# a decode write past a full cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense", "paged", "moe-dense",
                                  "moe-paged"])
def test_write_past_a_full_cache_matches_reference(case):
    """Reduced smollm (granite-moe at capacity factor 0.5 for MoE, where
    a finished row's hidden state competes with the live rows): 2 slots,
    max_seq 16, 4-token ticks, prompts of 10 and 3 tokens asking for 20
    and 12; the first request's budget is clamped to the cache, so its
    index reaches 16 and later steps (masked steps of its tick, every
    step after it retires) write past the cache."""
    name = "granite-moe-3b-a800m" if case.startswith("moe") else ARCH
    kw = PAGED if case.endswith("paged") else {}
    opts = dict(moe_capacity_factor=0.5) if case.startswith("moe") else None
    cfg, _ = port_params(name)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, 10, dtype=np.int32), 20, None),
            (rng.integers(0, cfg.vocab_size, 3, dtype=np.int32), 12, None)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)    # the clamp
        got, eng = run_port(name, reqs, max_seq=16, opts=opts, **kw)
        want, _ = run_ref(name, reqs, max_seq=16, opts=opts, **kw)
    assert got == want
    assert len(got[0]) == 16 - 10 + 1 and eng.masked_steps > 0


@pytest.mark.parametrize("policy", ["f32", "int8-head", "int8-token"])
def test_paged_write_past_the_table_is_dropped_as_reference(policy):
    """A slot at index npg * ps (its table live, or all null page after it
    retired) writes nothing in either framework; a ``valid``-masked row
    sends zeros to the null page."""
    P, ps, K, h = 6, 4, 2, 16
    table = np.array([[1, 2], [0, 0], [3, 4]], np.int32)
    idx = np.array([8, 8, 5], np.int32)
    kind, _, gran = policy.partition("-")
    rng = np.random.default_rng(3)
    new = rng.standard_normal((3, 1, K, h), dtype=np.float32)
    pages = rng.standard_normal((P, ps, K, h), dtype=np.float32)
    if kind == "int8":
        sshape = (P, ps, K) if gran == "token" else (P, K)
        scales = np.abs(rng.standard_normal(sshape, dtype=np.float32))
        pages = np.clip(np.round(pages * 40), -127, 127).astype(np.int8)
    for valid in (None, np.array([True, True, False])):
        jp, jsc = JL.update_cache_paged(
            jnp.asarray(pages), jnp.asarray(new), jnp.asarray(table),
            jnp.asarray(idx), None if kind == "f32" else jnp.asarray(scales),
            valid=None if valid is None else jnp.asarray(valid))
        tp = torch.from_numpy(pages.copy())
        tsc = None if kind == "f32" else torch.from_numpy(scales.copy())
        tp, tsc = TL.update_cache_paged(
            tp, torch.from_numpy(new), torch.from_numpy(table),
            torch.from_numpy(idx), tsc,
            None if valid is None else torch.from_numpy(valid))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        if kind != "f32":
            np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc),
                                       rtol=1e-7, atol=0)
        # pages 1 and 2 (slot 0's, past its last position) unchanged
        np.testing.assert_array_equal(tp[1:3].numpy(), pages[1:3])
