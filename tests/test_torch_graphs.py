"""The port's graphed decode (``models.graphs.StepGraph`` under
``model.DecodeGraph`` and the engine's ``DecodeTick``) against the JAX
reference, on the CPU, where the runner runs the captured step eagerly on
the same static buffers that a graph replays on the card.

- ``decode_loop`` through a ``DecodeGraph`` shared by two loops (the
  control step's CoT and action loops) gives the reference's
  ``M.decode_loop`` tokens on reduced molmoact-7b and the tokens of the
  port's eager loop over ``decode_step``, bit for bit.
- The engines' greedy streams and counters equal the reference engine's
  (dense, paged, int8-head, fp8-token, chunked with a tick depth that
  changes from tick to tick, reduced granite-moe and mamba2), and the key
  of the tick's captured step is the same for every tick of an engine's
  life, so the card captures it once.
- Every cache leaf keeps its storage (``data_ptr``) through a decode step
  and through a tick, in every layout: a leaf that a step rebound would
  leave a graph writing into a stale buffer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.models import model as JM
from repro.models.layers import ModelOptions as JOptions
from repro_torch.configs import get_config
from repro_torch.core import vla as tvla
from repro_torch.models import model as TM
from repro_torch.models.graphs import StepGraph, tensor_key
from repro_torch.models.layers import ModelOptions
from repro_torch.models.params import from_jax, leaves, set_leaf
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import engine as TE
from test_torch_chunked import assert_same_chunked_run
from test_torch_serving import (LAYOUTS, _requests, assert_same_run,
                                port_params, run_port, run_ref)

GRANITE, MAMBA = "granite-moe-3b-a800m", "mamba2-780m"


def test_step_graph_runs_the_body_on_the_cpu():
    """On the CPU a step is the body, run as it is on its buffers; the key
    follows each tensor's address and layout."""
    x = torch.zeros(3)
    runner = StepGraph(lambda: x.add_(1), "cpu")
    assert runner.eager
    for key in ("a", "a", "b"):
        runner.step(key)
    assert torch.equal(x, torch.full((3,), 3.0)) and runner.graph is None
    y = x.clone()
    assert tensor_key(x) == tensor_key(x) != tensor_key(y)
    assert tensor_key(x) != tensor_key(x[:2])
    assert tensor_key({"a": x}, 7) == tensor_key({"a": x}, 7)


def test_decode_loop_through_the_runner_matches_reference():
    """Prefill, then 5 CoT and 4 action tokens through one DecodeGraph
    (the second loop reuses its buffers) against the reference's two
    ``decode_loop`` calls and against the port's eager loop: tokens
    equal."""
    jcfg, jparams = reduced_params("molmoact-7b")
    tcfg = get_config("molmoact-7b").reduced()
    tparams = from_jax(TM.model_template(tcfg),
                       jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (2, 6)),
             "patches": rng.standard_normal(
                 (2, tcfg.vision.num_tokens, tcfg.vision.embed_dim),
                 dtype=np.float32)}
    prompt = tcfg.vision.num_tokens + 6
    max_seq = prompt + 5 + 4 + 1
    jl, jc = JM.prefill(jcfg, JOptions(remat=False), jparams,
                        {k: jnp.asarray(v) for k, v in batch.items()},
                        max_seq)
    tl, tc = TM.prefill(tcfg, ModelOptions(), tparams, batch, max_seq,
                        device="cpu")
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    tok = tl[:, -1].argmax(-1, keepdim=True)
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    jcot, jtok, jc = JM.decode_loop(jcfg, JOptions(remat=False), jparams,
                                    jtok, jc, prompt, 5)
    jact, _, _ = JM.decode_loop(jcfg, JOptions(remat=False), jparams, jtok,
                                jc, prompt + 5, 4)

    eager_caches = {p: t.clone() for p, t in leaves(tc)}
    graph = TM.DecodeGraph("cpu")
    cot, last, tc = TM.decode_loop(tcfg, ModelOptions(), tparams, tok, tc,
                                   prompt, 5, device="cpu", graph=graph)
    act, _, _ = tvla.decode_tokens(tcfg, ModelOptions(), tparams, last, tc,
                                   prompt + 5, 4, device="cpu", graph=graph)
    assert np.array_equal(cot.numpy(), np.asarray(jcot))
    assert np.array_equal(act.numpy(), np.asarray(jact))

    tree = {}
    for p, t in eager_caches.items():
        set_leaf(tree, p, t)
    eager, tok_e = [], tok
    for i in range(9):
        logits, _ = TM.decode_step(tcfg, ModelOptions(), tparams, tok_e,
                                   tree, prompt + i, device="cpu")
        tok_e = logits[:, -1].argmax(-1, keepdim=True)
        eager.append(tok_e[:, 0])
    assert torch.equal(torch.cat([cot, act], 1), torch.stack(eager, 1))
    for p, t in leaves(tc):
        assert torch.equal(t, dict(leaves(tree))[p]), p


SHORT = [(5, 6), (5, 3), (5, 5)]      # 3 requests on 2 slots: a refill
ENGINE_CASES = {
    "dense": ("qwen1.5-0.5b", {}),
    "paged": ("qwen1.5-0.5b", LAYOUTS["paged-bf16"]),
    "int8-head": ("qwen1.5-0.5b", LAYOUTS["int8-head"]),
    "fp8-token": ("qwen1.5-0.5b", LAYOUTS["fp8-token"]),
    "chunked": ("smollm-135m", dict(LAYOUTS["paged-bf16"],
                                    chunked_prefill=True, chunk_size=8,
                                    token_budget=6)),
    "granite-moe": (GRANITE, dict(opts=dict(moe_capacity_factor=0.5))),
    "mamba2": (MAMBA, {}),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_streams_through_the_runner_match_reference(case,
                                                           monkeypatch):
    """Greedy streams and counters equal the reference engine's; every
    tick's step key is the first tick's (one capture on the card); the
    chunked engine's planner changes the tick depth between ticks, which
    the one captured step serves by replaying it that many times."""
    name, kw = ENGINE_CASES[case]
    cfg, _ = port_params(name)
    reqs = _requests(cfg, 3, [(19, 4)] + SHORT if case == "chunked"
                     else SHORT)
    keys, caps = [], []
    run = TE.DecodeTick.run

    def recording(self, cap):
        keys.append(self.key())
        caps.append(cap)
        return run(self, cap)
    monkeypatch.setattr(TE.DecodeTick, "run", recording)
    port = run_port(name, reqs, **kw)
    assert port[1]._tick.graph.eager
    assert keys and all(k == keys[0] for k in keys)
    assert keys[0] == port[1]._tick.key()
    assert sum(caps) == (port[1].stats.device_steps
                         + port[1].masked_steps)
    ref = run_ref(name, reqs, **kw)
    if case == "chunked":
        assert len(set(caps)) > 1
        assert_same_chunked_run(port, ref)
    else:
        assert_same_run(port, ref)


STORAGE_CASES = {**{k: ("qwen1.5-0.5b", v) for k, v in LAYOUTS.items()},
                 "granite-moe": (GRANITE, {}),
                 "mamba2-dense": (MAMBA, {}),
                 "mamba2-paged": (MAMBA, LAYOUTS["paged-bf16"]),
                 "gemma3-ring": ("gemma3-27b", {})}


@pytest.mark.parametrize("case", sorted(STORAGE_CASES))
def test_cache_leaves_keep_their_storage(case):
    """An engine's cache leaves (K/V, pages, scales, Mamba states, the
    ring caches of gemma3's local layers) keep their storage through
    admission and a tick, and through one more ``decode_step`` over the
    same caches."""
    name, kw = STORAGE_CASES[case]
    cfg, params = port_params(name)
    opts = ModelOptions(window_cache=case.endswith("ring"))
    eng = ServingEngine(cfg, opts, params, n_slots=2, max_seq=32,
                        eos=-999, tick_tokens=3, device="cpu", **kw)
    ptrs = {p: t.data_ptr() for p, t in leaves(eng.caches)}
    for i, (prompt, m, _) in enumerate(_requests(cfg, 5, [(5, 6), (3, 6)])):
        eng.submit(Request(uid=i, prompt=prompt, max_tokens=m))
    assert eng.step_fused() > 0
    assert {p: t.data_ptr() for p, t in leaves(eng.caches)} == ptrs
    tick = eng._tick
    TM.decode_step(cfg, opts, params, tick.tokens, eng.caches,
                   tick.index, tick.page_table, device="cpu")
    assert {p: t.data_ptr() for p, t in leaves(eng.caches)} == ptrs


# ---------------------------------------------------------------------------
# the guarded tick (StepGraph(guard=)), prefill graphs, staging caches
# ---------------------------------------------------------------------------

def _tick_state(tick, skip=()):
    """Every buffer of a tick but those named in ``skip``, cloned."""
    return {k: v.clone() for k, v in vars(tick).items()
            if isinstance(v, torch.Tensor) and k not in skip}


def _null_and_states(eng):
    """Each pool leaf's null page and each Mamba2 state, cloned."""
    out = {}
    for path, leaf in leaves(eng.caches):
        if path.split("/")[-1] in ("k", "v", "k_scale", "v_scale") \
                and eng.paged:
            axis = 1 if leaf.dim() > 4 or (
                path.endswith("_scale") and leaf.dim() > 2
                and "blocks" in path) else 0
            out[path] = leaf.select(TE.cache_batch_axis(path), 0).clone()
        elif path.split("/")[-1] in ("ssm", "conv"):
            out[path] = leaf.clone()
    return out


GUARD_OFF_CASES = {
    "decode-int8-head": ("qwen1.5-0.5b", LAYOUTS["int8-head"]),
    "decode-mamba2": (MAMBA, {}),
    "spec-paged": ("smollm-135m", dict(LAYOUTS["paged-bf16"],
                                       spec_decode=True, spec_k=4,
                                       draft_quant="int8")),
}


@pytest.mark.parametrize("case", sorted(GUARD_OFF_CASES))
def test_a_tick_body_with_its_guard_false_changes_nothing_read(case):
    """The rule the IF guard depends on: a tick's body run with ``go``
    false (one slot newly finished beside a live one) leaves every value
    the tick reads back, the null page and every recurrent state bit for
    bit as it found them. The exceptions are buffers the host never reads:
    ``DecodeTick``'s step counter, ``SpecTick``'s drop column of ``out``
    and drop bucket of ``hist``."""
    name, kw = GUARD_OFF_CASES[case]
    cfg, params = port_params(name)
    eng = ServingEngine(cfg, ModelOptions(), params, n_slots=2, max_seq=48,
                        eos=-999, tick_tokens=4, device="cpu", **kw)
    for i, (p, m, _) in enumerate(_requests(cfg, 7, [(6, 20), (5, 20)])):
        eng.submit(Request(uid=i, prompt=p, max_tokens=m))
    eng.step_fused()                # both slots admitted and decoding
    tick = eng._tick
    pt = eng._decode_page_table() if eng.paged else None
    done = np.zeros(2, bool)
    if eng.spec_decode:
        tick.load(eng.tokens, eng.index, eng.budget, done, 4, pt)
    else:
        tick.load(eng.tokens, eng.index, eng.budget, done, eng.keys, pt)
    tick.graph.body()               # a live step: the carry moves
    assert bool(tick.go())
    tick.done[0] = True             # slot 0 newly finished: go falls
    assert not bool(tick.go())
    skip = ("counter",) if hasattr(tick, "counter") else ()
    before = _tick_state(tick, skip)
    pages = _null_and_states(eng)
    tick.graph.body()
    after = _tick_state(tick, skip)
    if eng.spec_decode:
        T, K = tick.T, tick.K
        for state in (before, after):
            state["out"] = state["out"][:, :T]
            state["hist"] = state["hist"][:K + 1]
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    for k, v in _null_and_states(eng).items():
        assert torch.equal(pages[k], v), k
    assert pages or not eng.paged


def _host_guarded(monkeypatch):
    """Make every guarded runner behave as it does on the card, where its
    graph's IF node skips the body whose guard is false: the guard read on
    the host, and ``guarded`` set, so the speculative tick takes the
    card's one-readback path."""
    from repro_torch.models.graphs import StepGraph
    init, step = StepGraph.__init__, StepGraph.step

    def guarded_init(self, *a, **k):
        init(self, *a, **k)
        self.guarded = self.guard is not None

    def guarded_step(self, key=None):
        if self.guard is not None and not bool(self.guard()):
            return
        step(self, key)
    monkeypatch.setattr(StepGraph, "__init__", guarded_init)
    monkeypatch.setattr(StepGraph, "step", guarded_step)


SKIP_CASES = {
    "dense": ("qwen1.5-0.5b", {}),
    "paged-int8": ("qwen1.5-0.5b", LAYOUTS["int8-head"]),
    "spec": ("smollm-135m", dict(spec_decode=True, spec_k=4,
                                 draft_layers=4, draft_quant="int8")),
}


@pytest.mark.parametrize("case", sorted(SKIP_CASES))
def test_a_tick_that_skips_guarded_off_steps_matches(case, monkeypatch):
    """A tick that runs its body only while its guard holds (the guard
    read here, as the card's IF node reads it) gives the masked tick's
    streams and the reference engine's, and the same steps and masked
    steps; the speculative tick then reads its carry back once a tick, as
    the reference does."""
    name, kw = SKIP_CASES[case]
    reqs = _requests(port_params(name)[0], 3, [(5, 9), (5, 3), (5, 6),
                                               (4, 7)])
    masked = run_port(name, reqs, **kw)
    ref = run_ref(name, reqs, **kw)
    _host_guarded(monkeypatch)
    skipped = run_port(name, reqs, **kw)
    assert skipped[0] == masked[0] == ref[0]
    st, rs = skipped[1].stats, ref[1].stats
    for f in ("device_steps", "ticks", "tokens_decoded"):
        assert getattr(st, f) == getattr(rs, f), f
    assert skipped[1]._tick.graph.replays_ran == 0      # nothing captured
    if skipped[1].spec_decode:
        assert st.decode_syncs == st.ticks == rs.decode_syncs
        assert st.spec_accept_hist == rs.spec_accept_hist
        assert masked[1].stats.decode_syncs >= st.decode_syncs
    else:
        assert st.decode_syncs == rs.decode_syncs
        assert skipped[1].masked_steps == masked[1].masked_steps > 0


def test_prefill_graph_keeps_its_caches_and_matches_prefill():
    """A ``PrefillGraph`` (vision + prefill as one body) returns its caches
    at the same addresses on two calls of other prompt lengths, with
    ``M.prefill``'s logits and caches bit for bit and the reference's
    logits within the port's fp32 tolerance (f32 caches on both sides); a
    ``VisionGraph``'s prefix is ``encode_vision``'s."""
    jcfg, jparams = reduced_params("molmoact-7b")
    tcfg = get_config("molmoact-7b").reduced()
    tparams = from_jax(TM.model_template(tcfg),
                       jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(9)
    graph = TM.PrefillGraph("cpu")
    ptrs = None
    for n in (6, 9):
        batch = {"tokens": rng.integers(0, tcfg.vocab_size, (2, n)),
                 "patches": rng.standard_normal(
                     (2, tcfg.vision.num_tokens, tcfg.vision.embed_dim),
                     dtype=np.float32)}
        max_seq = tcfg.vision.num_tokens + 16
        logits, caches = graph.run(tcfg, ModelOptions(), tparams, batch,
                                   max_seq, torch.float32)
        got = {p: t.data_ptr() for p, t in leaves(caches)}
        assert ptrs is None or got == ptrs
        ptrs = got
        want, want_c = TM.prefill(tcfg, ModelOptions(), tparams, batch,
                                  max_seq, torch.float32, device="cpu")
        assert torch.equal(logits, want)
        for p, t in leaves(want_c):
            assert torch.equal(dict(leaves(caches))[p], t), p
        jl, _ = JM.prefill(jcfg, JOptions(remat=False), jparams,
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           max_seq, jnp.float32)
        np.testing.assert_allclose(logits.float().numpy(),
                                   np.asarray(jl, np.float32),
                                   atol=1e-4, rtol=1e-4)
    vis = TM.VisionGraph("cpu")
    prefix = vis.run(tcfg, ModelOptions(), tparams, batch["patches"])
    assert torch.equal(prefix, TM.encode_vision(
        tcfg, ModelOptions(), tparams, batch["patches"], device="cpu"))
    hash(graph.runner.key)


def test_dense_staging_caches_keep_their_storage():
    """A dense chunked engine's batch-1 staging caches, one a slot, keep
    their storage across admissions (zeroed in place for each), so the
    chunk graph's key takes at most one value a slot: the card captures
    at most ``n_slots`` chunk graphs. The engine's streams still equal
    the reference's."""
    name, kw = ENGINE_CASES["chunked"]
    kw = {k: v for k, v in kw.items() if k not in ("paged", "page_size")}
    cfg, _ = port_params(name)
    reqs = _requests(cfg, 5, [(19, 4), (5, 6), (12, 3), (7, 5), (9, 2)])
    keys = set()
    run = TE.ChunkGraph.run

    def recording(self, caches, live):
        keys.add(self.key(caches))
        return run(self, caches, live)
    TE.ChunkGraph.run = recording
    try:
        port = run_port(name, reqs, **kw)
    finally:
        TE.ChunkGraph.run = run
    eng = port[1]
    ptrs = {s: [t.data_ptr() for _, t in leaves(c)]
            for s, c in eng._staging.items()}
    assert len(ptrs) == eng.n_slots and 1 <= len(keys) <= eng.n_slots
    for s, c in eng._staging.items():
        assert [t.data_ptr() for _, t in leaves(c)] == ptrs[s]
    for k in keys:
        hash(k)
    assert_same_chunked_run(port, run_ref(name, reqs, **kw))


# ops that copy a host value to the card or read one back: a body that
# issues one cannot be captured (the CPU has no sync check, so its
# dispatch is watched instead); F.one_hot reads its input's range on the
# CPU only
HOST_OPS = {"aten.lift_fresh.default", "aten._local_scalar_dense.default",
            "aten.nonzero.default", "aten.masked_select.default",
            "aten.equal.default", "aten.is_nonzero.default"}


@pytest.mark.parametrize("case", ["chunked", "int8-head", "granite-moe",
                                  "mamba2"])
def test_graph_bodies_make_no_host_copy(case):
    """Every body an engine captures (the tick, vision, the chunk) and a
    ``PrefillGraph``'s body (the control step's prefill) dispatch no op
    that copies a host value to the device or reads one back, which a
    capture forbids."""
    import traceback
    from torch.utils._python_dispatch import TorchDispatchMode
    name, kw = ENGINE_CASES[case]
    cfg, params = port_params(name)
    opts = ModelOptions(**kw.pop("opts", {})) if "opts" in kw \
        else ModelOptions()
    kw = {k: v for k, v in kw.items() if k != "opts"}
    found = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func) in HOST_OPS:
                stack = "".join(traceback.format_stack(limit=6))
                if "one_hot" not in stack:
                    found.append((str(func), stack))
            return func(*args, **(kwargs or {}))

    eng = ServingEngine(cfg, opts, params, n_slots=2, max_seq=48, eos=-999,
                        tick_tokens=3, device="cpu", **kw)
    prefill = TM.PrefillGraph("cpu")
    for runner in (eng._tick.graph, prefill.runner,
                   eng._chunk.runner if eng._chunk else None,
                   eng._vision.runner if eng._vision else None):
        if runner is not None:
            body = runner.body

            def watched(body=body):
                with Watch():
                    body()
            runner.body = watched
    reqs = _requests(cfg, 2, [(19, 4), (6, 3)])
    for i, (p, m, _) in enumerate(reqs):
        eng.submit(Request(uid=i, prompt=p, max_tokens=m))
    assert len(eng.run()) == 2
    prefill.run(cfg, opts, params, {"tokens": torch.as_tensor(
        reqs[0][0][None, :], dtype=torch.long)}, 48, torch.float32)
    assert not found, found[0]
