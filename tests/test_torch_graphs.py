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
