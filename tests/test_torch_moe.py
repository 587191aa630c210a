"""The port's MoE decoder family against the JAX reference.

Inputs are made with numpy from seeds and handed to both frameworks;
weights of the reduced granite-moe-3b-a800m and arctic-480b come from the
reference through ``from_jax``. Tolerances:

- the grouped-expert plain versions against the reference's Pallas kernels
  (interpret mode) and ``grouped_mlp_ref``: f32 within 1e-4 relative to
  max(1, |ref|) (two chained f32 products of up to 1,536 terms, summed in
  another order, with outputs up to ~25); bf16 within 1e-2 of it, since
  ``h`` is rounded to bf16 in both, and a sum that lands on the other side
  of a rounding boundary moves one h element by an ulp (2**-8 relative);
  against the einsum oracle, which rounds more often in bf16, 5e-2;
- ``layers.moe`` within 1e-5 (f32; the routing and the capacity slots must
  be the same, or whole rows would differ);
- model logits within 1e-4, as in ``test_torch_model.py`` (bf16 caches);
- greedy streams and the engines' counters equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.configs import get_config as jget_config
from repro.kernels.moe_gmm import moe_gmm as jgmm
from repro.kernels.moe_gmm import ops as jops
from repro.kernels.moe_gmm import ref as jref
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.kernels.moe_gmm import ops as tgmm
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from test_torch_chunked import assert_same_chunked_run
from test_torch_serving import (LAYOUTS, _requests, assert_same_run,
                                port_params, run_port, run_ref)

MOE_ARCHS = ["granite-moe-3b-a800m", "arctic-480b"]
GRANITE = "granite-moe-3b-a800m"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _rand(rng, *shape, scale=0.3):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, rel):
    """|got - want| <= rel * max(1, |want|) everywhere (f32 compare)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= rel, err.max()


def _jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# the grouped-expert kernels' plain versions
# ---------------------------------------------------------------------------

# the reference's test_kernels.py cases, ragged capacities, granite's
# decode at 8 slots (E=40, C=2, D=1536, F=512), and the edges of the
# card's bf16 gmm_down tiles: C=33 (off its 32-row slices), F=520 and
# D=1544 (multiples of 8, not of its 64-deep stage or 128-column tile)
GMM_CASES = [(4, 128, 256, 512, "silu"), (8, 64, 128, 96, "gelu"),
             (2, 256, 64, 128, "gelu_plain"), (16, 32, 64, 64, "silu"),
             (4, 3, 64, 48, "silu"), (4, 5, 64, 48, "gelu_plain"),
             (40, 2, 1536, 512, "silu"), (4, 33, 64, 520, "silu"),
             (2, 33, 1544, 64, "gelu")]
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-2)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("E,C,D,F,act", GMM_CASES,
                         ids=lambda v: str(v))
def test_gmm_plain_matches_pallas_kernels(E, C, D, F, act, dtype):
    """Each kernel's plain version alone and the pair, on the same inputs,
    against the Pallas kernels in interpret mode; granite's full-width
    decode case (too slow for interpret mode here) against the einsum
    oracle only."""
    jdt, tdt, rel = DTYPES[dtype]
    rng = np.random.default_rng(E * 1000 + C)
    xe = _rand(rng, E, C, D, scale=1.0)
    wi, wg = _rand(rng, E, D, F, scale=D ** -0.5), _rand(rng, E, D, F,
                                                          scale=D ** -0.5)
    wo = _rand(rng, E, F, D, scale=F ** -0.5)
    jx, jwi, jwg, jwo = (_jax(a, jdt) for a in (xe, wi, wg, wo))
    tx, twi, twg, two = (_torch(a, tdt) for a in (xe, wi, wg, wo))
    got = tgmm.grouped_mlp(tx, twi, twg, two, act)
    assert got.dtype == tdt and tuple(got.shape) == (E, C, D)
    if E * D * F <= 10 ** 6:
        jh = jgmm.gmm_gated(jx, jwi, jwg, act=act, interpret=True)
        th = tgmm.gmm_gated(tx, twi, twg, act=act)
        assert th.dtype == tdt and tuple(th.shape) == (E, C, F)
        _close(th.float(), jh.astype(jnp.float32), rel)
        jy = jgmm.gmm_down(jh, jwo, interpret=True)
        ty = tgmm.gmm_down(_torch(jh.astype(jnp.float32), tdt), two)
        _close(ty.float(), jy.astype(jnp.float32), rel)
        _close(got.float(), jops.grouped_mlp(jx, jwi, jwg, jwo, act,
                                             interpret=True)
               .astype(jnp.float32), rel)
    # the einsum oracle rounds x@wi and x@wg to bf16 and runs the
    # activation in bf16: in bf16 it is held within 5e-2, as the
    # reference's own kernel test holds the Pallas pair to it
    _close(got.float(), jref.grouped_mlp_ref(jx, jwi, jwg, jwo, act)
           .astype(jnp.float32), rel if dtype == "f32" else 5e-2)
    assert torch.equal(got, tgmm.grouped_mlp_ref(tx, twi, twg, two, act))
    assert tgmm.gmm_gated.launches == tgmm.gmm_down.launches == 0


def test_gmm_wrappers_check_their_operands():
    x = torch.zeros(2, 3, 8)
    w = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="act"):
        tgmm.gmm_gated(x, w, w, act="relu")
    with pytest.raises(ValueError, match="do not match"):
        tgmm.gmm_gated(x, w, torch.zeros(2, 8, 8))
    with pytest.raises(TypeError, match="one type"):
        tgmm.gmm_down(torch.zeros(2, 3, 16), w.transpose(1, 2).bfloat16())
    # a meta tensor takes the plain version (shapes only, the dry run);
    # a tensor on any device but the CPU, meta or the card raises
    out = tgmm.gmm_down(torch.zeros(2, 3, 16, device="meta"),
                        torch.zeros(2, 16, 8, device="meta"))
    assert out.device.type == "meta" and out.shape == (2, 3, 8)

    class Elsewhere(torch.Tensor):
        @property
        def device(self):
            return torch.device("xla")
    with pytest.raises(ValueError, match="unsupported device"):
        tgmm.gmm_down(
            torch.Tensor._make_subclass(Elsewhere, torch.zeros(2, 3, 16)),
            torch.Tensor._make_subclass(Elsewhere, torch.zeros(2, 16, 8)))


# ---------------------------------------------------------------------------
# layers.moe
# ---------------------------------------------------------------------------

def _moe_inputs(cfg, seed, B=2, S=12, skew=1.0):
    """x [B,S,D] and one MoE layer's leaves (numpy); ``skew`` shifts every
    token toward expert 0's router column, so capacity drops happen."""
    rng = np.random.default_rng(seed)
    D, F = cfg.d_model, cfg.moe_d_ff
    E = max(cfg.num_experts_padded, cfg.num_experts)
    p = {"router": _rand(rng, D, E, scale=D ** -0.5),
         "moe_wi": _rand(rng, E, D, F, scale=D ** -0.5),
         "moe_wg": _rand(rng, E, D, F, scale=D ** -0.5),
         "moe_wo": _rand(rng, E, F, D, scale=F ** -0.5)}
    col = p["router"][:, 0] / np.linalg.norm(p["router"][:, 0])
    x = _rand(rng, B, S, D, scale=1.0) + skew * col
    return x, p


def _drops(cfg, x, p, factor):
    """Assignments the global capacity dispatch drops (port's routing)."""
    xt = torch.as_tensor(x).reshape(-1, x.shape[-1])
    _, idx = TL._route(xt, torch.as_tensor(p["router"]), cfg)
    C = max(1, math.ceil(cfg.top_k * xt.shape[0] / cfg.num_experts * factor))
    counts = torch.bincount(idx.reshape(-1), minlength=p["router"].shape[1])
    return int((counts - C).clamp(min=0).sum())


def _moe_pair(name, x, p, jopts, topts, **cfg_changes):
    """(port, reference) ``moe`` outputs on the same inputs; cfg_changes
    apply to both reduced configs."""
    jcfg = dataclasses.replace(jget_config(name).reduced(), **cfg_changes)
    tcfg = dataclasses.replace(get_config(name).reduced(), **cfg_changes)
    want = JL.moe({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                  jcfg, jopts)
    got = TL.moe({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), tcfg, topts)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("pallas", [False, True], ids=["einsum", "pallas"])
@pytest.mark.parametrize("factor", [1.25, 64.0])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_matches_reference(name, factor, pallas):
    """Global capacity dispatch: at 1.25 expert 0 overflows (drops happen),
    at 64 nothing is dropped; the reference runs its einsums or its Pallas
    kernels in interpret mode."""
    cfg = get_config(name).reduced()
    x, p = _moe_inputs(cfg, 1, skew=2.0)
    drops = _drops(cfg, x, p, factor)
    assert (drops > 0) == (factor == 1.25)
    got, want = _moe_pair(name, x, p,
                          JL.ModelOptions(moe_capacity_factor=factor,
                                          use_pallas=pallas,
                                          pallas_interpret=True),
                          TL.ModelOptions(moe_capacity_factor=factor))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("mode", ["moe_per_seq_dispatch",
                                  "moe_gather_decode"])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_dispatch_options_match_reference(name, mode):
    """Per-sequence slots (B=3, drops within a sequence) and the gathered
    decode path (T*K <= E: one token per sequence, B=2)."""
    cfg = get_config(name).reduced()
    B, S = (3, 8) if mode == "moe_per_seq_dispatch" else (2, 1)
    x, p = _moe_inputs(cfg, 2, B=B, S=S, skew=2.0)
    # a factor of 0.5 makes the global path drop assignments, so the
    # option's result differs from it (it is not the global path by
    # accident)
    kw = dict(moe_capacity_factor=0.5)
    base, _ = _moe_pair(name, x, p, JL.ModelOptions(**kw),
                        TL.ModelOptions(**kw))
    kw[mode] = True
    got, want = _moe_pair(name, x, p, JL.ModelOptions(**kw),
                          TL.ModelOptions(**kw))
    _close(got, want, 1e-5)
    assert np.abs(base - got).max() > 1e-3


def test_moe_ties_go_to_the_lower_expert():
    """Experts 0 and 1 have the same router column, so every token's
    logits tie between them; expert 2's column is twice theirs, so with
    top-2 the tie straddles the cut and only the lower id may be picked.
    A row of exactly equal logits (x = 0) picks experts 0 and 1. Two
    padded experts are masked out of routing."""
    cfg = dataclasses.replace(get_config(GRANITE).reduced(),
                              num_experts_padded=6)
    x, p = _moe_inputs(cfg, 3, skew=0.0)
    u = p["router"][:, 0]
    x = np.abs(x) * np.sign(u)[None, None]           # every x . u > 0
    p["router"][:, 1] = u
    p["router"][:, 2] = 2 * u
    p["router"][:, 3] = -u
    x[0, 0] = 0.0                                    # all-equal logits
    gates, idx = TL._route(torch.from_numpy(x.reshape(-1, cfg.d_model)),
                           torch.from_numpy(p["router"]), cfg)
    assert idx[0].tolist() == [0, 1]
    assert idx[1:].tolist() == [[2, 0]] * (idx.shape[0] - 1)
    assert torch.allclose(gates.sum(-1), torch.ones(idx.shape[0]))
    for factor in (1.25, 64.0):
        got, want = _moe_pair(GRANITE, x, p,
                              JL.ModelOptions(moe_capacity_factor=factor),
                              TL.ModelOptions(moe_capacity_factor=factor),
                              num_experts_padded=6)
        _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# configs, parameters, model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", MOE_ARCHS)
def test_configs_and_from_jax_round_trip(name):
    """The port's config and ``.reduced()`` equal the reference's; every
    reference leaf of the reduced tree lands in the port unchanged."""
    for full in (False, True):
        j, t = jget_config(name), get_config(name)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jcfg, jparams = reduced_params(name)
    tcfg = get_config(name).reduced()
    tparams = TP.from_jax(TM.model_template(tcfg),
                          jax.tree.map(np.asarray, jparams), device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves = dict(TP.leaves(tparams))
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        key = "/".join(p.key for p in path)
        np.testing.assert_array_equal(tleaves[key].numpy(), np.asarray(leaf))
    sub = tparams["decoder"]["blocks"]["sub0"]
    assert ("wi" in sub) == (name == "arctic-480b")   # the dense residual
    assert tuple(sub["moe_wi"].shape[1:]) == (4, 64, 48)


@pytest.mark.parametrize("name,pallas", [(GRANITE, False), (GRANITE, True),
                                         ("arctic-480b", False)])
def test_prefill_and_decode_match_reference(name, pallas):
    """Batch-2 prefill then 6 greedy decode steps: logits within 1e-4 of
    the reference's einsum path at every step, tokens equal. Against its
    Pallas path (interpret mode) logits agree within 2e-3: that path
    attends the bf16-rounded cache where the einsum path attends the f32
    rows, and the reference's two paths differ from each other by up to
    5.6e-4 on these inputs."""
    jcfg, jparams = reduced_params(name)
    tcfg, tparams = port_params(name)
    jopts = JL.ModelOptions(remat=False, use_pallas=pallas,
                            pallas_interpret=True)
    topts = TL.ModelOptions()
    tol = dict(atol=2e-3, rtol=2e-3) if pallas else LOGIT_TOL
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 9))
    max_seq = 16
    jl, jc = JM.prefill(jcfg, jopts, jparams, {"tokens": jnp.asarray(tokens)},
                        max_seq)
    tl, tc = TM.prefill(tcfg, topts, tparams, {"tokens": tokens}, max_seq,
                        device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
    for i in range(6):
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
        jl, jc = JM.decode_step(jcfg, jopts, jparams, jnp.asarray(tok), jc,
                                9 + i)
        tl, tc = TM.decode_step(tcfg, topts, tparams, tok, tc, 9 + i,
                                device="cpu")
        np.testing.assert_allclose(tl.numpy().reshape(2, -1),
                                   np.asarray(jl).reshape(2, -1), **tol)
        tok = np.asarray(jnp.argmax(jl.reshape(2, -1), -1)).astype(
            np.int32)[:, None]


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

# refill: 5 requests on 2 slots (slots free and refill mid-run);
# idle: 3 requests on 4 slots (one slot never admitted; the others finish
# at staggered times and ride the tick while the last one decodes)
SCHEDULES = {"refill": ([(4, 7), (9, 3), (6, 12), (3, 5), (8, 9)], 2),
             "idle": ([(5, 3), (7, 11), (4, 6)], 4)}
ENGINES = {"dense": {}, "dense-per-token": dict(fused=False),
           "paged": LAYOUTS["paged-bf16"],
           "paged-int8": LAYOUTS["int8-head"],
           "paged-chunked": dict(LAYOUTS["paged-bf16"], chunked_prefill=True,
                                 chunk_size=8, token_budget=16)}


def _counting_drops(monkeypatch):
    """Wrap the port's ``layers.moe`` to count the assignments its
    capacity dispatch drops over a run, in prefill passes and in decode
    steps (one row per slot); returns the running counts."""
    dropped = {"prefill": 0, "decode": 0}
    moe = TL.moe

    def counted(p, x, cfg, opts):
        kind = "decode" if x.shape[1] == 1 else "prefill"
        dropped[kind] += _drops(cfg, x, p, opts.moe_capacity_factor)
        return moe(p, x, cfg, opts)
    monkeypatch.setattr(TL, "moe", counted)
    return dropped


def _engine_matches_reference(name, engine, schedule, monkeypatch):
    cfg, _ = port_params(name)
    shape, n_slots = SCHEDULES[schedule]
    reqs = _requests(cfg, 6, shape)
    kw = dict(n_slots=n_slots, opts=dict(moe_capacity_factor=0.5),
              **ENGINES[engine])
    dropped = _counting_drops(monkeypatch)
    port = run_port(name, reqs, **kw)
    monkeypatch.undo()
    assert dropped["prefill"] > 0 and dropped["decode"] > 0
    ref = run_ref(name, reqs, **kw)
    if "chunked" in engine:
        assert_same_chunked_run(port, ref)
    else:
        assert_same_run(port, ref)
    assert all(len(port[0][i]) == m for i, (_, m, _) in enumerate(reqs))
    assert (port[1].masked_steps > 0) == ENGINES[engine].get("fused", True)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_moe_engine_matches_reference(engine, schedule, monkeypatch):
    """Reduced granite through the port's and the reference's engines on
    the same requests: greedy streams, ticks, device steps (and the chunked
    engine's prefill counters) equal. The capacity dispatch couples the
    rows of a pass, so this holds only if the port sends the reference's
    exact rows through ``moe``: finished slots' last tokens at their frozen
    positions, never-admitted slots' token 0 at 0, a chunk's zero padding
    rows, and the same T. A capacity factor of 0.5 (one slot per expert
    at decode) makes the decode steps drop assignments too, so every row
    of a step competes with the others."""
    _engine_matches_reference(GRANITE, engine, schedule, monkeypatch)


def test_arctic_engine_matches_reference(monkeypatch):
    """The same for reduced arctic (MoE beside a dense residual MLP, the
    ``moe+dense`` sublayer), paged with an int8 pool, on the refill
    schedule."""
    _engine_matches_reference("arctic-480b", "paged-int8", "refill",
                              monkeypatch)


def test_masked_steps_leave_the_null_page_as_found():
    """A fused tick whose slot 1 finishes at its first step runs its other
    three steps masked; a retired slot 2 (all-null table row) rides along
    and writes the null page, with rows that the capacity dispatch couples
    to the live slots' advanced rows. The null page, every other page and the
    carry must be what one unmasked step leaves."""
    from repro_torch.serving import engine as TE
    cfg, params = port_params(GRANITE)
    opts = TL.ModelOptions(moe_capacity_factor=0.5)
    rng = np.random.default_rng(8)
    caches = TM.init_caches(cfg, 3, 24, torch.float32, paged=True,
                            num_pages=7, page_size=8, device="cpu")
    for path, leaf in TP.leaves(caches):
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32)))
    # the retired slot is the last row, so the live rows come first in
    # the dispatch's token order and can take its experts' slots
    table = torch.tensor([[3, 4, 5], [1, 2, 0], [0, 0, 0]], dtype=torch.int32)
    carry = dict(tokens=torch.tensor([[13], [11], [7]]),
                 index=torch.tensor([17, 9, 5], dtype=torch.int32),
                 budget=torch.tensor([6, 1, 0], dtype=torch.int32),
                 done=torch.tensor([False, False, True]))
    runs = []
    for max_steps in (4, 1):
        c = {p: t.clone() for p, t in TP.leaves(caches)}
        tree = {}
        for p, t in c.items():
            TP.set_leaf(tree, p, t)
        out = TE._fused_tick(cfg, opts, 4, -999, 0.0, 0, params,
                             carry["tokens"], tree, carry["index"],
                             carry["budget"], carry["done"],
                             torch.zeros(3, dtype=torch.long), max_steps,
                             table, device="cpu")
        runs.append((out, c))
    (masked, c4), (single, c1) = runs
    assert int(masked[-1]) == int(single[-1]) == 1       # one real step
    for a, b in zip(masked[:1] + masked[2:-1], single[:1] + single[2:-1]):
        assert torch.equal(a, b)
    for p in c4:
        null = (slice(None), 0) if p.startswith("blocks/") else (0,)
        assert torch.equal(c4[p][null], c1[p][null]), p
