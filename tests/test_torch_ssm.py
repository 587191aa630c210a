"""The port's Mamba2 family against the JAX reference.

Inputs are made with numpy from seeds and handed to both frameworks;
weights of the reduced mamba2-780m and jamba-1.5-large-398b come from the
reference through ``from_jax``. Tolerances:

- the plain chunked SSD against the reference's Pallas kernel (interpret
  mode), its ``ssd_chunked`` and the sequential ``ssd_scan_ref``:
  ``atol=5e-4, rtol=5e-3``, as the reference's own kernel tests use (f32;
  the chunked and sequential forms sum in different orders over up to 512
  rows);
- ``mamba_block`` prefill and decode within 1e-5 (f32; the same terms,
  summed in another order);
- model logits within 1e-4 (f32 weights and f32 caches, as the engines
  keep: a bf16 conv or attention cache would round values that differ in
  the last f32 bit to different bf16 neighbours);
- greedy streams and the engines' counters equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.configs import get_config as jget_config
from repro.kernels.ssd import ops as jssd
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ops as tssd
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models import stacks as TS
from repro_torch.serving import ServingEngine
from repro_torch.serving import engine as TE
from test_torch_serving import (LAYOUTS, _requests, assert_same_run,
                                port_params, run_port, run_ref)

MAMBA = "mamba2-780m"
JAMBA = "jamba-1.5-large-398b"
SSD_TOL = dict(atol=5e-4, rtol=5e-3)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _ssd_inputs(seed, B, S, H, P, N):
    """The reference kernel tests' distributions, drawn with numpy."""
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A_log = rng.uniform(0.0, 1.5, H).astype(np.float32)
    B_ = (0.3 * rng.standard_normal((B, S, 1, N))).astype(np.float32)
    C_ = (0.3 * rng.standard_normal((B, S, 1, N))).astype(np.float32)
    return xs, dt, A_log, B_, C_


def _np(t):
    return np.asarray(t, np.float32)


# ---------------------------------------------------------------------------
# the SSD scan's plain version
# ---------------------------------------------------------------------------

# the reference's test_kernels.py cases, then sequences shorter than Q
SSD_CASES = [(2, 256, 4, 64, 128, 128), (1, 128, 2, 32, 64, 64),
             (2, 512, 3, 64, 128, 128), (1, 256, 8, 16, 32, 64),
             (2, 40, 3, 16, 32, 128), (1, 9, 2, 16, 16, 128)]


@functools.cache
def _ssd_refs(B, S, H, P, N, Q):
    """The reference's scans of ``_ssd_inputs(S + H, ...)``: the Pallas
    kernel in interpret mode, ``ssd_chunked`` and ``ssd_scan_ref``."""
    j = [jnp.asarray(a) for a in _ssd_inputs(S + H, B, S, H, P, N)]
    return {"pallas": jssd.ssd(*j, Q=Q, interpret=True),
            "ssd_chunked": JL.ssd_chunked(*j, chunk=Q),
            "ssd_scan_ref": JL.ssd_scan_ref(*j)}


@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_CASES)
def test_ssd_plain_matches_reference(B, S, H, P, N, Q):
    inputs = _ssd_inputs(S + H, B, S, H, P, N)
    t = [torch.from_numpy(a) for a in inputs]
    y, st = tssd.ssd(*t, Q=Q)
    assert y.dtype == torch.float32 and st.shape == (B, H, P, N)
    yp, sp = tssd.ssd_chunked(*t, Q=Q)
    assert torch.equal(y, yp) and torch.equal(st, sp)   # the CPU path
    refs = _ssd_refs(B, S, H, P, N, Q)
    for name, (yr, sr) in refs.items():
        np.testing.assert_allclose(y.numpy(), _np(yr), **SSD_TOL,
                                   err_msg=name)
        np.testing.assert_allclose(st.numpy(), _np(sr), **SSD_TOL,
                                   err_msg=name)
    ys, ss = TL.ssd_scan_ref(*t)
    np.testing.assert_allclose(ys.numpy(), _np(refs["ssd_scan_ref"][0]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ss.numpy(), _np(refs["ssd_scan_ref"][1]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_CASES)
def test_ssd_chunk_states_compose_to_the_scan(B, S, H, P, N, Q):
    """``ssd_chunk_states`` gives what the kernel's first pass writes to
    its scratch: each chunk's own state term and its seg. Composed in
    order (h = h exp(seg_k) + s_k from zero), with the intra-chunk term
    written out here in float64, they give ``ssd_chunked``'s final state
    and y, and the reference's Pallas kernel's and ``ssd_chunked``'s."""
    inputs = _ssd_inputs(S + H, B, S, H, P, N)
    t = [torch.from_numpy(a) for a in inputs]
    states, segs = tssd.ssd_chunk_states(*t[:4], Q=Q)
    Qc = min(Q, S)
    nc = S // Qc
    assert states.shape == (B, H, nc, P, N) and segs.shape == (B, H, nc)
    assert states.dtype == segs.dtype == torch.float32
    xs, dt, A_log, Bm, Cm = (a.astype(np.float64) for a in inputs)
    x = xs.reshape(B, nc, Qc, H, P)
    d = dt.reshape(B, nc, Qc, H)
    b = Bm.reshape(B, nc, Qc, N)
    c = Cm.reshape(B, nc, Qc, N)
    cum = np.cumsum(d * -np.exp(A_log), axis=2)              # [B,nc,Q,H]
    np.testing.assert_allclose(segs.numpy(),
                               cum[:, :, -1].transpose(0, 2, 1),
                               atol=1e-5, rtol=1e-5)
    below = np.tril(np.ones((Qc, Qc), bool))[None, :, :, None]
    h = np.zeros((B, H, P, N))
    y = np.zeros((B, nc, Qc, H, P))
    st, sg = states.double().numpy(), segs.double().numpy()
    for k in range(nc):
        ck = cum[:, k]
        L = np.exp(np.where(below, ck[:, :, None] - ck[:, None], -np.inf))
        cb = np.einsum("bsn,btn->bst", c[:, k], b[:, k])
        y[:, k] = (np.einsum("bst,bsth,bth,bthp->bshp", cb, L, d[:, k],
                             x[:, k])
                   + np.einsum("bsn,bsh,bhpn->bshp", c[:, k], np.exp(ck), h))
        h = h * np.exp(sg[:, :, k])[..., None, None] + st[:, :, k]
    y = y.reshape(B, S, H, P)
    yp, sp = tssd.ssd_chunked(*t, Q=Q)
    np.testing.assert_allclose(h, sp.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(y, yp.numpy(), atol=1e-4, rtol=1e-4)
    for name, (yr, sr) in _ssd_refs(B, S, H, P, N, Q).items():
        if name != "ssd_scan_ref":
            np.testing.assert_allclose(y, _np(yr), **SSD_TOL, err_msg=name)
            np.testing.assert_allclose(h, _np(sr), **SSD_TOL, err_msg=name)


def test_ssd_keeps_bf16_outputs_in_bf16():
    """bf16 x, B and C: y comes back in bf16, the state in f32, both
    within bf16 rounding of the f32 scan over the same (rounded) values."""
    inputs = _ssd_inputs(3, 1, 256, 4, 64, 128)
    t = [torch.from_numpy(a) for a in inputs]
    lo = [t[0].bfloat16(), t[1], t[2], t[3].bfloat16(), t[4].bfloat16()]
    y, st = tssd.ssd(*lo)
    assert y.dtype == torch.bfloat16 and st.dtype == torch.float32
    yf, sf = tssd.ssd(*[a.float() for a in lo])
    np.testing.assert_allclose(y.float().numpy(), yf.numpy(), atol=2e-2,
                               rtol=1e-2)
    np.testing.assert_allclose(st.numpy(), sf.numpy(), atol=1e-6, rtol=1e-6)


def test_ssd_refuses_lengths_past_a_chunk_that_are_not_whole_chunks():
    """S=160 with Q=128: the reference's ``ssd_chunked`` cannot reshape
    it and its Pallas kernel leaves rows 128-159 unwritten; the port
    refuses it, in the wrapper, the plain version and the model's
    prefill."""
    t = [torch.from_numpy(a) for a in _ssd_inputs(1, 1, 160, 2, 16, 16)]
    for fn in (tssd.ssd, tssd.ssd_chunked):
        with pytest.raises(ValueError, match="multiple of the chunk"):
            fn(*t, Q=128)
    cfg, params = port_params(MAMBA)
    tokens = np.zeros((1, 160), np.int64)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        TM.prefill(cfg, TL.ModelOptions(), params, {"tokens": tokens}, 192,
                   device="cpu")


def test_ssd_wrapper_checks_its_operands():
    xs, dt, A_log, B_, C_ = (torch.from_numpy(a)
                             for a in _ssd_inputs(2, 1, 16, 2, 16, 8))
    with pytest.raises(ValueError, match="one group"):
        tssd.ssd(xs, dt, A_log, B_.expand(1, 16, 2, 8), C_)
    with pytest.raises(ValueError, match="do not match"):
        tssd.ssd(xs, dt[:, :8], A_log, B_, C_)


# ---------------------------------------------------------------------------
# mamba_block
# ---------------------------------------------------------------------------

def _layer0(name):
    """Layer 0's Mamba parameters of the reduced model in both frameworks
    (jamba: its first sub-layer is a Mamba layer)."""
    jcfg, jparams = reduced_params(name)
    tcfg, tparams = port_params(name)
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"]["blocks"]["sub0"])
    tp = {k: v[0] for k, v in tparams["decoder"]["blocks"]["sub0"].items()}
    return jcfg, jp, tcfg, tp


@pytest.mark.parametrize("S", [1, 9, 128])
@pytest.mark.parametrize("pallas", [False, True], ids=["einsum", "pallas"])
def test_mamba_block_matches_reference(S, pallas):
    """Prefill from a zero state (S rows; one row pads the conv state),
    then one decode step from the states the prefill returned."""
    jcfg, jp, tcfg, tp = _layer0(MAMBA)
    jopts = JL.ModelOptions(remat=False, use_pallas=pallas,
                            pallas_interpret=True)
    block = jax.jit(functools.partial(JL.mamba_block, cfg=jcfg, opts=jopts),
                    static_argnames="decode")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    jo, js, jc = block(jp, jnp.asarray(x))
    to, ts, tc = TL.mamba_block(tp, torch.from_numpy(x), tcfg,
                                TL.ModelOptions())
    for got, want in ((to, jo), (ts, js), (tc, jc)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                                   rtol=1e-5)
    x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
    jo, js, jc = block(jp, jnp.asarray(x1), state=js, conv_state=jc,
                       decode=True)
    to, ts, tc = TL.mamba_block(tp, torch.from_numpy(x1), tcfg,
                                TL.ModelOptions(), state=ts,
                                conv_state=tc, decode=True)
    for got, want in ((to, jo), (ts, js), (tc, jc)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                                   rtol=1e-5)


def test_mamba_decode_promotes_like_the_reference():
    """bf16 activations against an f32 conv state: the window, the conv
    output and the state update run in f32, the output in bf16, as in the
    reference (its concatenate promotes to f32)."""
    jcfg, jp, tcfg, tp = _layer0(MAMBA)
    tpb = {k: v.bfloat16() for k, v in tp.items()}
    rng = np.random.default_rng(4)
    _, H, P, N, _, ch = TL.mamba_dims(tcfg)
    state = torch.from_numpy(rng.standard_normal((2, H, P, N),
                                                 dtype=np.float32))
    conv = torch.from_numpy(rng.standard_normal((2, 3, ch),
                                                dtype=np.float32))
    x1 = torch.from_numpy(rng.standard_normal((2, 1, tcfg.d_model),
                                              dtype=np.float32)).bfloat16()
    out, st, cs = TL.mamba_block(tpb, x1, tcfg, TL.ModelOptions(),
                                 state=state, conv_state=conv, decode=True)
    block = jax.jit(functools.partial(
        JL.mamba_block, cfg=jcfg, opts=JL.ModelOptions(remat=False),
        decode=True))
    jout, jst, jcs = block(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jp),
        jnp.asarray(x1.float().numpy(), jnp.bfloat16),
        state=jnp.asarray(state.numpy()),
        conv_state=jnp.asarray(conv.numpy()))
    assert (out.dtype, st.dtype, cs.dtype) == (torch.bfloat16,
                                               torch.float32, torch.float32)
    assert (jout.dtype, jst.dtype, jcs.dtype) == (jnp.bfloat16, jnp.float32,
                                                  jnp.float32)
    np.testing.assert_allclose(cs.numpy(), _np(jcs), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), _np(jst), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(out.float().numpy(), _np(jout), atol=2e-2,
                               rtol=2e-2)


# ---------------------------------------------------------------------------
# configs, parameters, models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [MAMBA, JAMBA])
def test_configs_and_from_jax_round_trip(name):
    """The port's configs equal the reference's (full and reduced), and
    ``from_jax`` consumes and fills every leaf, Mamba leaves included."""
    for full in (True, False):
        j, t = jget_config(name), get_config(name)
        if not full:
            j, t = j.reduced(), t.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert [t.is_attn_layer(i) for i in range(t.num_layers)] == \
            [j.is_attn_layer(i) for i in range(j.num_layers)]
    jcfg, jparams = reduced_params(name)
    tcfg, tparams = port_params(name)
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves = dict(TP.leaves(tparams))
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        key = "/".join(p.key for p in path)
        np.testing.assert_array_equal(tleaves[key].numpy(), np.asarray(leaf))
    assert "A_log" in tparams["decoder"]["blocks"]["sub0"]


def test_full_width_mamba2_template():
    """Full mamba2-780m has no attention heads (num_heads = 0): its
    template and caches build from shapes alone, with the published
    parameter count, and every layer is a Mamba layer."""
    cfg = get_config(MAMBA)
    assert cfg.num_heads == cfg.num_kv_heads == 0
    assert TP.param_count(TM.model_template(cfg)) == 780_148_992
    shapes = dict(TP.leaves(TS.cache_template(cfg, 8, 864)))
    assert {p: s.shape for p, s in shapes.items()} == {
        "blocks/sub0/ssm": (48, 8, 48, 64, 128),
        "blocks/sub0/conv": (48, 8, 3, 3328)}
    assert TS.cache_dtype("ssm", torch.bfloat16) == torch.float32
    assert TS.cache_dtype("conv", torch.bfloat16) == torch.bfloat16


def test_init_params_draws_the_mamba_inits():
    """The port's seeded init: A_log = log(U[1, 16]) and a dt bias whose
    softplus lies in [1e-3, 1e-1], per layer and head."""
    cfg = get_config(MAMBA).reduced()
    p = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    sub = p["decoder"]["blocks"]["sub0"]
    a = torch.exp(sub["A_log"])
    assert bool(((a >= 1.0) & (a <= 16.0)).all()) and a.std() > 1.0
    sp = torch.nn.functional.softplus(sub["dt_bias"])
    assert bool(((sp >= 1e-3 * 0.999) & (sp <= 1e-1 * 1.001)).all())
    assert torch.equal(sub["d_skip"], torch.ones_like(sub["d_skip"]))


def _greedy_steps(name, jopts, tokens, steps: int = 6):
    """Prefill ``tokens`` on f32 caches, then ``steps`` greedy decode steps
    in both frameworks (the reference's calls jitted); logits within 1e-4
    at every call, the port's argmax equal to the reference's. Returns
    the reference's first token [B,1] and its decoded tokens [B,steps]."""
    jcfg, jparams = reduced_params(name)
    tcfg, tparams = port_params(name)
    topts = TL.ModelOptions()
    S = tokens.shape[1]
    jprefill = jax.jit(lambda p, t: JM.prefill(jcfg, jopts, p, {"tokens": t},
                                               16, cache_dtype=jnp.float32))
    jstep = jax.jit(lambda p, t, c, i: JM.decode_step(jcfg, jopts, p, t, c,
                                                      i))
    jl, jc = jprefill(jparams, jnp.asarray(tokens))
    tl, tc = TM.prefill(tcfg, topts, tparams, {"tokens": tokens}, 16,
                        cache_dtype=torch.float32, device="cpu")
    first = tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(
        np.int32)[:, None]
    out = []
    for i in range(steps):
        np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
        assert np.array_equal(tl[:, -1].argmax(-1).numpy(), tok[:, 0])
        jl, jc = jstep(jparams, jnp.asarray(tok), jc, S + i)
        tl, tc = TM.decode_step(tcfg, topts, tparams, tok, tc, S + i,
                                device="cpu")
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]
        out.append(tok[:, 0])
    np.testing.assert_allclose(tl.numpy(), _np(jl), **LOGIT_TOL)
    return first, np.stack(out, 1)


@pytest.mark.parametrize("pallas", [False, True], ids=["einsum", "pallas"])
def test_mamba2_model_matches_reference(pallas):
    """Reduced mamba2-780m: forward, prefill (f32 caches), 6 decode steps
    and ``decode_loop``: logits within 1e-4, greedy tokens equal."""
    jcfg, jparams = reduced_params(MAMBA)
    tcfg, tparams = port_params(MAMBA)
    jopts = JL.ModelOptions(remat=False, use_pallas=pallas,
                            pallas_interpret=True)
    topts = TL.ModelOptions()
    tokens = np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 9))
    jf = jax.jit(lambda p, t: JM.forward(jcfg, jopts, p, {"tokens": t}))(
        jparams, jnp.asarray(tokens))
    tf = TM.forward(tcfg, topts, tparams, {"tokens": tokens}, device="cpu")
    np.testing.assert_allclose(tf.numpy(), _np(jf), **LOGIT_TOL)
    first, jtoks = _greedy_steps(MAMBA, jopts, tokens)
    _, caches = TM.prefill(tcfg, topts, tparams, {"tokens": tokens}, 16,
                           cache_dtype=torch.float32, device="cpu")
    toks, last, _ = TM.decode_loop(tcfg, topts, tparams, first, caches, 9,
                                   6, device="cpu")
    assert np.array_equal(toks.numpy(), jtoks)
    assert np.array_equal(last.numpy()[:, 0], jtoks[:, -1])


def test_hybrid_prefill_and_decode_match_reference():
    """Reduced jamba (16 layers: attention every 8th, MoE every other,
    Mamba elsewhere): prefill on f32 caches, then 6 greedy decode steps;
    logits within 1e-4 at every step, tokens equal."""
    tcfg, _ = port_params(JAMBA)
    assert {k.mixer for k in TS.sub_kinds(tcfg)} == {"attn", "mamba"}
    tokens = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 9))
    _greedy_steps(JAMBA, JL.ModelOptions(remat=False), tokens)


@pytest.mark.parametrize("name", [MAMBA, JAMBA])
def test_resumed_prefill_is_refused(name):
    """A Mamba layer's scan starts from zero, so prefill from a position
    past 0 and chunk prefill refuse SSM stacks instead of dropping the
    state the cache holds."""
    cfg, params = port_params(name)
    opts = TL.ModelOptions()
    caches = TM.init_caches(cfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="position 0 only"):
        TM.prefill(cfg, opts, params, {"tokens": np.zeros((1, 4))}, 16,
                   caches=caches, cache_index=4, device="cpu")
    with pytest.raises(NotImplementedError, match="position 0 only"):
        TM.prefill_chunk(cfg, opts, params,
                         torch.zeros(1, 4, cfg.d_model), caches, 0,
                         device="cpu")


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

# mixed lengths and budgets on 2 slots (slots free and refill mid-run; a
# one-token prompt takes the recurrence at prefill); and 3 requests on 4
# slots (one never admitted; the others retire at staggered times and
# ride the tick while the last one decodes)
SCHEDULES = {"refill": ([(4, 7), (9, 3), (6, 12), (1, 5), (8, 9)], 2),
             "idle": ([(5, 3), (7, 11), (4, 6)], 4)}
ENGINES = {"dense": {}, "dense-per-token": dict(fused=False),
           "paged": LAYOUTS["paged-bf16"],
           "paged-per-token": dict(LAYOUTS["paged-bf16"], fused=False),
           "paged-int8": LAYOUTS["int8-head"]}
ENGINE_CASES = ([(MAMBA, e, s) for e in ("dense", "dense-per-token",
                                         "paged", "paged-per-token")
                 for s in sorted(SCHEDULES)]
                + [(JAMBA, e, "refill") for e in ("dense", "paged",
                                                  "paged-int8")])


@pytest.mark.parametrize("name,engine,schedule", ENGINE_CASES)
def test_ssm_engine_matches_reference(name, engine, schedule):
    """The admit-stall engines of the port and the reference on the same
    requests: greedy streams, ticks, device steps, syncs and (paged) pages
    equal. The fused tick stops at each finish, so later steps of a tick
    run masked, and they must leave every slot's Mamba state as the
    reference (which never ran them) has it. A paged engine keeps the
    states slot-batched beside its page pools, so its admission scatters
    both."""
    cfg, _ = port_params(name)
    shape, n_slots = SCHEDULES[schedule]
    reqs = _requests(cfg, 7, shape)
    kw = dict(n_slots=n_slots, **ENGINES[engine])
    port = run_port(name, reqs, **kw)
    assert_same_run(port, run_ref(name, reqs, **kw))
    assert all(len(port[0][i]) == m for i, (_, m, _) in enumerate(reqs))
    assert (port[1].masked_steps > 0) == ENGINES[engine].get("fused", True)


@pytest.mark.parametrize("name,layout", [(MAMBA, "dense"), (MAMBA, "paged"),
                                         (JAMBA, "paged")])
def test_masked_steps_leave_recurrent_state_as_found(name, layout):
    """A fused tick whose slot 1 finishes at its first step runs its other
    three steps masked. Every ``ssm``/``conv`` leaf (and the null page, and
    the carry) must be what one unmasked step leaves: a Mamba step is not
    idempotent, so a masked step that kept its update would advance every
    slot once more than the reference."""
    cfg, params = port_params(name)
    paged = layout == "paged"
    rng = np.random.default_rng(9)
    caches = TM.init_caches(cfg, 3, 24, torch.float32, paged=paged,
                            num_pages=7, page_size=8, device="cpu")
    for _, leaf in TP.leaves(caches):
        leaf.copy_(torch.from_numpy(rng.standard_normal(
            tuple(leaf.shape)).astype(np.float32)))
    table = (torch.tensor([[3, 4, 5], [1, 2, 0], [0, 0, 0]],
                          dtype=torch.int32) if paged else None)
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
        out = TE._fused_tick(cfg, TL.ModelOptions(), 4, -999, 0.0, 0,
                             params, carry["tokens"], tree, carry["index"],
                             carry["budget"], carry["done"],
                             torch.zeros(3, dtype=torch.long), max_steps,
                             table, device="cpu")
        runs.append((out, c))
    (masked, c4), (single, c1) = runs
    assert int(masked[-1]) == int(single[-1]) == 1       # one real step
    for a, b in zip(masked[:1] + masked[2:-1], single[:1] + single[2:-1]):
        assert torch.equal(a, b)
    recurrent = [p for p in c4 if p.endswith(("/ssm", "/conv"))]
    assert recurrent
    for p in recurrent:
        assert torch.equal(c4[p], c1[p]), p
        assert not torch.equal(c1[p], dict(TP.leaves(caches))[p]), p
    if paged:
        for p in c4:
            if p.endswith(("/k", "/v")):
                assert torch.equal(c4[p][:, 0], c1[p][:, 0]), p


@pytest.mark.parametrize("name", [MAMBA, JAMBA])
def test_chunked_engine_refuses_ssm_stacks(name):
    """Chunked prefill needs a chunk-resumable SSM scan, which neither
    package has: both engines refuse SSM and hybrid stacks, in the same
    words."""
    tcfg, tparams = port_params(name)
    jcfg, jparams = reduced_params(name)
    with pytest.raises(ValueError) as port_err:
        ServingEngine(tcfg, TL.ModelOptions(), tparams, chunked_prefill=True,
                      device="cpu")
    with pytest.raises(ValueError) as ref_err:
        JEngine(jcfg, JL.ModelOptions(remat=False), jparams,
                chunked_prefill=True)
    assert str(port_err.value) == str(ref_err.value)
    assert "not chunk-resumable" in str(port_err.value)


@pytest.mark.parametrize("name", [MAMBA, JAMBA])
def test_submit_refuses_a_prompt_the_scan_cannot_take(name):
    """A 160-token prompt (past one 128-row chunk and not whole chunks) is
    refused at ``submit`` with the scan's ValueError: nothing is queued and
    no sample key is drawn, so the accepted requests keep the keys they
    get without it, ``pending`` counts them only, and they are served with
    the reference engine's streams."""
    cfg, params = port_params(name)
    rng = np.random.default_rng(17)
    reqs = [(rng.integers(0, cfg.vocab_size, n, dtype=np.int32), m, None)
            for n, m in ((20, 6), (160, 5), (30, 4), (128, 3))]
    accepted = [reqs[i] for i in (0, 2, 3)]

    def engine():
        return ServingEngine(cfg, TL.ModelOptions(), params, n_slots=2,
                             max_seq=192, eos=-999, tick_tokens=4,
                             device="cpu")
    eng = engine()
    for i, (prompt, m, _) in enumerate(reqs):
        req = TE.Request(uid=i, prompt=prompt.copy(), max_tokens=m)
        if i == 1:
            with pytest.raises(ValueError, match="multiple of the chunk"):
                eng.submit(req)
        else:
            eng.submit(req)
    assert eng.pending == 3
    plain = engine()
    for i, (prompt, m, _) in zip((0, 2, 3), accepted):
        plain.submit(TE.Request(uid=i, prompt=prompt.copy(), max_tokens=m))
    assert [r.sample_key for r in eng.queue] == \
        [r.sample_key for r in plain.queue]
    done = {r.uid: r.out_tokens for r in eng.run()}
    assert sorted(done) == [0, 2, 3] and eng.pending == 0
    ref, _ = run_ref(name, accepted, n_slots=2, max_seq=192)
    assert [done[u] for u in (0, 2, 3)] == [ref[u] for u in range(3)]
