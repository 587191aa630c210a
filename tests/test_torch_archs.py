"""granite-3-2b, internvl2-1b and gemma3-27b in the port against the JAX
reference, on their reduced forms.

Weights come from the reference through ``from_jax``; tokens, patches and
requests are made with numpy from seeds. Tolerances are
``tests/test_torch_model.py``'s: logits within 1e-4 (f32 weights; the two
frameworks sum in other orders; a cache's rows within 1e-5), greedy
streams and engine counters equal.
gemma3 runs in a 6-layer variant of its reduced form (``dataclasses.
replace`` on both sides), so that its 5:1 pattern holds a global layer
beside five local ones (window 32); its ring caches
(``ModelOptions(window_cache=True)``) are held to the reference's ring
caches and to the port's full caches across the ring's wrap, and its
engines (ring caches fused and per-token; full caches dense and paged)
to the reference engine, as are granite-3-2b's and internvl2-1b's
(dense and paged). The serve driver runs granite-3-2b to its summary
line and refuses whisper-small with the engine's reason.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import stacks as JS
from repro.serving import Request as JReq
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models import stacks as TS
from repro_torch.serving import Request, ServingEngine

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GEMMA = "gemma3-27b"
GEMMA_LAYERS = 6        # one 5:1 period: five local layers, one global
RING = dict(window_cache=True)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BRIDGE = {}


def bridge(name):
    """(JAX cfg, JAX params, port cfg, port params on the CPU); gemma3 in
    its 6-layer reduced variant."""
    if name not in _BRIDGE:
        if name == GEMMA:
            jcfg = dataclasses.replace(jget(name).reduced(),
                                       num_layers=GEMMA_LAYERS)
            jparams = JM.init_params(JM.model_template(jcfg),
                                     jax.random.PRNGKey(0), jnp.float32)
            tcfg = dataclasses.replace(get_config(name).reduced(),
                                       num_layers=GEMMA_LAYERS)
        else:
            jcfg, jparams = reduced_params(name)
            tcfg = get_config(name).reduced()
        tparams = TP.from_jax(TM.model_template(tcfg),
                              jax.tree.map(np.asarray, jparams),
                              device="cpu")
        _BRIDGE[name] = (jcfg, jparams, tcfg, tparams)
    return _BRIDGE[name]


def _batch(cfg, seed, B=2, S=7):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.vision is not None:
        batch["patches"] = rng.standard_normal(
            (B, cfg.vision.num_tokens, cfg.vision.embed_dim),
            dtype=np.float32)
    return batch


def test_registry_matches_reference():
    """Every name of the reference's registry, in its order, with the
    reference's values field for field (nested configs too), and the DiT
    variant."""
    from repro.configs import list_archs as jlist
    from repro_torch.configs import list_archs
    assert list_archs() == jlist()
    for name in list_archs() + ("molmoact-7b-dit",):
        port, ref = get_config(name), jget(name)
        for f in dataclasses.fields(port):
            a, b = getattr(port, f.name), getattr(ref, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (name, f.name)


def test_gemma_variant_has_both_layer_kinds():
    _, _, tcfg, _ = bridge(GEMMA)
    assert [k.window for k in TS.sub_kinds(tcfg)] == [32] * 5 + [0]


@pytest.mark.parametrize("name,pallas", [
    ("granite-3-2b", False), ("granite-3-2b", True),
    ("internvl2-1b", False), (GEMMA, False), (GEMMA, True)])
def test_forward_prefill_decode_match_reference(name, pallas):
    """forward, prefill and three decode steps (greedy tokens) within
    1e-4; the reference also through its Pallas kernels in interpret
    mode."""
    jcfg, jparams, tcfg, tparams = bridge(name)
    jo = JL.ModelOptions(remat=False, use_pallas=pallas,
                         pallas_interpret=True)
    to = TL.ModelOptions()
    batch = _batch(tcfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        TM.forward(tcfg, to, tparams, batch, device="cpu").numpy(),
        np.asarray(JM.forward(jcfg, jo, jparams, jb)), **LOGIT_TOL)
    max_seq = 40
    jl, jc = JM.prefill(jcfg, jo, jparams, jb, max_seq,
                        cache_dtype=jnp.float32)
    tl, tc = TM.prefill(tcfg, to, tparams, batch, max_seq,
                        cache_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    pos = 7 + (tcfg.vision.num_tokens if tcfg.vision else 0)
    step = jax.jit(functools.partial(JM.decode_step, jcfg, jo))
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = step(jparams, jnp.asarray(tok), jc, pos + i)
        tl, tc = TM.decode_step(tcfg, to, tparams, tok, tc, pos + i,
                                device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("name", ["granite-3-2b", "internvl2-1b", GEMMA])
def test_decode_loop_streams_match_reference(name):
    """Greedy ``decode_loop`` streams (12 steps) equal the reference's;
    gemma3's with ring caches too."""
    jcfg, jparams, tcfg, tparams = bridge(name)
    batch = _batch(tcfg, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pos = 7 + (tcfg.vision.num_tokens if tcfg.vision else 0)
    for ring in ((False, True) if name == GEMMA else (False,)):
        jo = JL.ModelOptions(remat=False, window_cache=ring)
        to = TL.ModelOptions(window_cache=ring)
        jl, jc = JM.prefill(jcfg, jo, jparams, jb, 40,
                            cache_dtype=jnp.float32)
        _, tc = TM.prefill(tcfg, to, tparams, batch, 40,
                           cache_dtype=torch.float32, device="cpu")
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jt, _, _ = JM.decode_loop(jcfg, jo, jparams, jnp.asarray(tok), jc,
                                  pos, 12)
        tt, _, _ = TM.decode_loop(tcfg, to, tparams, tok, tc, pos, 12,
                                  device="cpu")
        assert np.array_equal(tt.numpy(), np.asarray(jt))


def test_ring_cache_matches_reference_ring_and_full_cache():
    """8 prompt tokens, then 40 teacher-forced decode steps, across the
    ring's wrap at 32: the port's ring logits within 1e-4 of the
    reference's ring logits and of the port's full-cache logits
    (``tests/test_perf_options.py``'s probe, on both packages)."""
    jcfg, jparams, tcfg, tparams = bridge(GEMMA)
    B, S0, n, max_seq = 1, 8, 40, 64
    tok = np.random.default_rng(3).integers(0, tcfg.vocab_size,
                                            (B, S0 + n)).astype(np.int32)
    jo = JL.ModelOptions(remat=False, window_cache=True)
    step = jax.jit(functools.partial(JM.decode_step, jcfg, jo))
    jl, jc = JM.prefill(jcfg, jo, jparams, {"tokens": jnp.asarray(
        tok[:, :S0])}, max_seq, cache_dtype=jnp.float32)
    port = {}
    for ring in (True, False):
        port[ring] = TM.prefill(tcfg, TL.ModelOptions(window_cache=ring),
                                tparams, {"tokens": tok[:, :S0]}, max_seq,
                                cache_dtype=torch.float32, device="cpu")
    ring_k = port[True][1]["blocks"]["sub0"]["k"]
    assert ring_k.shape[2] == 32                  # [blocks, B, W, K, h]
    assert port[True][1]["blocks"]["sub5"]["k"].shape[2] == max_seq
    for i in range(n + 1):
        np.testing.assert_allclose(port[True][0].numpy(), np.asarray(jl),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(port[True][0].numpy(),
                                   port[False][0].numpy(), **LOGIT_TOL)
        if i == n:
            break
        t = tok[:, S0 + i:S0 + i + 1]
        jl, jc = step(jparams, jnp.asarray(t), jc, S0 + i)
        for ring in (True, False):
            port[ring] = TM.decode_step(
                tcfg, TL.ModelOptions(window_cache=ring), tparams, t,
                port[ring][1], S0 + i, device="cpu")
    np.testing.assert_allclose(                   # the wrapped ring
        ring_k.numpy(), np.asarray(jc["blocks"]["sub0"]["k"]), atol=1e-5,
        rtol=1e-5)


def test_ring_and_cross_cores_match_reference():
    """The two routes that reuse the decode kernel, held on the CPU (its
    plain version) to the reference's cores: ring decode (the clamped
    index, no window) to ``attention_decode_ring`` before and after the
    wrap, per slot; cross decode (the last context row, no window) to the
    reference's non-causal ``attention_dense``. The ring write lands at
    ``index % W`` as the reference's does."""
    rng = np.random.default_rng(7)
    B, W, N, K, h = 3, 32, 4, 2, 16
    q = rng.standard_normal((B, 1, N, h), dtype=np.float32)
    kc = rng.standard_normal((B, W, K, h), dtype=np.float32)
    vc = rng.standard_normal((B, W, K, h), dtype=np.float32)
    opts = TL.ModelOptions()
    for index in (5, 31, 32, 70, (0, 33, 100)):
        idx = np.broadcast_to(np.asarray(index, np.int32), (B,))
        want = np.asarray(JL.attention_decode_ring(
            jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
            jnp.asarray(idx)))
        got = TL.run_attention_core(
            "decode_ring", torch.from_numpy(q), torch.from_numpy(kc),
            torch.from_numpy(vc), opts=opts, window=32,
            index=torch.from_numpy(idx.copy()))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        plain = TL.attention_decode_ring(
            torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(idx.copy()))
        np.testing.assert_allclose(plain.numpy(), want, atol=1e-5,
                                   rtol=1e-5)
        new = rng.standard_normal((B, 1, K, h), dtype=np.float32)
        jw = jax.vmap(lambda c, n, i: jax.lax.dynamic_update_slice_in_dim(
            c, n, i, 0))(jnp.asarray(kc), jnp.asarray(new),
                         jnp.asarray(idx % W))
        tw = TL.update_cache_ring(torch.from_numpy(kc.copy()),
                                  torch.from_numpy(new),
                                  torch.from_numpy(idx.copy()))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    T = 40
    xk = rng.standard_normal((B, T, K, h), dtype=np.float32)
    xv = rng.standard_normal((B, T, K, h), dtype=np.float32)
    want = JL.attention_dense(jnp.asarray(q), jnp.asarray(xk),
                              jnp.asarray(xv), jnp.arange(1), jnp.arange(T),
                              0, causal=False)
    got = TL.run_attention_core(
        "decode_cross", torch.from_numpy(q), torch.from_numpy(xk),
        torch.from_numpy(xv), opts=opts, window=0, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _size(template):
    return sum(int(np.prod(s.shape)) for _, s in TP.leaves(template))


def test_ring_cache_template_is_under_half_the_full_one():
    cfg = get_config(GEMMA).reduced()
    ring = _size(TS.cache_template(cfg, 1, 256, TL.ModelOptions(**RING)))
    assert ring < 0.5 * _size(TS.cache_template(cfg, 1, 256))
    ref = JS.cache_template(jget(GEMMA).reduced(), 1, 256,
                            opts=JL.ModelOptions(**RING))
    assert ring == sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        ref, is_leaf=lambda x: hasattr(x, "axes")))


def test_ring_prefill_longer_than_the_window_raises():
    """S > W cannot fit a ring (the reference fails inside its slice
    update); a positioned ring prefill is refused as well."""
    _, _, tcfg, tparams = bridge(GEMMA)
    opts = TL.ModelOptions(**RING)
    toks = np.zeros((1, 33), np.int64)
    with pytest.raises(ValueError, match="at most 32 rows"):
        TM.prefill(tcfg, opts, tparams, {"tokens": toks}, 64, device="cpu")
    caches = TM.init_caches(tcfg, 1, 64, torch.float32, opts, device="cpu")
    with pytest.raises(ValueError, match="position 0 only"):
        TM.prefill(tcfg, opts, tparams, {"tokens": toks[:, :4]}, 64,
                   caches=caches, cache_index=4, device="cpu")
    TM.prefill(tcfg, opts, tparams, {"tokens": toks[:, :32]}, 64,
               device="cpu")


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------

# lengths and budgets on 2 slots: budgets that carry a request past the
# ring's 32 rows, slots that free and refill mid-run
GEMMA_REQS = [(6, 30), (9, 5), (20, 18), (3, 12)]


def _requests(cfg, seed, shape, patches=False):
    rng = np.random.default_rng(seed)
    out = []
    for length, budget in shape:
        px = (rng.standard_normal((cfg.vision.num_tokens,
                                   cfg.vision.embed_dim), dtype=np.float32)
              if patches else None)
        out.append((rng.integers(0, cfg.vocab_size, length, dtype=np.int32),
                    budget, px))
    return out


def _run(engine_cls, req_cls, cfg, opts, params, reqs, **kw):
    eng = engine_cls(cfg, opts, params, n_slots=2, max_seq=64, eos=-999,
                     tick_tokens=4, **kw)
    for i, (prompt, m, px) in enumerate(reqs):
        eng.submit(req_cls(uid=i, prompt=prompt.copy(), max_tokens=m,
                           patches=px))
    done = eng.run()
    assert len(done) == len(reqs)
    return {r.uid: r.out_tokens for r in done}, eng.stats


def _same_runs(name, reqs, opts, **kw):
    jcfg, jparams, tcfg, tparams = bridge(name)
    pt, ps = _run(ServingEngine, Request, tcfg, TL.ModelOptions(**opts),
                  tparams, reqs, device="cpu", **kw)
    rt, rs = _run(JEngine, JReq, jcfg, JL.ModelOptions(remat=False, **opts),
                  jparams, reqs, **kw)
    assert pt == rt
    for f in ("device_steps", "ticks", "decode_syncs", "tokens_decoded",
              "prefix_hits", "pages_hwm", "pages_in_use"):
        assert getattr(ps, f) == getattr(rs, f), f
    return pt


@pytest.mark.parametrize("case", ["ring-fused", "ring-per-token", "dense",
                                  "paged"])
def test_gemma_engine_matches_reference(case):
    """The windowed engine: ring caches fused and per-token, and full
    caches, dense and paged; requests decode past the ring's 32 rows."""
    _, _, tcfg, _ = bridge(GEMMA)
    reqs = _requests(tcfg, 5, GEMMA_REQS)
    kw = {"ring-fused": {}, "ring-per-token": dict(fused=False),
          "dense": {}, "paged": dict(paged=True, page_size=8)}[case]
    streams = _same_runs(GEMMA, reqs, RING if case.startswith("ring")
                         else {}, **kw)
    assert max(7 + len(s) for s in streams.values()) > 32


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("name", ["granite-3-2b", "internvl2-1b"])
def test_engine_matches_reference(name, layout):
    """granite-3-2b, and internvl2-1b with a vision prefix on every
    request, fused, through the dense cache and a paged pool."""
    _, _, tcfg, _ = bridge(name)
    reqs = _requests(tcfg, 6, [(5, 6), (8, 9), (3, 4)],
                     patches=tcfg.vision is not None)
    _same_runs(name, reqs, {},
               **(dict(paged=True, page_size=8) if layout == "paged"
                  else {}))


@pytest.mark.parametrize("kw,match", [
    (dict(paged=True, page_size=8), "mutually exclusive"),
    (dict(chunked_prefill=True, chunk_size=8), "positioned prefill"),
    (dict(spec_decode=True), "positioned chunk writes")])
def test_ring_caches_refuse_paged_chunked_and_speculative(kw, match):
    """As in the reference engine, which raises the same reasons."""
    jcfg, jparams, tcfg, tparams = bridge(GEMMA)
    with pytest.raises(ValueError, match=match):
        ServingEngine(tcfg, TL.ModelOptions(**RING), tparams, max_seq=64,
                      device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        JEngine(jcfg, JL.ModelOptions(remat=False, **RING), jparams,
                max_seq=64, **kw)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-small"])
def test_serve_driver(arch, capsys):
    """``python -m repro_torch.launch.serve --reduced --device cpu``:
    granite-3-2b serves to its summary line (the driver's ``main``, in
    this process); whisper-small, as its own process, exits at once with
    the engine's encoder-decoder refusal, not a traceback."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--requests",
            "3", "--max-tokens", "4"]
    if arch == "granite-3-2b":
        serve.main(argv)
        assert "[serve] 3 requests, 12 tokens" in capsys.readouterr().out
        return
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve"] + argv,
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 2
    assert "a Request carries no frames" in out.stderr
    assert "Traceback" not in out.stderr
