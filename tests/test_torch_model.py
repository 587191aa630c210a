"""The port's parameter bridge, layers and models against the JAX reference.

Weights come from the reference (``conftest.reduced_params``) through
``from_jax``; other inputs are made with numpy from a seed and handed to
both frameworks. Layer outputs agree within f32 tolerance (1e-5; the two
frameworks sum in other orders). Model logits agree within 1e-4: the
caches are bf16, and a key whose f32 value differs in its last bits can
round to a neighbouring bf16 value. Greedy streams are equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.core import vla as tvla
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.serving import ServingEngine

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def bridge(name):
    """(JAX cfg, JAX params, port cfg, port params on the CPU)."""
    jcfg, jparams = reduced_params(name)
    tcfg = get_config(name).reduced()
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, TP.from_jax(TM.model_template(tcfg), tree,
                                            device="cpu")


@pytest.mark.parametrize("name", ["smollm-135m", "qwen1.5-0.5b",
                                  "molmoact-7b", "granite-3-2b",
                                  "internvl2-1b", "gemma3-27b",
                                  "whisper-small"])
def test_from_jax_round_trip(name):
    jcfg, jparams, tcfg, tparams = bridge(name)
    jleaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tleaves = dict(TP.leaves(tparams))
    assert len(jleaves) == len(tleaves)
    for path, leaf in jleaves:
        key = "/".join(p.key for p in path)
        np.testing.assert_array_equal(tleaves[key].numpy(), np.asarray(leaf))
    assert TP.param_count(TM.model_template(tcfg)) == sum(
        int(np.prod(l.shape)) for _, l in jleaves)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_from_jax_rejects_mismatched_trees(fault):
    _, jparams, tcfg, _ = bridge("smollm-135m")
    tree = jax.tree.map(np.asarray, jparams)
    if fault == "missing":
        del tree["final_norm_w"]
    elif fault == "extra":
        tree["unused"] = np.zeros(3, np.float32)
    else:
        tree["embed"] = tree["embed"][:-1]
    with pytest.raises((KeyError, ValueError)):
        TP.from_jax(TM.model_template(tcfg), tree, device="cpu")


def test_init_params_is_seeded_and_shaped():
    cfg = get_config("molmoact-7b").reduced()
    a = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    tmpl = dict(TP.leaves(TM.model_template(cfg)))
    for path, t in TP.leaves(a):
        assert tuple(t.shape) == tmpl[path].shape
        assert torch.equal(t, dict(TP.leaves(b))[path])
    wq = a["decoder"]["blocks"]["sub0"]["wq"]
    assert abs(wq.std().item() - cfg.d_model ** -0.5) < 0.02
    assert torch.equal(a["decoder"]["blocks"]["sub0"]["bq"],
                       torch.zeros_like(a["decoder"]["blocks"]["sub0"]["bq"]))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def test_norms_rope_mlp_match_reference():
    x, w, b = _rand(0, 2, 5, 64), _rand(1, 64), _rand(2, 64)
    np.testing.assert_allclose(
        TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    np.testing.assert_allclose(
        TL.layer_norm(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(JL.layer_norm(*map(jnp.asarray, (x, w, b)))), **TOL)
    xh = _rand(3, 2, 5, 4, 16)
    pos = np.arange(5)[None].repeat(2, 0) + np.array([[0], [700]])
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(xh), torch.from_numpy(pos), 1e6).numpy(),
        np.asarray(JL.rope(jnp.asarray(xh), jnp.asarray(pos), 1e6)),
        atol=1e-4, rtol=1e-5)   # angles up to 700 rad: f32 sin/cos differ
    jcfg, jparams, tcfg, tparams = bridge("molmoact-7b")
    jp = jax.tree.map(lambda l: l[1], jparams["decoder"]["blocks"]["sub0"])
    tp = {k: v[1] for k, v in tparams["decoder"]["blocks"]["sub0"].items()}
    np.testing.assert_allclose(
        TL.mlp(tp, torch.from_numpy(x), tcfg).numpy(),
        np.asarray(JL.mlp(jp, jnp.asarray(x), jcfg)), **TOL)


@pytest.mark.parametrize("mode", ["fresh", "chunk", "decode"])
def test_attention_layer_matches_reference(mode):
    """One attention sub-layer (projections, RoPE, cache write, routed core)
    against the reference, for the three routes the slice runs."""
    jcfg, jparams, tcfg, tparams = bridge("molmoact-7b")
    jp = jax.tree.map(lambda l: l[0], jparams["decoder"]["blocks"]["sub0"])
    tp = {k: v[0] for k, v in tparams["decoder"]["blocks"]["sub0"].items()}
    B, smax = 2, 40
    S = {"fresh": smax, "chunk": 12, "decode": 1}[mode]
    start = 9 if mode == "decode" else 0
    x = _rand(4, B, S, tcfg.d_model)
    pos = np.broadcast_to(np.arange(start, start + S), (B, S))
    kc = _rand(5, B, smax, tcfg.num_kv_heads, tcfg.head_dim)
    vc = _rand(6, B, smax, tcfg.num_kv_heads, tcfg.head_dim)
    jout, (jk, jv) = JL.attention(
        jp, jnp.asarray(x), jcfg, JL.ModelOptions(), 0, jnp.asarray(pos),
        cache=(jnp.asarray(kc, jnp.bfloat16), jnp.asarray(vc, jnp.bfloat16)),
        cache_index=start)
    tk = torch.from_numpy(kc).bfloat16()
    tv = torch.from_numpy(vc).bfloat16()
    tout, _ = TL.attention(tp, torch.from_numpy(x), tcfg, TL.ModelOptions(),
                           0, torch.from_numpy(pos.copy()), cache=(tk, tv),
                           cache_index=start)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **LOGIT_TOL)
    np.testing.assert_allclose(tk.float().numpy(),
                               np.asarray(jk, np.float32), atol=1e-2)
    np.testing.assert_allclose(tv.float().numpy(),
                               np.asarray(jv, np.float32), atol=1e-2)


def test_cache_writes_match_reference():
    cache = _rand(7, 2, 10, 2, 16)
    new = _rand(8, 2, 3, 2, 16)
    for index in (4, (1, 7)):
        jidx = jnp.asarray(index, jnp.int32)
        jc = JL.update_cache_chunk(jnp.asarray(cache), jnp.asarray(new), jidx)
        tc = TL.update_cache_chunk(torch.from_numpy(cache.copy()),
                                   torch.from_numpy(new), torch.tensor(index))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jc = JL.update_cache(jnp.asarray(cache), jnp.asarray(new), 4)
    tc = TL.update_cache(torch.from_numpy(cache.copy()),
                         torch.from_numpy(new), 4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_routes():
    opts = TL.ModelOptions()
    route = TL.attention_route
    assert route("decode", "dense", S=1, Skv=1, window=0,
                 opts=opts) == "decode_flash"
    assert route("chunk", "dense", S=640, Skv=640, window=0,
                 opts=opts) == "chunk_flash"
    assert route("fresh", "none", S=576, Skv=576, window=0, opts=opts,
                 causal=False) == "fresh_dense"
    assert route("fresh", "none", S=4096, Skv=4096, window=0,
                 opts=opts) == "fresh_flash"
    assert route("decode", "paged", S=1, Skv=1, window=0,
                 opts=opts) == "decode_paged_flash"
    assert route("chunk", "paged", S=8, Skv=8, window=0,
                 opts=opts) == "chunk_paged_flash"
    with pytest.raises(NotImplementedError):
        route("fresh", "paged", S=8, Skv=8, window=0, opts=opts)
    # a ring cache (window_cache): decode over the ring, prefill as fresh
    # rows; the encoder context (cross): the decode kernel for one query
    # row, the reference's fresh routes (never causal) for more
    assert route("decode", "ring", S=1, Skv=1, window=1024,
                 opts=opts) == "decode_ring"
    assert route("fresh", "ring", S=1024, Skv=1024, window=1024,
                 opts=opts) == "fresh_flash"
    assert route("fresh", "ring", S=300, Skv=300, window=1024,
                 opts=opts) == "fresh_dense"
    with pytest.raises(ValueError, match="ring"):
        route("chunk", "ring", S=8, Skv=8, window=32, opts=opts)
    assert route("cross", "none", S=1, Skv=1500, window=0, opts=opts,
                 causal=False) == "decode_cross"
    assert route("cross", "none", S=4, Skv=1500, window=0, opts=opts,
                 causal=False) == "fresh_dense"
    assert TL.band_len(640, 32, 833) == 640
    assert TL.band_len(641, 32, 833) == 672
    assert TL.band_len(833, 32, 833) == 833
    assert TL.live_bound((3, 9), 20) == 9 and TL.live_bound(None, 20) == 20


@pytest.mark.parametrize("name", ["smollm-135m", "qwen1.5-0.5b"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_prefill_and_decode_loop_match_reference(name, use_pallas):
    jcfg, jparams, tcfg, tparams = bridge(name)
    jopts = JL.ModelOptions(remat=False, use_pallas=use_pallas,
                            pallas_interpret=True)
    tokens = np.random.default_rng(9).integers(0, tcfg.vocab_size, (2, 7))
    max_seq = 7 + 6 + 3
    jl, jc = JM.prefill(jcfg, jopts, jparams, {"tokens": jnp.asarray(tokens)},
                        max_seq)
    tl, tc = TM.prefill(tcfg, TL.ModelOptions(), tparams, {"tokens": tokens},
                        max_seq, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].argmax(-1, keepdim=True)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))
    jtoks, _, _ = JM.decode_loop(jcfg, jopts, jparams, jtok, jc, 7, 6)
    ttoks, _, _ = TM.decode_loop(tcfg, TL.ModelOptions(), tparams, ttok, tc,
                                 7, 6, device="cpu")
    assert np.array_equal(ttoks.numpy(), np.asarray(jtoks))


def test_forward_matches_reference():
    jcfg, jparams, tcfg, tparams = bridge("smollm-135m")
    tokens = np.random.default_rng(10).integers(0, tcfg.vocab_size, (2, 9))
    jl = JM.forward(jcfg, JL.ModelOptions(remat=False), jparams,
                    {"tokens": jnp.asarray(tokens)})
    tl = TM.forward(tcfg, TL.ModelOptions(), tparams, {"tokens": tokens},
                    device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_decode_step_per_slot_index():
    """A per-slot [B] index decodes each slot at its own position, as the
    reference does."""
    jcfg, jparams, tcfg, tparams = bridge("smollm-135m")
    tokens = np.random.default_rng(11).integers(0, tcfg.vocab_size, (2, 8))
    jopts = JL.ModelOptions(remat=False)
    _, jc = JM.prefill(jcfg, jopts, jparams, {"tokens": jnp.asarray(tokens)},
                       12)
    _, tc = TM.prefill(tcfg, TL.ModelOptions(), tparams, {"tokens": tokens},
                       12, device="cpu")
    tok, idx = np.array([[3], [5]]), np.array([6, 8], np.int32)
    jl, _ = JM.decode_step(jcfg, jopts, jparams, jnp.asarray(tok), jc,
                           jnp.asarray(idx))
    tl, _ = TM.decode_step(tcfg, TL.ModelOptions(), tparams, tok, tc,
                           torch.from_numpy(idx), device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


ENTRY_POINTS = {
    "init_params": lambda cfg: TM.init_params(cfg, torch.Generator()),
    "init_caches": lambda cfg: TM.init_caches(cfg, 1, 8),
    "prefill": lambda cfg: TM.prefill(cfg, TL.ModelOptions(), {}, {}, 8),
    "decode_step": lambda cfg: TM.decode_step(cfg, TL.ModelOptions(), {},
                                              [[0]], {}, 0),
    "decode_loop": lambda cfg: TM.decode_loop(cfg, TL.ModelOptions(), {},
                                              [[0]], {}, 0, 1),
    "encode_vision": lambda cfg: TM.encode_vision(cfg, TL.ModelOptions(), {},
                                                  None),
    "forward": lambda cfg: TM.forward(cfg, TL.ModelOptions(), {}, {}),
    "vla_control_step": lambda cfg: tvla.vla_control_step(
        cfg, TL.ModelOptions(), {}, {"tokens": [[0]]}),
    "ServingEngine": lambda cfg: ServingEngine(cfg, TL.ModelOptions(), {}),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_needs_a_card(entry, monkeypatch):
    """Every entry point defaults to the card and raises without one; it
    never falls back to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("molmoact-7b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry](cfg)
