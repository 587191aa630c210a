"""whisper-small, the encoder-decoder, in the port against the JAX
reference, on its reduced form (encoder of 2 layers over 24 frames).

Weights come from the reference through ``from_jax``; tokens and frames
are made with numpy from seeds. Tolerances are ``tests/test_torch_model.
py``'s: the encoder tower within 1e-5, logits within 1e-4 (f32 weights;
the two frameworks sum in other orders), greedy streams equal. The
decoder's cross-attention K/V are computed from the encoder's output at
prefill and cached beside the self-attention's (``xk``/``xv``, batched by
slot in the dense and paged layouts, as in the reference); decode reads
them from the cache. Positioned and chunked prefill refuse the model, as
the reference does; the serving engine refuses it at construction (a
request carries no frames), where the reference's fails at admission.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import stacks as JS
from repro.serving import Request as JReq
from repro.serving import ServingEngine as JEngine
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models import stacks as TS
from repro_torch.serving import ServingEngine

NAME = "whisper-small"
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
_BRIDGE = []


def bridge():
    if not _BRIDGE:
        jcfg, jparams = reduced_params(NAME)
        tcfg = get_config(NAME).reduced()
        _BRIDGE.append((jcfg, jparams, tcfg, TP.from_jax(
            TM.model_template(tcfg), jax.tree.map(np.asarray, jparams),
            device="cpu")))
    return _BRIDGE[0]


def _batch(cfg, seed, B=2, S=4):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "frames": rng.standard_normal(
                (B, cfg.encoder.num_tokens, cfg.encoder.embed_dim),
                dtype=np.float32)}


def test_encoder_tower_matches_reference():
    jcfg, jparams, tcfg, tparams = bridge()
    frames = _batch(tcfg, 0)["frames"]
    got = TS.apply_tower(tparams["encoder"], torch.from_numpy(frames),
                         tcfg.encoder)
    want = JS.apply_tower(jparams["encoder"], jnp.asarray(frames),
                          jcfg.encoder, JL.ModelOptions())
    assert got.shape == (2, 24, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_forward_prefill_decode_match_reference():
    """forward, prefill (self-attention cached, cross K/V cached) and three
    decode steps reading the cached cross K/V, within 1e-4."""
    jcfg, jparams, tcfg, tparams = bridge()
    jo, to = JL.ModelOptions(remat=False), TL.ModelOptions()
    batch = _batch(tcfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    np.testing.assert_allclose(
        TM.forward(tcfg, to, tparams, batch, device="cpu").numpy(),
        np.asarray(JM.forward(jcfg, jo, jparams, jb)), **LOGIT_TOL)
    jl, jc = JM.prefill(jcfg, jo, jparams, jb, 32, cache_dtype=jnp.float32)
    tl, tc = TM.prefill(tcfg, to, tparams, batch, 32,
                        cache_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(tc["blocks"]["sub0"]["xk"].numpy(),
                               np.asarray(jc["blocks"]["sub0"]["xk"]), **TOL)
    xk = tc["blocks"]["sub0"]["xk"]
    ptr = xk.data_ptr()
    step = jax.jit(functools.partial(JM.decode_step, jcfg, jo))
    for i in range(3):
        tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
        jl, jc = step(jparams, jnp.asarray(tok), jc, 4 + i)
        tl, tc = TM.decode_step(tcfg, to, tparams, tok, tc, 4 + i,
                                device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert tc["blocks"]["sub0"]["xk"].data_ptr() == ptr


def test_bf16_prefill_keeps_the_cross_kv_unrounded():
    """With the default bf16 cache the reference caches the cross K/V as
    computed (f32 here); so does the port, while the self-attention rows
    are bf16 in both."""
    jcfg, jparams, tcfg, tparams = bridge()
    batch = _batch(tcfg, 2, B=1)
    jl, jc = JM.prefill(jcfg, JL.ModelOptions(remat=False), jparams,
                        {k: jnp.asarray(v) for k, v in batch.items()}, 16)
    tl, tc = TM.prefill(tcfg, TL.ModelOptions(), tparams, batch, 16,
                        device="cpu")
    sub = tc["blocks"]["sub0"]
    assert (sub["xk"].dtype, sub["k"].dtype) == (torch.float32,
                                                 torch.bfloat16)
    assert jc["blocks"]["sub0"]["xk"].dtype == jnp.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


def test_decode_loop_and_graph_runner_match_reference():
    """Greedy ``decode_loop`` (12 steps) equals the reference's; so does a
    ``DecodeGraph`` runner reused for two calls of 6 steps (on the CPU its
    step runs eagerly on the same buffers)."""
    jcfg, jparams, tcfg, tparams = bridge()
    jo, to = JL.ModelOptions(remat=False), TL.ModelOptions()
    batch = _batch(tcfg, 3)
    jl, jc = JM.prefill(jcfg, jo, jparams,
                        {k: jnp.asarray(v) for k, v in batch.items()}, 32,
                        cache_dtype=jnp.float32)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1), np.int32)[:, None]
    want, _, _ = JM.decode_loop(jcfg, jo, jparams, jnp.asarray(tok), jc, 4,
                                12)
    want = np.asarray(want)
    _, tc = TM.prefill(tcfg, to, tparams, batch, 32,
                       cache_dtype=torch.float32, device="cpu")
    got, _, _ = TM.decode_loop(tcfg, to, tparams, tok, tc, 4, 12,
                               device="cpu")
    assert np.array_equal(got.numpy(), want)
    _, tc = TM.prefill(tcfg, to, tparams, batch, 32,
                       cache_dtype=torch.float32, device="cpu")
    graph = TM.DecodeGraph("cpu")
    first, last, _ = TM.decode_loop(tcfg, to, tparams, tok, tc, 4, 6,
                                    device="cpu", graph=graph)
    second, _, _ = TM.decode_loop(tcfg, to, tparams, last, tc, 10, 6,
                                  device="cpu", graph=graph)
    assert np.array_equal(torch.cat([first, second], 1).numpy(), want)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_cache_template_matches_reference(layout):
    """Self-attention K/V in the layout's shape; the cross K/V [B, 24, K,
    h] batched by slot in both layouts, leaf for leaf the reference's."""
    jcfg, _, tcfg, _ = bridge()
    kw = dict(paged=True, num_pages=9, page_size=8) if layout == "paged" \
        else {}
    port = {p: s.shape for p, s in TP.leaves(
        TS.cache_template(tcfg, 3, 32, **kw))}
    ref = JS.cache_template(jcfg, 3, 32, jnp.float32, JL.ModelOptions(),
                            **kw)
    ref = {"/".join(k.key for k in path): tuple(s.shape)
           for path, s in jax.tree_util.tree_flatten_with_path(
               ref, is_leaf=lambda x: hasattr(x, "axes"))[0]}
    assert port == ref
    assert port["blocks/sub0/xk"] == (4, 3, 24, 2, 16)   # 4 layers


def test_positioned_and_chunked_prefill_refuse():
    """As in the reference: the cross-attention context is whole-sequence
    state."""
    _, _, tcfg, tparams = bridge()
    opts = TL.ModelOptions()
    batch = _batch(tcfg, 4, B=1)
    caches = TM.init_caches(tcfg, 1, 32, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="positioned prefill is "
                                         "tokens-only"):
        TM.prefill(tcfg, opts, tparams, {"tokens": batch["tokens"]}, 32,
                   caches=caches, cache_index=4, device="cpu")
    with pytest.raises(ValueError, match="chunked prefill does not support "
                                         "encoder-decoder"):
        TM.embed_prompt(tcfg, opts, tparams, batch, device="cpu")


def test_engine_refuses_at_construction():
    """The port's engine names the reason at construction; the
    reference's takes the config and fails at the first admission."""
    jcfg, jparams, tcfg, tparams = bridge()
    with pytest.raises(ValueError, match="a Request carries no frames"):
        ServingEngine(tcfg, TL.ModelOptions(), tparams, device="cpu")
    ref = JEngine(jcfg, JL.ModelOptions(remat=False), jparams, max_seq=32)
    ref.submit(JReq(uid=0, prompt=np.arange(4, dtype=np.int32),
                    max_tokens=3))
    with pytest.raises(KeyError, match="frames"):
        ref.run()
