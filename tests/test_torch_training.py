"""The port's training slice against the JAX reference: the flash-attention
kernel's plain version and its backward, the fresh attention routes and
cores, AdamW, gradient compression, the train step, the data pipeline,
checkpoints (read across the two packages), the resilient loop and the
training entry point.

Inputs are made with numpy from seeds and handed to both frameworks;
weights of the reduced configs come from the reference through
``from_jax``. Tolerances (f32 unless said):

- attention outputs against the reference's oracle and the Pallas kernel
  in interpret mode: ``atol=rtol=2e-5`` (f32) and ``2e-2`` (bf16), the
  reference kernel tests' own;
- the plain fresh cores (flash-ref, both schedules; banded) within 1e-5:
  the same terms summed in another order;
- ``FlashAttention``'s backward against autograd through ``attention_ref``
  within 1e-5 x max|grad| (f32; the written-out gradient sums in another
  order);
- loss within 1e-5 relative; gradients within 1e-5 x max|g| per leaf;
- updated parameters within 1e-4 x lr (plus two f32 ulps of the
  parameter) where |g| > 1e-2 x max|g| of its leaf, well above AdamW's
  eps = 1e-8 and the gradients' own error (1e-5 x max|g|): the first
  step moves a parameter by about lr * g / (|g| + eps), so a gradient
  near eps whose last bits differ between the frameworks moves by up to
  lr, and under int8 compression a code one step apart does the same;
  those entries (and codes within 1e-3 of a tie) are held only to
  2 x lr;
- data arrays and checkpoint leaves bit-equal.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.checkpoint import restore as jrestore
from repro.checkpoint import save as jsave
from repro.data import lm_batches as jlm_batches
from repro.data import vla_batches as jvla_batches
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import ref as jfref
from repro.models import layers as JL
from repro.models import model as JM
from repro.training import AdamWConfig as JAdamW
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as jinit_train_state
from repro.training import lm_loss as jlm_loss
from repro.training import make_train_step as jmake_train_step
from repro.training import compress as jcompress
from repro.training import optimizer as jopt
from repro_torch.checkpoint import (ResilientLoop, StepFailure, latest_step,
                                    restore, save)
from repro_torch.configs import get_config
from repro_torch.data import Prefetcher, lm_batches, vla_batches
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.training import (AdamWConfig, TrainConfig, init_train_state,
                                  lm_loss, make_train_step)
from repro_torch.training import compress, optimizer
from repro_torch.training.train_step import train_state_from_jax
from test_torch_serving import port_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOL, MOLMO, QWEN = "smollm-135m", "molmoact-7b", "qwen1.5-0.5b"
JOPTS = JL.ModelOptions(remat=False)


def _np(t):
    return np.asarray(t, np.float32)


def _tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16"
            else dict(atol=2e-5, rtol=2e-5))


def _qkv(seed, B, S, N, K, h, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sk or S
    return (rng.standard_normal((B, S, N, h)).astype(np.float32),
            rng.standard_normal((B, Sk, K, h)).astype(np.float32),
            rng.standard_normal((B, Sk, K, h)).astype(np.float32))


def _both(arrays, dtype):
    j = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


# ---------------------------------------------------------------------------
# the kernel's plain version and its backward
# ---------------------------------------------------------------------------

# the reference's test_kernels.py shapes
FLASH_SHAPES = [(2, 256, 4, 2, 64), (1, 256, 8, 8, 64), (2, 128, 6, 2, 32),
                (1, 512, 4, 1, 128), (2, 256, 16, 4, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("B,S,N,K,h", FLASH_SHAPES)
def test_attention_ref_matches_reference_oracle(B, S, N, K, h, window,
                                                dtype):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S + N, B, S, N, K, h), dtype)
    want = jfref.attention_ref(jq, jk, jv, window=window)
    got = fa.attention_ref(tq, tk, tv, window)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got.float()), _np(want), **_tol(dtype))


# (B, S, N, K, h, window, causal): the reference shapes, a window, not
# causal, and one block (S = 128) with a window inside it
PALLAS_CASES = [(2, 256, 4, 2, 64, 0, True), (2, 128, 6, 2, 32, 0, True),
                (1, 512, 4, 1, 128, 128, True), (2, 256, 4, 2, 16, 0, False),
                (1, 128, 4, 2, 16, 48, True)]


@pytest.mark.parametrize("B,S,N,K,h,window,causal", PALLAS_CASES)
def test_flash_attention_cpu_matches_pallas_kernel(B, S, N, K, h, window,
                                                   causal):
    """On the CPU the wrapper runs the plain version, which must agree
    with the Pallas kernel in interpret mode."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S * 3 + h, B, S, N, K, h),
                                       "float32")
    want = jflash(jq, jk, jv, window=window, causal=causal, interpret=True)
    got = fa.flash_attention(tq, tk, tv, window=window, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **_tol("float32"))
    assert torch.equal(got, fa.attention_ref(tq, tk, tv, window, causal))


@pytest.mark.parametrize("B,S,N,K,h,window,causal", PALLAS_CASES)
def test_saved_log_sum_exp_matches_jax(B, S, N, K, h, window, causal):
    """The forward saves each row's natural log-sum-exp, [B,N,S] f32, for
    the backward: on the CPU it must equal ``jax.nn.logsumexp`` of the
    masked scores formed in JAX from the same numpy inputs (causal or not,
    with a window)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(S * 5 + h, B, S, N, K, h),
                                       "float32")
    out = fa.flash_attention(tq.requires_grad_(), tk, tv, window=window,
                             causal=causal)
    lse = out.grad_fn.saved_tensors[4]
    assert lse.dtype == torch.float32 and lse.shape == (B, N, S)
    kv = jnp.repeat(jk, N // K, axis=2)          # query head n reads n // G
    s = jnp.einsum("bsnh,btnh->bnst", jq, kv) / np.sqrt(h)
    qpos, kpos = jnp.arange(S)[:, None], jnp.arange(S)[None]
    live = jnp.ones((S, S), bool)
    if causal:
        live &= qpos >= kpos
    if window:
        live &= qpos - kpos < window
    want = jax.nn.logsumexp(jnp.where(live, s, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse.detach().numpy(), _np(want),
                               **_tol("float32"))


def test_flash_attention_refuses_partial_blocks():
    """Past 128 rows the kernel takes whole 128-row blocks (the reference
    leaves the tail rows unwritten): S or Sk of 320 is refused, on the CPU
    too; S <= 128 of any length is taken."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 320, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="keys"):
        fa.flash_attention(q[:, :256], k, v)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention(q[:, :128], k[:, :128, :, :8], v[:, :128, :, :8])
    out = fa.flash_attention(q[:, :100], k[:, :100], v[:, :100])
    assert out.shape == (1, 100, 4, 16)
    assert fa.flash_attention.launches == 0      # no kernel on the CPU


@pytest.mark.parametrize("S,Sk,window,causal",
                         [(256, 256, 0, True), (256, 256, 96, True),
                          (128, 128, 0, False), (256, 128, 0, True)])
def test_flash_backward_matches_autograd(S, Sk, window, causal):
    """``FlashAttention``'s written-out gradient (from the saved
    log-sum-exp) against autograd through ``attention_ref``, with GQA
    sums over G = 3 query heads per KV head."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(S + window, 2, S, 6, 2, 16, Sk))
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, S, 6, 16)).astype(np.float32))
    got = torch.autograd.grad(
        fa.flash_attention(q, k, v, window=window, causal=causal),
        (q, k, v), dout)
    want = torch.autograd.grad(fa.attention_ref(q, k, v, window, causal),
                               (q, k, v), dout)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()))


# ---------------------------------------------------------------------------
# routes and the plain fresh cores
# ---------------------------------------------------------------------------

# (S, Skv, window, causal, dense_attn_threshold, attn_chunk)
ROUTE_CASES = [(256, 256, 0, True, 2048, 512), (100, 100, 0, True, 2048, 512),
               (128, 256, 0, True, 2048, 512), (256, 256, 0, False, 2048, 512),
               (4096, 4096, 0, True, 2048, 512),
               (320, 320, 0, True, 256, 64), (320, 320, 64, True, 256, 64),
               (320, 320, 200, True, 256, 64), (320, 320, 0, False, 256, 64),
               (300, 300, 0, True, 256, 64), (4000, 4096, 0, True, 2048, 512),
               (4000, 4096, 512, True, 2048, 512)]


@pytest.mark.parametrize("S,Skv,window,causal,thr,chunk", ROUTE_CASES)
def test_fresh_routes_match_reference(S, Skv, window, causal, thr, chunk):
    """The fresh branch picks the reference's route (the reference with
    use_pallas=True: the port's device decides kernel or plain)."""
    got = TL.attention_route(
        "fresh", "none", S=S, Skv=Skv, window=window, causal=causal,
        opts=TL.ModelOptions(dense_attn_threshold=thr, attn_chunk=chunk))
    want = JL.attention_route(
        "fresh", "none", S=S, Skv=Skv, window=window, causal=causal,
        opts=JL.ModelOptions(dense_attn_threshold=thr, attn_chunk=chunk,
                             use_pallas=True))
    assert got == want


@pytest.mark.parametrize("window,causal_pairs,route",
                         [(0, False, "fresh_flash_ref"),
                          (0, True, "fresh_flash_ref"),
                          (200, False, "fresh_flash_ref"),
                          (200, True, "fresh_flash_ref"),
                          (64, False, "fresh_banded")])
def test_fresh_cores_match_reference(window, causal_pairs, route):
    """The attention sub-layer at S=320 with dense_attn_threshold=256 and
    attn_chunk=64 reaches the plain flash core (both schedules) or the
    banded one, in both packages."""
    name = SMOL
    jcfg, jparams = reduced_params(name)
    cfg, params = port_params(name)
    kw = dict(dense_attn_threshold=256, attn_chunk=64,
              causal_pairs=causal_pairs)
    topts, jopts = TL.ModelOptions(**kw), JL.ModelOptions(remat=False, **kw)
    S = 320
    assert TL.attention_route("fresh", "none", S=S, Skv=S, window=window,
                              opts=topts) == route
    x = np.random.default_rng(window + 1).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (2, S))
    jp = jax.tree.map(lambda a: a[0], jparams["decoder"]["blocks"]["sub0"])
    tp = TP.map_tree(lambda t: t[0], params["decoder"]["blocks"]["sub0"])
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, jopts, window,
                           jnp.asarray(pos))
    got, _ = TL.attention(tp, torch.from_numpy(x), cfg, topts, window,
                          torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_forward_takes_the_flash_route_at_whole_blocks():
    """A 256-row forward goes through ``FlashAttention`` (the plain
    version on the CPU) and matches the reference's dense forward."""
    jcfg, jparams = reduced_params(QWEN)
    cfg, params = port_params(QWEN)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 256))
    calls = []
    orig = fa.FlashAttention.forward

    def counted(ctx, *a):
        calls.append(a[0].shape)
        return orig(ctx, *a)
    fa.FlashAttention.forward = staticmethod(counted)
    try:
        got = TM.forward(cfg, TL.ModelOptions(), params, {"tokens": tokens},
                         device="cpu")
    finally:
        fa.FlashAttention.forward = staticmethod(orig)
    assert len(calls) == cfg.num_layers
    want = JM.forward(jcfg, JOPTS, jparams, {"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# optimizer and compression
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    jc = JAdamW(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    tc = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                     min_lr_ratio=0.1)
    for step in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        assert float(optimizer.lr_at(tc, step)) == pytest.approx(
            float(jopt.lr_at(jc, step)), rel=1e-6, abs=1e-12)
    assert float(optimizer.lr_at(tc, 0)) == 0.0
    assert float(optimizer.lr_at(tc, 100)) == pytest.approx(1e-4, rel=1e-3)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((8, 4)).astype(np.float32),
                  "b": rng.standard_normal(4).astype(np.float32)},
            "c": rng.standard_normal((3, 2, 5)).astype(np.float32)}


def _to_torch(tree):
    return TP.map_tree(lambda a: torch.from_numpy(np.array(a)), tree)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(moment_dtype):
    """Three AdamW steps with clipping (the first gradient's norm is past
    grad_clip), warmup and decay on two-dimensional leaves only."""
    jc = JAdamW(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0,
                moment_dtype=getattr(jnp, moment_dtype))
    tc = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0,
                     moment_dtype=getattr(torch, moment_dtype))
    jp = jax.tree.map(jnp.asarray, _tree(0))
    tp = _to_torch(_tree(0))
    js, ts = jopt.init_opt_state(jc, jp), optimizer.init_opt_state(tc, tp)
    for i in range(3):
        g = jax.tree.map(lambda a: a * (3.0 / (i + 1)), _tree(10 + i))
        jp, js, jm = jopt.adamw_update(jc, jax.tree.map(jnp.asarray, g),
                                       js, jp)
        tp, ts, tm = optimizer.adamw_update(tc, _to_torch(g), ts, tp)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert int(ts["count"]) == int(js["count"]) == i + 1
        for (path, a), (_, b) in zip(TP.leaves(jp), TP.leaves(tp)):
            np.testing.assert_allclose(b.numpy(), _np(a), atol=1e-6,
                                       rtol=1e-6, err_msg=path)
        for k in ("mu", "nu"):
            for (_, a), (_, b) in zip(TP.leaves(js[k]), TP.leaves(ts[k])):
                assert str(b.dtype) == f"torch.{moment_dtype}"
                np.testing.assert_allclose(b.float().numpy(), _np(a),
                                           rtol=1e-2 if moment_dtype ==
                                           "bfloat16" else 1e-6, atol=1e-9)


def test_global_norm_and_clip_contract():
    g = {"w": torch.full((4,), 100.0)}
    assert float(optimizer.global_norm(g)) == pytest.approx(200.0)
    t = _tree(4)
    assert float(optimizer.global_norm(_to_torch(t))) == pytest.approx(
        float(jopt.global_norm(jax.tree.map(jnp.asarray, t))), rel=1e-6)
    cfg = AdamWConfig(grad_clip=1.0)
    p = {"w": torch.zeros(4)}
    _, _, m = optimizer.adamw_update(cfg, g, optimizer.init_opt_state(cfg, p),
                                     p)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_compress_grads_matches_reference():
    """int8 codes (half to even), the dequantized gradients and the error
    state over five rounds of error feedback, bit for bit."""
    g = _tree(7)
    g["a"]["w"][0, :2] = [0.5, -2.5]         # ties at a scale of ~1/127
    je = jcompress.init_error_state(jax.tree.map(jnp.asarray, g))
    te = compress.init_error_state(_to_torch(g))
    for _ in range(5):
        jd, je = jcompress.compress_grads(jax.tree.map(jnp.asarray, g), je)
        td, te = compress.compress_grads(_to_torch(g), te)
        for tree_j, tree_t in ((jd, td), (je, te)):
            for (path, a), (_, b) in zip(TP.leaves(tree_j),
                                         TP.leaves(tree_t)):
                np.testing.assert_array_equal(b.numpy(), _np(a),
                                              err_msg=path)
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 127.0])
    q, s = compress.quantize_int8(x)
    jq, js = jcompress.quantize_int8(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))


def test_compression_error_feedback():
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=512)
                               .astype(np.float32))}
    e = compress.init_error_state(g)
    total = torch.zeros_like(g["w"])
    for _ in range(20):
        dq, e = compress.compress_grads(g, e)
        total += dq["w"]
    assert float((total - 20 * g["w"]).abs().max() / g["w"].abs().max()) \
        < 0.05


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

def _batch(cfg, seed, B, S, pad=False, patches=False):
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if pad:
        tok[1, S - 24:] = -1
        tok[0, S - 3:] = -1
    out = {"tokens": tok}
    if patches:
        out["patches"] = (0.1 * rng.standard_normal(
            (B, cfg.vision.num_tokens, cfg.vision.embed_dim))).astype(
                np.float32)
    return out


def _port_grads(cfg, params, batch, z_loss):
    live = TP.map_tree(lambda t: t.detach().requires_grad_(True), params)
    loss = lm_loss(cfg, TL.ModelOptions(), live, batch, z_loss,
                   device="cpu")
    grads = torch.autograd.grad(loss, [t for _, t in TP.leaves(live)])
    return float(loss.detach()), grads


def _assert_grads(jgrads, tgrads):
    for (path, a), b in zip(TP.leaves(jax.tree.map(np.asarray, jgrads)),
                            tgrads):
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-5 * float(np.abs(a).max()),
                                   err_msg=path)


def _ties(jgrads, jerror):
    """Entries whose int8 code could round either way: g + e within 1e-3
    of a half step of the leaf's scale (the reference's compression)."""
    def near(g, e):
        g32 = np.asarray(g, np.float32) + np.asarray(e, np.float32)
        r = np.abs(g32) / (np.abs(g32).max() / 127.0 + 1e-12)
        return np.abs(r - np.floor(r) - 0.5) < 1e-3
    return jax.tree.map(near, jgrads, jerror)


def _assert_params(jparams, tparams, jgrads, lr, ties=None):
    """Updated parameters, each entry allowed two f32 ulps of itself
    (p - lr * step rounds to p's grid) and: within 1e-4 x lr where |g| >
    1e-2 x max|g| of its leaf and its int8 code (with compression) is not
    a near tie; within 2 x lr elsewhere (a gradient near AdamW's eps, or a
    code one step apart, moves its parameter by up to about lr)."""
    ties = ties or jax.tree.map(lambda g: np.zeros(np.shape(g), bool),
                                jgrads)
    for (path, a), (_, b), (_, g), (_, t) in zip(
            TP.leaves(jax.tree.map(np.asarray, jparams)), TP.leaves(tparams),
            TP.leaves(jax.tree.map(np.asarray, jgrads)), TP.leaves(ties)):
        a = _np(a)
        d = np.abs(b.numpy() - a) - 2 * np.spacing(np.abs(a))
        sure = (np.abs(g) > 1e-2 * np.abs(g).max()) & ~t
        assert d[sure].max(initial=0) <= 1e-4 * lr, path
        assert d.max() <= 2 * lr, path


@pytest.mark.parametrize("name,pad,patches", [(SMOL, True, False),
                                              (MOLMO, False, True)])
def test_lm_loss_and_grads_match_reference(name, pad, patches):
    """One lm_loss (z-loss on) and its gradients at 128 positions, which
    the port runs through the flash route and the reference through dense
    attention: padded targets and the vision prefix are masked out."""
    jcfg, jparams = reduced_params(name)
    cfg, params = port_params(name)
    n_vis = cfg.vision.num_tokens if patches else 0
    batch = _batch(cfg, 11, 2, 128 - n_vis, pad=pad, patches=patches)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.value_and_grad(
        lambda p: jlm_loss(jcfg, JOPTS, p, jb, 1e-4))(jparams)
    tl, tg = _port_grads(cfg, params, batch, 1e-4)
    assert tl == pytest.approx(float(jl), rel=1e-5)
    _assert_grads(jg, tg)


# (name, microbatches, compress_grads, pad, patches)
STEP_CASES = [(SMOL, 1, False, True, False), (SMOL, 2, False, False, False),
              (SMOL, 1, True, False, False), (MOLMO, 2, True, False, True)]


@pytest.mark.parametrize("name,mb,comp,pad,patches", STEP_CASES)
def test_train_steps_match_reference(name, mb, comp, pad, patches):
    """Two train steps of each package: the first from fresh moments, the
    second from the reference's state after its first step, carried
    across (``train_state_from_jax``), so both start it from the same
    parameters and non-zero moments (and error state)."""
    jcfg, jparams = reduced_params(name)
    cfg, params = port_params(name)
    lr = 1e-3
    jt = JTrainConfig(opt=JAdamW(lr=lr, warmup_steps=0), microbatches=mb,
                      compress_grads=comp)
    tt = TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=0),
                     microbatches=mb, compress_grads=comp)
    jstep = jax.jit(jmake_train_step(jcfg, JOPTS, jt))
    tstep = make_train_step(cfg, TL.ModelOptions(), tt, device="cpu")
    n_vis = cfg.vision.num_tokens if patches else 0
    template = TM.model_template(cfg)
    jstate = jinit_train_state(jcfg, jt, jparams)
    tstate = init_train_state(cfg, tt, params)
    for seed in (21, 22):
        batch = _batch(cfg, seed, 4, 128 - n_vis, pad=pad, patches=patches)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        _, jg = jax.value_and_grad(
            lambda p: jlm_loss(jcfg, JOPTS, p, jb, jt.z_loss))(jparams)
        jp2, jstate2, jm = jstep(jparams, jstate, jb)
        tp2, tstate2, tm = tstep(params, tstate, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        _assert_params(jp2, tp2, jg, lr,
                       _ties(jg, jstate["error"]) if comp else None)
        assert set(tstate2) == set(jstate2)
        # carry the reference's state across for the next step
        jparams, jstate = jp2, jstate2
        params = TP.from_jax(template, jax.tree.map(np.asarray, jp2),
                             device="cpu")
        tstate = train_state_from_jax(
            template, jax.tree.map(np.asarray, jstate2), device="cpu")
    assert int(tstate["inner"]["count"]) == 2


def test_microbatching_matches_full_batch():
    cfg, params = port_params(SMOL)
    batch = _batch(cfg, 3, 4, 16)
    outs = []
    for mb in (1, 2):
        tc = TrainConfig(microbatches=mb, z_loss=0.0)
        outs.append(make_train_step(cfg, TL.ModelOptions(), tc,
                                    device="cpu")(
            params, init_train_state(cfg, tc, params), batch))
    (p1, _, m1), (p2, _, m2) = outs
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-4)
    assert max(float((a - b).abs().max()) for (_, a), (_, b)
               in zip(TP.leaves(p1), TP.leaves(p2))) < 1e-4


def test_loss_decreases_and_padding_is_finite():
    """The reference's test_training contracts inside the port."""
    cfg, params = port_params(QWEN)
    tcfg = TrainConfig(opt=AdamWConfig(lr=5e-3, warmup_steps=2,
                                       total_steps=30))
    step = make_train_step(cfg, TL.ModelOptions(), tcfg, device="cpu")
    state = init_train_state(cfg, tcfg, params)
    losses = []
    for b in lm_batches(cfg, 8, 32, steps=10, seed=1):
        params, state, m = step(params, state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))
    scfg, sparams = port_params(SMOL)
    padded = _batch(scfg, 0, 2, 12)["tokens"]
    padded[:, 8:] = -1
    assert np.isfinite(float(lm_loss(scfg, TL.ModelOptions(), sparams,
                                     {"tokens": padded}, device="cpu")))


def test_train_step_refuses_nothing_on_the_cpu_but_needs_a_device():
    """A MoE stack's step is built on the CPU, and the step's device is
    resolved up front (no card here: it raises)."""
    cfg, _ = port_params("granite-moe-3b-a800m")
    make_train_step(cfg, TL.ModelOptions(), TrainConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_train_step(cfg, TL.ModelOptions(), TrainConfig())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [SMOL, MOLMO])
def test_lm_batches_match_reference(name):
    cfg = get_config(name).reduced()
    jcfg, _ = reduced_params(name)
    for a, b in zip(lm_batches(cfg, 4, 16, seed=3, shard=1, num_shards=2,
                               steps=3),
                    jlm_batches(jcfg, 4, 16, seed=3, shard=1, num_shards=2,
                                steps=3)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_vla_batches_and_prefetcher_match_reference():
    cfg = get_config(MOLMO).reduced()
    jcfg, _ = reduced_params(MOLMO)
    got = list(Prefetcher(vla_batches(cfg, 3, seed=5, steps=3)))
    want = list(jvla_batches(jcfg, 3, seed=5, steps=3))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    with pytest.raises(ValueError, match="vision tower"):
        next(vla_batches(get_config(SMOL).reduced(), 2))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 4)).astype(np.float32)
    bf = rng.standard_normal((2, 3)).astype(np.float32)
    port = {"a": {"w": torch.from_numpy(w)},
            "b": [torch.arange(5, dtype=torch.int32),
                  torch.from_numpy(bf).bfloat16()],
            "count": torch.tensor(7, dtype=torch.int32)}
    ref = {"a": {"w": jnp.asarray(w)},
           "b": [jnp.arange(5, dtype=jnp.int32),
                 jnp.asarray(bf, jnp.bfloat16)],
           "count": jnp.asarray(7, jnp.int32)}
    return port, ref


def _assert_same_leaves(port, ref):
    flat_p = dict(TP.leaves({"t": {"a": port["a"], "b0": port["b"][0],
                                   "b1": port["b"][1],
                                   "count": port["count"]}}))
    flat_r = {"t/a/w": ref["a"]["w"], "t/b0": ref["b"][0],
              "t/b1": ref["b"][1], "t/count": ref["count"]}
    for k, v in flat_r.items():
        got = flat_p[k]
        want = np.asarray(v)
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
        else:
            assert str(got.dtype) == f"torch.{want.dtype}"
            np.testing.assert_array_equal(got.numpy(), want)


def test_port_checkpoint_restored_by_reference(tmp_path):
    port, ref = _ckpt_tree()
    save(str(tmp_path), 3, port)
    back = jrestore(str(tmp_path), 3, ref)
    _assert_same_leaves(port, back)


def test_reference_checkpoint_restored_by_port(tmp_path):
    port, ref = _ckpt_tree()
    jsave(str(tmp_path), 4, ref)
    back = restore(str(tmp_path), 4, port)
    _assert_same_leaves(back, ref)


def test_checkpoint_round_trip_async_latest_and_atomic(tmp_path):
    port, _ = _ckpt_tree()
    h = save(str(tmp_path), 1, port, async_=True)
    h.join()
    save(str(tmp_path), 2, port)
    assert latest_step(str(tmp_path)) == 2
    assert latest_step(str(tmp_path / "none")) is None
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    back = restore(str(tmp_path), 1, port)
    for (_, a), (_, b) in zip(TP.leaves({"x": port["a"]}),
                              TP.leaves({"x": back["a"]})):
        assert torch.equal(a, b)
    assert torch.equal(back["b"][1], port["b"][1])
    assert isinstance(back["b"], list)


def test_resilient_loop_recovers(tmp_path):
    fails = {5: 1, 11: 2}

    def hook(step):
        if fails.get(step, 0) > 0:
            fails[step] -= 1
            raise StepFailure(f"injected@{step}")

    loop = ResilientLoop(lambda st, s: {"x": st["x"] + 1}, str(tmp_path),
                         save_every=3, fault_hook=hook, async_save=False)
    state, _ = loop.run({"x": torch.tensor(0)}, 0, 20)
    assert loop.restores >= 1
    assert int(state["x"]) >= 18


def test_resilient_loop_gives_up(tmp_path):
    def hook(step):
        raise StepFailure("always")
    loop = ResilientLoop(lambda st, s: st, str(tmp_path), save_every=5,
                         fault_hook=hook, max_retries=2, async_save=False)
    with pytest.raises(StepFailure):
        loop.run({"x": torch.tensor(0)}, 0, 5)


def test_train_entry_point_with_checkpoints_and_a_failure(tmp_path):
    """``python -m repro_torch.launch.train`` on the CPU: an injected
    failure at step 6 restores step 4 and replays; a second run resumes
    from the last checkpoint."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", SMOL,
           "--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
           "--ckpt", str(tmp_path), "--save-every", "4", "--log-every", "3"]
    out = subprocess.run(cmd + ["--steps", "10", "--simulate-failure", "6"],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step 6 failed" in out.stderr + out.stdout
    assert "[train] restores=1" in out.stdout
    assert latest_step(str(tmp_path)) == 8
    again = subprocess.run(cmd + ["--steps", "12"], env=env,
                           capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr
    assert "resuming from step 8" in again.stdout
