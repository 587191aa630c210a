"""Training the MoE and Mamba2 families in the port against the JAX
reference: the gradients of ``gmm_gated`` / ``gmm_down`` (``GmmGated``,
``GmmDown``) and of ``ssd`` (``SSD``), ``lm_loss`` and its gradients for
reduced granite-moe-3b-a800m, arctic-480b, mamba2-780m and
jamba-1.5-large-398b, two train steps, layer remat and the in-place
(donated) update.

Inputs are made with numpy from seeds and handed to both frameworks;
weights of the reduced configs come from the reference through
``from_jax``. Tolerances (f32):

- the Functions' gradients within 1e-5 x max|g| of autograd through the
  plain versions and of ``jax.vjp`` through the reference's oracles (the
  same products, summed in another order; the chunked scan against the
  sequential one);
- loss within 1e-5 relative; gradients within 1e-5 x max|g| per leaf,
  jamba's within 2e-5 x max|g| (16 layers: a conv bias element of 320 is
  1.4e-6 off against the 1.2e-6 bar of 1e-5);
- updated parameters as in ``test_torch_training.py``.

The reference's own Mamba2 gradient is NaN at these inputs: its
``layers.ssd_chunked`` takes ``exp`` over the whole intra-chunk square and
masks it afterwards with ``where``, so the positive exponents above the
diagonal overflow and the ``where``'s gradient multiplies the ``inf`` by
0. The port masks before the exponential. So the Mamba2 comparisons swap
the reference's ``ssd_chunked`` for its sequential ``ssd_scan_ref`` for
the test only (``monkeypatch``), and one test pins the fault.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.kernels.moe_gmm import ref as jgmm_ref
from repro.models import layers as JL
from repro.training import AdamWConfig as JAdamW
from repro.training import TrainConfig as JTrainConfig
from repro.training import init_train_state as jinit_train_state
from repro.training import lm_loss as jlm_loss
from repro.training import make_train_step as jmake_train_step
from repro_torch.kernels.moe_gmm import ops as tgmm
from repro_torch.kernels.ssd import ops as tssd
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.training import (AdamWConfig, TrainConfig, init_train_state,
                                  lm_loss, make_train_step)
from repro_torch.training.train_step import train_state_from_jax
from test_torch_serving import port_params
from test_torch_training import _assert_params, _batch, _port_grads

GRANITE, ARCTIC = "granite-moe-3b-a800m", "arctic-480b"
MAMBA, JAMBA = "mamba2-780m", "jamba-1.5-large-398b"
JOPTS = JL.ModelOptions(remat=False)
# gradient bars, x max|g| of each leaf
GRAD_TOL = {GRANITE: 1e-5, ARCTIC: 1e-5, MAMBA: 1e-5, JAMBA: 2e-5}


def _np(t):
    return np.asarray(t, np.float32)


def _close_grads(got, want, tol=1e-5, what=""):
    for i, (a, b) in enumerate(zip(got, want)):
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, rtol=0,
                                   atol=tol * float(np.abs(b).max()),
                                   err_msg=f"{what} input {i}")


def _sequential_oracle(monkeypatch, name):
    """The reference's Mamba2 layers on its sequential scan (a finite
    gradient), for the test only."""
    if name in (MAMBA, JAMBA):
        monkeypatch.setattr(
            JL, "ssd_chunked",
            lambda xs, dt, A_log, B_, C_, *a, **k: JL.ssd_scan_ref(
                xs, dt, A_log, B_, C_))


# ---------------------------------------------------------------------------
# the Functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", sorted(tgmm.ACTS))
def test_gmm_backward_matches_autograd_and_jax(act):
    """``grouped_mlp`` through ``GmmGated`` and ``GmmDown`` (E=3, C=13,
    D=24, F=16, one slot of each expert a dropped, zero row): its
    vector-Jacobian product against autograd through the plain versions
    and ``jax.vjp`` through the reference's ``grouped_mlp_ref``
    (gelu_plain reads no wg: a zero gradient for it)."""
    rng = np.random.default_rng(5)
    E, C, D, F = 3, 13, 24, 16
    xe = rng.standard_normal((E, C, D)).astype(np.float32)
    xe[:, 4] = 0.0
    ws = [(rng.standard_normal(s) / np.sqrt(s[1])).astype(np.float32)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    dy = rng.standard_normal((E, C, D)).astype(np.float32)
    ins = [torch.from_numpy(a).requires_grad_() for a in (xe, *ws)]
    got = torch.autograd.grad(tgmm.grouped_mlp(*ins, act=act), ins,
                              torch.from_numpy(dy))
    plain = torch.autograd.grad(tgmm.grouped_mlp_ref(*ins, act=act), ins,
                                torch.from_numpy(dy), allow_unused=True,
                                materialize_grads=True)
    _, vjp = jax.vjp(lambda *a: jgmm_ref.grouped_mlp_ref(*a, act=act),
                     *map(jnp.asarray, (xe, *ws)))
    want = vjp(jnp.asarray(dy))
    _close_grads(got, plain, what=f"{act} vs autograd")
    _close_grads(got, want, what=f"{act} vs jax")
    if act == "gelu_plain":
        assert not got[2].any()


def test_gmm_backward_pads_a_ragged_capacity():
    """The weight gradients contract over C: on the card a C that is not
    a multiple of 8 is padded with zero rows there; on the CPU the same
    function runs unpadded. C = 1 and 7 against autograd through the plain
    versions."""
    rng = np.random.default_rng(6)
    for C in (1, 7):
        ins = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_() for s in ((2, C, 16), (2, 16, 8),
                                           (2, 16, 8), (2, 8, 16))]
        dy = torch.from_numpy(rng.standard_normal((2, C, 16)).astype(
            np.float32))
        got = torch.autograd.grad(tgmm.grouped_mlp(*ins), ins, dy)
        want = torch.autograd.grad(tgmm.grouped_mlp_ref(*ins), ins, dy)
        _close_grads(got, want, what=f"C={C}")


@pytest.mark.parametrize("S,Q", [(96, 32), (40, 128)])
def test_ssd_backward_matches_sequential_reference(S, Q):
    """``ssd`` through ``SSD`` (the chunked scan again under autograd)
    against ``jax.vjp`` through the reference's sequential
    ``ssd_scan_ref``, with cotangents on y and on the final state; three
    chunks, and one chunk shorter than Q."""
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 8, 8
    arrays = [rng.standard_normal((B, S, H, P)).astype(np.float32),
              np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(
                  np.float32),
              (1.5 * rng.random(H)).astype(np.float32),
              (0.3 * rng.standard_normal((B, S, 1, N))).astype(np.float32),
              (0.3 * rng.standard_normal((B, S, 1, N))).astype(np.float32)]
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, P, N)).astype(np.float32)
    ins = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, h = tssd.ssd(*ins, Q=Q)
    got = torch.autograd.grad((y, h), ins, (torch.from_numpy(dy),
                                            torch.from_numpy(dh)))
    _, vjp = jax.vjp(JL.ssd_scan_ref, *map(jnp.asarray, arrays))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    _close_grads(got, want, what=f"S={S}")
    # y alone: the final state takes no cotangent
    got_y = torch.autograd.grad(tssd.ssd(*ins, Q=Q)[0], ins,
                                torch.from_numpy(dy))
    _, vjp_y = jax.vjp(lambda *a: JL.ssd_scan_ref(*a)[0],
                       *map(jnp.asarray, arrays))
    _close_grads(got_y, vjp_y(jnp.asarray(dy)), what=f"S={S}, y only")


# ---------------------------------------------------------------------------
# the loss, its gradients and the train step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [GRANITE, ARCTIC, MAMBA, JAMBA])
def test_lm_loss_and_grads_match_reference(name, monkeypatch):
    """One lm_loss (z-loss on) and its gradients at B=2 x 128 tokens; the
    port with layer remat on, the reference without (its remat changes no
    value)."""
    _sequential_oracle(monkeypatch, name)
    jcfg, jparams = reduced_params(name)
    cfg, params = port_params(name)
    batch = _batch(cfg, 11, 2, 128)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jlm_loss(jcfg, JOPTS, p, jb, 1e-4)))(jparams)
    tl, tg = _port_grads(cfg, params, batch, 1e-4)
    assert tl == pytest.approx(float(jl), rel=1e-5)
    for (path, a), b in zip(TP.leaves(jax.tree.map(np.asarray, jg)), tg):
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=GRAD_TOL[name]
                                   * float(np.abs(a).max()), err_msg=path)


def test_reference_mamba2_gradient_is_nan_where_the_ports_is_finite():
    """The reference fault this file works around: its own ``ssd_chunked``
    gives NaN gradients at this input (``exp`` over the whole square,
    masked afterwards); the port's gradient is finite in every leaf."""
    jcfg, jparams = reduced_params(MAMBA)
    cfg, params = port_params(MAMBA)
    batch = _batch(cfg, 11, 2, 128)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = jax.jit(jax.grad(lambda p: jlm_loss(jcfg, JOPTS, p, jb,
                                             1e-4)))(jparams)
    nan = [path for path, a in TP.leaves(jax.tree.map(np.asarray, jg))
           if np.isnan(a).any()]
    assert "embed" in nan and len(nan) > 5, nan
    _, tg = _port_grads(cfg, params, batch, 1e-4)
    assert all(bool(torch.isfinite(g).all()) for g in tg)


@pytest.mark.parametrize("name", [GRANITE, MAMBA])
def test_train_steps_match_reference(name, monkeypatch):
    """Two train steps of each package (the second from the reference's
    carried state, as in ``test_torch_training.py``), the port with remat
    on: loss and gradient norm within 1e-5 relative, parameters on that
    file's bars (the mask of sure entries from the port's gradients, which
    agree with the reference's within 1e-5 x max|g|)."""
    _sequential_oracle(monkeypatch, name)
    jcfg, jparams = reduced_params(name)
    cfg, params = port_params(name)
    lr = 1e-3
    jt = JTrainConfig(opt=JAdamW(lr=lr, warmup_steps=0))
    tt = TrainConfig(opt=AdamWConfig(lr=lr, warmup_steps=0))
    jstep = jax.jit(jmake_train_step(jcfg, JOPTS, jt))
    tstep = make_train_step(cfg, TL.ModelOptions(), tt, device="cpu")
    template = TM.model_template(cfg)
    jstate = jinit_train_state(jcfg, jt, jparams)
    tstate = init_train_state(cfg, tt, params)
    for seed in (21, 22):
        batch = _batch(cfg, seed, 4, 64)
        _, tg = _port_grads(cfg, params, batch, tt.z_loss)
        grads = {}
        for (path, _), g in zip(TP.leaves(params), tg):
            TP.set_leaf(grads, path, g.numpy())
        jp2, jstate2, jm = jstep(jparams, jstate,
                                 {k: jnp.asarray(v) for k, v in
                                  batch.items()})
        tp2, _, tm = tstep(params, tstate, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        _assert_params(jp2, tp2, grads, lr)
        jparams, jstate = jp2, jstate2
        params = TP.from_jax(template, jax.tree.map(np.asarray, jp2),
                             device="cpu")
        tstate = train_state_from_jax(
            template, jax.tree.map(np.asarray, jstate2), device="cpu")


# ---------------------------------------------------------------------------
# remat and the donated step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,opts", [
    (GRANITE, dict(remat=True)), (MAMBA, dict(remat=True)),
    (JAMBA, dict(remat=True)), (JAMBA, dict(remat=True,
                                           remat_sublayers=True))])
def test_remat_gives_the_gradients_of_no_remat(name, opts):
    """Checkpointed layer bodies (and, on jamba's 8-sublayer bodies, each
    sublayer inside them) recompute the same values: the loss and every
    gradient bit-equal to remat off."""
    cfg, params = port_params(name)
    batch = _batch(cfg, 3, 2, 64)
    out = []
    for o in (TL.ModelOptions(remat=False), TL.ModelOptions(**opts)):
        live = TP.map_tree(lambda t: t.detach().requires_grad_(True), params)
        loss = lm_loss(cfg, o, live, batch, 1e-4, device="cpu")
        out.append((float(loss.detach()), torch.autograd.grad(
            loss, [t for _, t in TP.leaves(live)])))
    (l0, g0), (l1, g1) = out
    assert l0 == l1
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


@pytest.mark.parametrize("name", [GRANITE, JAMBA])
def test_donated_step_equals_the_functional_step(name):
    """``donate=True`` writes AdamW's update into the parameters and
    moments in place, a chunk at a time (a chunk of 1,000 elements here,
    so leaves span several): the same bits as the functional step, and the
    trees passed in are the ones returned."""
    from repro_torch.training import optimizer
    cfg, params = port_params(name)
    tt = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=0))
    batch = _batch(cfg, 4, 2, 64)
    want = make_train_step(cfg, TL.ModelOptions(), tt, device="cpu")(
        params, init_train_state(cfg, tt, params), batch)
    mine = TP.map_tree(torch.clone, params)
    state = init_train_state(cfg, tt, mine)
    chunk = optimizer.INPLACE_CHUNK
    optimizer.INPLACE_CHUNK = 1000
    try:
        got = make_train_step(cfg, TL.ModelOptions(), tt, device="cpu",
                              donate=True)(mine, state, batch)
    finally:
        optimizer.INPLACE_CHUNK = chunk
    assert got[0] is mine and got[1]["inner"]["mu"] is state["inner"]["mu"]
    for a, b in zip(TP.leaves({"p": got[0], "s": got[1]}),
                    TP.leaves({"p": want[0], "s": want[1]})):
        assert torch.equal(a[1], b[1]), a[0]
    assert float(got[2]["loss"]) == float(want[2]["loss"])
