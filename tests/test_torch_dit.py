"""The port's DiT action head (``models.action``, ``model.DiTGraph``, the
DiT branch of ``core.vla``) against the JAX reference, on the CPU.

The head's weights go through ``from_jax``. The reference initialises
``ada``, ``final_ada`` and ``out_proj`` to zeros, so its predicted noise is
0 and the trajectory is the input noise: a comparison at init would pass
for a port that skipped every layer. So those three leaves are perturbed
(seeded normal x 0.02) in the numpy tree both packages get, and
trajectories agree within 1e-4 x max(1, |ref|) (f32; the two frameworks
sum in other orders, and their exp and linspace tables differ in the
last bit). The noise comes from ``jax.random.normal``; other inputs are
made with numpy from a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import vla as jvla
from repro.models import action as JA
from repro.models import model as JM
from repro.models.layers import ModelOptions as JOptions
from repro.models.params import PSpec as JPSpec
from repro_torch.configs import get_config
from repro_torch.core import vla as tvla
from repro_torch.models import action as TA
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.models.layers import ModelOptions

ARCH = "molmoact-7b-dit"
PERTURBED = ("ada", "final_ada", "out_proj")
N_COT, B, N_TEXT = 4, 2, 6


def _tol(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert err.max() <= 1e-4, f"max relative error {err.max()}"


def perturb(tree, seed=0):
    """The numpy tree with the zero-initialised leaves set to seeded
    normal x 0.02 (any path ending in one of PERTURBED)."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: (walk(v) if isinstance(v, dict) else
                    (0.02 * rng.standard_normal(v.shape)).astype(v.dtype)
                    if k in PERTURBED else v)
                for k, v in sorted(t.items())}
    return walk(tree)


def _configs(**action):
    """(reference cfg, port cfg) of reduced molmoact-7b-dit with the
    action head's fields replaced by ``action``."""
    jcfg = jget_config(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    jcfg = dataclasses.replace(
        jcfg, n_cot_tokens=N_COT,
        action=dataclasses.replace(jcfg.action, **action))
    tcfg = dataclasses.replace(
        tcfg, n_cot_tokens=N_COT,
        action=dataclasses.replace(tcfg.action, **action))
    return jcfg, tcfg


def _head(jcfg, tcfg, zeros=False):
    """The reference's head parameters (numpy tree, perturbed unless
    ``zeros``) as (JAX tree, port tree)."""
    tree = jax.tree.map(np.asarray, JM.init_params(
        {"h": JA.dit_template(jcfg.action, jcfg.d_model)},
        jax.random.PRNGKey(3), jnp.float32))["h"]
    if not zeros:
        tree = perturb(tree)
    tparams = TP.from_jax(TA.dit_template(tcfg.action, tcfg.d_model), tree,
                          device="cpu")
    return jax.tree.map(jnp.asarray, tree), tparams


HEAD = dict(dit_steps=10, horizon=8, action_dim=7)


def test_zero_initialised_head_returns_its_noise():
    """With the reference's zeros the predicted noise is 0, so both
    packages return the input noise exactly: why every comparison below
    perturbs the head."""
    jcfg, tcfg = _configs(**HEAD)
    jp, tp = _head(jcfg, tcfg, zeros=True)
    rng = np.random.default_rng(1)
    cond = rng.standard_normal((B, tcfg.d_model), dtype=np.float32)
    key = jax.random.PRNGKey(7)
    want = JA.dit_generate(jp, jnp.asarray(cond), jcfg.action, key)
    noise = np.array(jax.random.normal(key, want.shape, jnp.float32))
    np.testing.assert_array_equal(np.asarray(want), noise)
    got = TA.dit_generate(tp, torch.from_numpy(cond), tcfg.action,
                          noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), noise)


def test_denoise_and_generate_match_reference():
    """One denoiser evaluation at three timesteps, and the 10-step loop,
    with the perturbed head (reduced widths, horizon 8, action_dim 7);
    the loop also through a ``DiTGraph`` and ``generate_actions_dit``."""
    jcfg, tcfg = _configs(**HEAD)
    jp, tp = _head(jcfg, tcfg)
    rng = np.random.default_rng(2)
    cond = rng.standard_normal((B, tcfg.d_model), dtype=np.float32)
    noisy = rng.standard_normal((B, 8, 7), dtype=np.float32)
    for t in (1000.0, 550.0, 100.0):
        ts = np.full((B,), t, np.float32)
        want = JA.dit_denoise(jp, jnp.asarray(noisy), jnp.asarray(ts),
                              jnp.asarray(cond), jcfg.action)
        got = TA.dit_denoise(tp, torch.from_numpy(noisy),
                             torch.from_numpy(ts), torch.from_numpy(cond),
                             tcfg.action)
        assert float(np.abs(np.asarray(want)).max()) > 0.1
        _tol(got.numpy(), want)
    key = jax.random.PRNGKey(11)
    want = JA.dit_generate(jp, jnp.asarray(cond), jcfg.action, key)
    noise = np.array(jax.random.normal(key, (B, 8, 7), jnp.float32))
    assert float(np.abs(np.asarray(want) - noise).max()) > 0.05
    got = TA.dit_generate(tp, torch.from_numpy(cond), tcfg.action,
                          noise=torch.from_numpy(noise))
    _tol(got.numpy(), want)
    graph = TM.DiTGraph("cpu")
    for _ in range(2):           # the second call reuses the buffers
        traj = TM.generate_actions_dit(
            tcfg, {"action_dit": tp, "embed": torch.zeros(1)}, cond,
            noise=noise, device="cpu", graph=graph)
        assert torch.equal(traj, got)
    gen = torch.Generator().manual_seed(5)
    drawn = TA.dit_generate(tp, torch.from_numpy(cond), tcfg.action,
                            generator=gen)
    again = TA.dit_generate(tp, torch.from_numpy(cond), tcfg.action,
                            generator=torch.Generator().manual_seed(5))
    assert torch.equal(drawn, again) and drawn.shape == (B, 8, 7)
    with pytest.raises(ValueError, match="noise"):
        TA.dit_generate(tp, torch.from_numpy(cond), tcfg.action)


@pytest.fixture(scope="module")
def control_setup():
    jcfg, tcfg = _configs(**HEAD)
    tree = jax.tree.map(np.asarray, JM.init_params(
        JM.model_template(jcfg), jax.random.PRNGKey(0), jnp.float32))
    tree = dict(tree, action_dit=perturb(tree["action_dit"]))
    tparams = TP.from_jax(TM.model_template(tcfg), tree, device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, N_TEXT)),
             "patches": rng.standard_normal(
                 (B, tcfg.vision.num_tokens, tcfg.vision.embed_dim),
                 dtype=np.float32)}
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, tparams, batch


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dit_control_step_matches_reference(control_setup, use_pallas):
    """Reduced molmoact-7b-dit, the head perturbed: equal CoT tokens, the
    same phase_tokens and a trajectory within tolerance, against the
    reference with its plain attention cores and with its Pallas kernels
    in interpret mode. The cache leaves out action tokens."""
    jcfg, jparams, tcfg, tparams, batch = control_setup
    key = jax.random.PRNGKey(9)
    jopts = JOptions(remat=False, use_pallas=use_pallas,
                     pallas_interpret=True)
    jout = jvla.vla_control_step(
        jcfg, jopts, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        key=key)
    noise = np.asarray(jax.random.normal(
        key, (B, tcfg.action.horizon, tcfg.action.action_dim), jnp.float32))
    tout = tvla.vla_control_step(tcfg, ModelOptions(), tparams, batch,
                                 noise=noise, device="cpu")
    np.testing.assert_array_equal(tout.cot_tokens.numpy(),
                                  np.asarray(jout.cot_tokens))
    assert tout.action_tokens is None and jout.action_tokens is None
    assert tout.phase_tokens == jout.phase_tokens
    assert tout.phase_tokens["action"] == 10
    _tol(tout.trajectory.numpy(), jout.trajectory)
    assert tvla.control_step_lengths(tcfg, N_TEXT)[1:] == (
        0, tcfg.vision.num_tokens + N_TEXT + N_COT + 1)


def test_full_width_head_parameter_count_matches_reference():
    """From shapes only: the full-width head's leaves, shapes and count
    equal the reference template's (30,813,184 parameters)."""
    jcfg, tcfg = jget_config(ARCH), get_config(ARCH)
    jt = JA.dit_template(jcfg.action, jcfg.d_model)
    tt = TA.dit_template(tcfg.action, tcfg.d_model)
    jshapes = {"/".join(p.key for p in path): tuple(s.shape)
               for path, s in jax.tree_util.tree_flatten_with_path(
                   jt, is_leaf=lambda x: isinstance(x, JPSpec))[0]}
    tshapes = {path: s.shape for path, s in TP.leaves(tt)}
    assert jshapes == tshapes
    assert TP.param_count(tt) == 30_813_184
    full = TM.model_template(tcfg)
    assert TP.param_count(full["action_dit"]) == 30_813_184
    assert get_config(ARCH).action.dit_steps == 10
