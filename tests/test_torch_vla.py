"""The port's VLA control step against the JAX reference (reduced
molmoact-7b, discrete actions, B=2, 5 CoT tokens).

Weights come from the reference through ``from_jax``; tokens and patches
are made with numpy. CoT and action tokens must be equal to the
reference's, run with its plain attention cores and with its Pallas
kernels in interpret mode. Prefill logits agree within 1e-4 (f32 weights,
bf16 caches: see ``test_torch_model``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import reduced_params
from repro.core import vla as jvla
from repro.models import model as JM
from repro.models.layers import ModelOptions as JOptions
from repro_torch.configs import get_config
from repro_torch.core import vla as tvla
from repro_torch.models import model as TM
from repro_torch.models.layers import ModelOptions
from repro_torch.models.params import from_jax

N_COT, B, N_TEXT = 5, 2, 6


@pytest.fixture(scope="module")
def setup():
    jcfg, jparams = reduced_params("molmoact-7b")
    jcfg = dataclasses.replace(jcfg, n_cot_tokens=N_COT)
    tcfg = dataclasses.replace(get_config("molmoact-7b").reduced(),
                               n_cot_tokens=N_COT)
    tparams = from_jax(TM.model_template(tcfg),
                       jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, N_TEXT)),
             "patches": rng.standard_normal(
                 (B, tcfg.vision.num_tokens, tcfg.vision.embed_dim),
                 dtype=np.float32)}
    return jcfg, jparams, tcfg, tparams, batch


@pytest.mark.parametrize("use_pallas", [False, True])
def test_control_step_tokens_match_reference(setup, use_pallas):
    jcfg, jparams, tcfg, tparams, batch = setup
    jopts = JOptions(remat=False, use_pallas=use_pallas,
                     pallas_interpret=True)
    jout = jvla.vla_control_step(jcfg, jopts, jparams,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    tout = tvla.vla_control_step(tcfg, ModelOptions(), tparams, batch,
                                 device="cpu")
    assert tout.cot_tokens.shape == (B, N_COT)
    assert tout.action_tokens.shape == (B, tcfg.action.num_action_tokens)
    np.testing.assert_array_equal(tout.cot_tokens.numpy(),
                                  np.asarray(jout.cot_tokens))
    np.testing.assert_array_equal(tout.action_tokens.numpy(),
                                  np.asarray(jout.action_tokens))
    assert tout.phase_tokens == jout.phase_tokens


def test_prefill_logits_and_vision_prefix(setup):
    """Prefill logits match the reference, and a prefix from
    ``encode_vision`` gives the same step as the patches themselves."""
    jcfg, jparams, tcfg, tparams, batch = setup
    _, _, max_seq = tvla.control_step_lengths(tcfg, N_TEXT)
    jl, _ = JM.prefill(jcfg, JOptions(remat=False), jparams,
                       {k: jnp.asarray(v) for k, v in batch.items()}, max_seq)
    tl, _ = TM.prefill(tcfg, ModelOptions(), tparams, batch, max_seq,
                       device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    jprefix = JM.encode_vision(jcfg, JOptions(remat=False), jparams,
                               jnp.asarray(batch["patches"]))
    prefix = TM.encode_vision(tcfg, ModelOptions(), tparams,
                              batch["patches"], device="cpu")
    np.testing.assert_allclose(prefix.numpy(), np.asarray(jprefix),
                               atol=1e-5, rtol=1e-5)
    a = tvla.vla_control_step(tcfg, ModelOptions(), tparams, batch,
                              device="cpu")
    b = tvla.vla_control_step(tcfg, ModelOptions(), tparams,
                              {"tokens": batch["tokens"], "prefix": prefix},
                              device="cpu")
    assert torch.equal(a.cot_tokens, b.cot_tokens)
    assert torch.equal(a.action_tokens, b.action_tokens)


def test_dit_head_is_not_ported_yet():
    """The name is kept from when the port refused the DiT head. Reduced
    molmoact-7b with its head switched to "dit" now runs: the control step
    returns a trajectory [B, horizon, action_dim] and no action tokens
    (``tests/test_torch_dit.py`` holds it to the reference)."""
    cfg = dataclasses.replace(
        get_config("molmoact-7b").reduced(),
        action=get_config("molmoact-7b-dit").reduced().action)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, N_TEXT)),
             "patches": rng.standard_normal(
                 (B, cfg.vision.num_tokens, cfg.vision.embed_dim),
                 dtype=np.float32)}
    out = tvla.vla_control_step(cfg, ModelOptions(), params, batch,
                                device="cpu")
    a = cfg.action
    assert out.action_tokens is None
    assert out.trajectory.shape == (B, a.horizon, a.action_dim)
    assert bool(torch.isfinite(out.trajectory).all())
    assert out.phase_tokens["action"] == a.dit_steps
