"""The plain reference against the program's CPU path at the reduced
molmoact-7b sizes, float32 weights drawn by the benchmark: the decoder's
logits over an image prefix, a prompt and served tokens, and the DiT
head's trajectory."""
import json
import os

import torch

from conftest import shrink
from harness import manifest as MF
from harness.port import Weights, port_config
from harness.traffic import observation
from reference import molmoact as R

TOL = 1e-4      # float32 on both sides; sums in other orders


def _cfg(name):
    with open(os.path.join(MF.BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_served_logits_match_the_programs_forward():
    from repro_torch.models import model as M
    cfg, _ = shrink(_cfg("molmoact-7b"), {"kind": "control_loop"})
    pcfg = port_config(cfg)
    w = Weights(pcfg, torch.float32, "cpu").draw(2 ** 32 + 3)
    tokens, patches = observation(cfg, 2, 8, 5, 0, "cpu")
    served = torch.randint(0, cfg["vocab_size"], (2, 7),
                           generator=torch.Generator().manual_seed(1))
    got = R.served_logits(w, cfg, tokens, patches, served)
    full = M.forward(pcfg, M.ModelOptions(), w, {
        "tokens": torch.cat([tokens, served[:, :-1]], 1),
        "patches": patches.float()}, device="cpu")
    want = full[:, -served.shape[1]:]
    assert got.shape == want.shape == (2, 7, cfg["vocab_size"])
    assert float((got - want).abs().max()) <= TOL * max(
        1.0, float(want.abs().max()))


def test_trajectory_matches_the_programs_dit_head():
    from repro_torch.models import model as M
    cfg, _ = shrink(_cfg("molmoact-7b-dit"), {"kind": "control_loop"})
    pcfg = port_config(cfg)
    w = Weights(pcfg, torch.float32, "cpu").draw(2 ** 32 + 4)
    a = cfg["action"]
    gen = torch.Generator().manual_seed(2)
    cond = w["embed"][torch.randint(0, cfg["vocab_size"], (3,),
                                    generator=gen)]
    noise = torch.randn((3, a["horizon"], a["action_dim"]), generator=gen)
    got = R.trajectory(w["action_dit"], cfg, cond, noise)
    want = M.generate_actions_dit(pcfg, w, cond, noise=noise, device="cpu")
    assert float((got - want).abs().max()) <= TOL * max(
        1.0, float(want.abs().max()))
    # the head's zero-initialised leaves are drawn non-zero, so the
    # trajectory is not the noise
    assert float((want - noise).abs().max()) > 1e-2


def test_fp8_control_moves_the_logits():
    cfg, _ = shrink(_cfg("molmoact-7b"), {"kind": "control_loop"})
    w = Weights(port_config(cfg), torch.float32, "cpu").draw(7)
    tokens, patches = observation(cfg, 1, 8, 5, 0, "cpu")
    served = torch.zeros(1, 3, dtype=torch.long)
    a = R.served_logits(w, cfg, tokens, patches, served)
    b = R.served_logits(w, cfg, tokens, patches, served, quant="fp8")
    assert 1e-3 < float((a - b).abs().max()) < 1.0
