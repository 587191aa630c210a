"""The FLOP and byte counts at molmoact-7b's published widths, against
hand counts and against the program's parameter template."""
import json
import math
import os

import pytest

from harness import counts
from harness import manifest as MF


def _cfg(name):
    with open(os.path.join(MF.BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_decoder_and_head_at_molmoact_widths():
    cfg = _cfg("molmoact-7b")
    layer = (3584 * 28 * 128 * 2 + 3584 * 4 * 128 * 2) + 3 * 3584 * 18944
    assert counts.decoder_layer_params(cfg) == layer == 233_046_016
    assert counts.decoder_params(cfg) == 28 * layer == 6_525_288_448
    assert counts.head_params(cfg) == 152_064 * 3584 == 544_997_376
    # a decode token at position 700: the products twice, attention over
    # 701 keys in every layer
    want = 2 * (6_525_288_448 + 544_997_376) + 4 * 3584 * 701 * 28
    assert counts.decode_flops(cfg, 700) == want
    assert 14.1e9 < want < 14.5e9
    assert counts.key_sum(0, 640) == 640 * 641 // 2
    assert counts.prefill_flops(cfg, 0, 640) == (
        2 * 6_525_288_448 * 640 + 4 * 3584 * 28 * 640 * 641 // 2
        + 2 * 544_997_376)
    img = 24 * (2 * 576 * (4 * 1024 ** 2 + 2 * 1024 * 4096)
                + 4 * 1024 * 576 ** 2) + 2 * 576 * 1024 * (1024 + 3584)
    assert counts.image_flops(cfg) == img
    assert 0.35e12 < img < 0.42e12


def test_decode_attention_bytes_by_hand():
    cfg = _cfg("molmoact-7b")
    # 4 robots, input at 700: K and V rows 0..700, q and out, bf16
    want = 4 * 28 * (2 * 701 * 4 * 128 + 2 * 28 * 128) * 2
    assert counts.decode_attention_bytes(cfg, 4, 700) == want


def test_control_step_by_hand():
    cfg = _cfg("molmoact-7b")
    one = (counts.image_flops(cfg) + counts.prefill_flops(cfg, 0, 640)
           + sum(counts.decode_flops(cfg, 640 + j) for j in range(192)))
    assert counts.control_step_flops(cfg, 4, 64) == pytest.approx(4 * one)
    assert 44e12 < 4 * one < 48e12
    dit = _cfg("molmoact-7b-dit")
    d, H = 512, 8
    block = 2 * d * 6 * d + 2 * H * (4 * d * d + 8 * d * d) + 4 * d * H * H
    step = (2 * H * 7 * d + 2 * 3584 * d + 2 * 256 * d + 6 * block
            + 2 * d * 2 * d + 2 * H * d * 7)
    assert counts.dit_flops(dit) == 10 * step


@pytest.mark.parametrize("name", ["molmoact-7b", "molmoact-7b-dit"])
def test_counts_cover_the_programs_weights(name):
    """Every product weight of the program's template is counted once:
    the decoder's, the head's, the tower's and the DiT head's."""
    from harness.port import port_config
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves
    cfg = _cfg(name)
    tmpl = dict(leaves(M.model_template(port_config(cfg))))
    size = {p: math.prod(s.shape) for p, s in tmpl.items()}
    dec = sum(n for p, n in size.items() if p.startswith("decoder")
              and p.split("/")[-1].startswith("w"))
    assert dec == counts.decoder_params(cfg)
    assert size["lm_head"] == counts.head_params(cfg)
    v = cfg["vision"]
    tower_products = sum(n for p, n in size.items() if p.startswith(
        "vision/stack") and p.split("/")[-1].startswith("w"))
    assert counts.image_flops(cfg) - 2.0 * v["num_patches"] * (
        v["patch_embed_dim"] * v["hidden_size"]
        + v["hidden_size"] * cfg["hidden_size"]) == pytest.approx(
        2.0 * v["num_patches"] * tower_products
        + v["num_hidden_layers"] * 4.0 * v["hidden_size"]
        * v["num_patches"] ** 2)
