"""The control of ``correct``: the plain reference put in the program's
place in fp8, the precision below the configuration's bf16, read by a
whole run of each control cell at a size the CPU holds (the DiT head at
its full widths, the backbone cut), must come out as not correct by the
run's own verdict and the cell's own limits, while the bf16 program's own
readings stay within them. The chip readings at full size that the limits
were set from are in PERF.md; ``python3 bench/control.py`` repeats them
on the card."""
import pytest

from conftest import shrink
from harness import manifest as MF
from harness.run_cell import run

CELLS = [w["name"] for w in MF.load()["workloads"]
         if w["traffic"].startswith("control")]


def mid(cfg, tr):
    head = dict(cfg["action"])
    cfg, tr = shrink(cfg, tr, "bfloat16")
    cfg.update(hidden_size=256, num_hidden_layers=4, num_attention_heads=4,
               num_key_value_heads=2, head_dim=64, intermediate_size=512,
               vocab_size=8192, n_cot_tokens=24)
    if head["mode"] == "dit":
        cfg["action"] = head
    tr.update(robots=4, check_steps=2)
    return cfg, tr


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 32 + 9])
def test_control_fails_where_the_program_passes(cell, seed):
    r = run(cell, seed, 0.1, False, device="cpu", adjust=mid,
            readings=(None, "fp8"))
    assert r["correct"], r["checks"]
    assert r["controls"] == {"fp8": False}, r["readings"]
    ctl = {k.split("/")[0]: v for k, v in r["readings"].items()
           if k.endswith("/fp8")}
    assert any(v > r["checks"][k]["limit"] for k, v in ctl.items()
               if k in r["checks"]), ctl
