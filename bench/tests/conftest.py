"""The benchmark's CPU tests: ``PYTHONPATH=src python -m pytest -q
bench/tests`` from the repository's root."""
import copy
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (os.path.join(ROOT, "src"), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(cfg: dict, traffic: dict, dtype: str = "float32"):
    """A configuration and mix small enough for the CPU, of the same
    shape (the port's ``reduced()`` sizes)."""
    cfg, tr = copy.deepcopy(cfg), copy.deepcopy(traffic)
    cfg.update(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=96,
               vocab_size=256, n_cot_tokens=6, dtype=dtype)
    cfg["vision"].update(num_hidden_layers=2, hidden_size=64,
                         num_attention_heads=4, intermediate_size=96,
                         num_patches=8, patch_embed_dim=32)
    a = cfg["action"]
    if a["mode"] == "discrete":
        a["num_action_tokens"] = 4
    else:
        a.update(dit_layers=2, dit_hidden_size=32, dit_num_heads=2,
                 dit_steps=2, horizon=2)
    tr["text_tokens"] = 8
    if tr["kind"] == "control_loop":
        tr["robots"] = 2
    else:
        tr.update(rate_per_s=20.0, lead_s=0.3, tail_s=0.5, max_tokens=5,
                  wait_s=10.0, trace_s=0.2)
        tr["engine"].update(n_slots=4, max_seq=32, page_size=8,
                            chunk_size=8, token_budget=24, tick_tokens=4)
    return cfg, tr


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
