"""Validation of the paper's published claims against our simulator
(DESIGN.md §8). Each check returns (ok, measured, expectation-string);
``validate_all`` is exercised by tests and the benchmark harness.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import get_config
from repro_torch.core.hardware import ORIN, THOR, get_hardware
from repro_torch.core.scaling import scaling_sweep
from repro_torch.core.xpu_sim import simulate_vla


def claim_generation_dominates() -> Tuple[bool, float, str]:
    """(ii) generation phase ~= 75% of step latency."""
    r = simulate_vla(get_config("molmoact-7b"), ORIN)
    g = r.generation_fraction
    return 0.60 <= g <= 0.90, g, "generation fraction in [0.60, 0.90] (~0.75)"


def claim_thor_speedup() -> Tuple[bool, float, str]:
    """(iii) Thor has 5x compute but only ~1.4x e2e speedup."""
    cfg = get_config("molmoact-7b")
    s = simulate_vla(cfg, ORIN).e2e / simulate_vla(cfg, THOR).e2e
    return 1.2 <= s <= 2.0, s, "e2e speedup in [1.2, 2.0] (~1.4) despite 5x FLOPS"


def claim_decode_memory_bound() -> Tuple[bool, float, str]:
    """Generation decode is memory-bandwidth bound."""
    r = simulate_vla(get_config("molmoact-7b"), ORIN)
    decode = [p for p in r.phases if p.name == "generation_decode"][0]
    return decode.memory_fraction > 0.9, decode.memory_fraction, \
        "decode memory-time fraction > 0.9"


def claim_far_from_realtime() -> Tuple[bool, float, str]:
    """(i) latencies ~200-300x higher than 10 Hz real-time."""
    r = simulate_vla(get_config("molmoact-7b"), ORIN)
    ratio = r.e2e / 0.1
    return 100 <= ratio <= 1000, ratio, "off-realtime ratio in [100, 1000]"


def claim_bandwidth_helps_but_insufficient() -> Tuple[bool, float, str]:
    """Fig 3: GDDR7/PIM raise control frequency monotonically with BW, yet
    the 100B model stays below 10 Hz on every Table-1 system."""
    big = scaling_sweep((100e9,))[0]
    freqs = {}
    for name in ("jetson-orin", "orin+lpddr5x", "orin+gddr7", "orin+pim"):
        freqs[name] = simulate_vla(big, get_hardware(name)).control_freq_hz
    mono = (freqs["jetson-orin"] < freqs["orin+lpddr5x"]
            < freqs["orin+gddr7"] < freqs["orin+pim"])
    best = max(simulate_vla(big, get_hardware(n)).control_freq_hz
               for n in ("thor+pim", "orin+pim", "thor+gddr7"))
    return mono and best < 10.0, best, \
        "monotone freq with BW; best 100B config < 10 Hz"


ALL_CLAIMS = {
    "generation_dominates": claim_generation_dominates,
    "thor_speedup_~1.4x": claim_thor_speedup,
    "decode_memory_bound": claim_decode_memory_bound,
    "200-300x_off_realtime": claim_far_from_realtime,
    "bw_helps_but_insufficient": claim_bandwidth_helps_but_insufficient,
}


def validate_all() -> List[Dict]:
    out = []
    for name, fn in ALL_CLAIMS.items():
        ok, measured, expect = fn()
        out.append({"claim": name, "ok": ok, "measured": measured,
                    "expectation": expect})
    return out
