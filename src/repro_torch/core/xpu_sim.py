"""Analytical XPU simulator (paper §3.2, reimplemented).

Each operator is priced with a two-term roofline:
    t = max(flops / (peak * eff_op), bytes / (bw * eff_bw))
with the PIM extension routing low-intensity operators to in-memory compute.

Cross-operator prefetch (paper: "early movement of operands through the
memory hierarchy to minimize stalls"): within a phase, weight streaming for
op i+1 overlaps compute of op i, so the phase lower-bounds at
    max(sum(t_compute), sum(t_memory))
instead of sum(max(...)). Both are reported; `prefetch=True` is the default
(and is what the paper's simulator models).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hardware import Hardware
from repro_torch.core.workload import Op, Phase, build_vla_step


@dataclass
class OpTime:
    op: Op
    t_compute: float
    t_memory: float
    on_pim: bool

    @property
    def t(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def bound(self) -> str:
        return "memory" if self.t_memory >= self.t_compute else "compute"


@dataclass
class PhaseReport:
    name: str
    op_times: List[OpTime]
    repeat: int = 1

    @property
    def t_per_op(self) -> float:
        return self.repeat * sum(o.t for o in self.op_times)

    @property
    def t_prefetch(self) -> float:
        c = sum(o.t_compute for o in self.op_times)
        m = sum(o.t_memory for o in self.op_times)
        return self.repeat * max(c, m)

    def time(self, prefetch: bool = True) -> float:
        return self.t_prefetch if prefetch else self.t_per_op

    @property
    def bound(self) -> str:
        c = sum(o.t_compute for o in self.op_times)
        m = sum(o.t_memory for o in self.op_times)
        return "memory" if m >= c else "compute"

    @property
    def memory_fraction(self) -> float:
        m = sum(o.t_memory for o in self.op_times)
        return m / max(m + sum(o.t_compute for o in self.op_times), 1e-30)


@dataclass
class StepReport:
    model: str
    hardware: str
    phases: List[PhaseReport]
    prefetch: bool = True

    @property
    def e2e(self) -> float:
        return sum(p.time(self.prefetch) for p in self.phases)

    @property
    def control_freq_hz(self) -> float:
        return 1.0 / max(self.e2e, 1e-30)

    def phase_seconds(self) -> Dict[str, float]:
        return {p.name: p.time(self.prefetch) for p in self.phases}

    def phase_fractions(self) -> Dict[str, float]:
        e = self.e2e
        return {p.name: p.time(self.prefetch) / e for p in self.phases}

    @property
    def generation_fraction(self) -> float:
        """The paper's 'generation phase' = prefill + CoT decode."""
        f = self.phase_fractions()
        return f.get("generation_prefill", 0) + f.get("generation_decode", 0)


def op_time(op: Op, hw: Hardware) -> OpTime:
    on_pim = (hw.pim and op.kind in ("gemv", "attn")
              and op.intensity < hw.pim_intensity_cutoff)
    if on_pim:
        bw = hw.pim_bw_gbs * 1e9 * hw.gemv_bw_eff
        peak = hw.pim_tflops * 1e12
        eff = 1.0
    else:
        bw = hw.mem_bw_gbs * 1e9 * hw.gemv_bw_eff
        peak = hw.bf16_tflops * 1e12
        eff = hw.gemm_eff if op.kind in ("gemm", "attn") else hw.gemm_eff
    t_c = op.flops / max(peak * eff, 1.0)
    t_m = op.bytes / max(bw, 1.0)
    return OpTime(op, t_c, t_m, on_pim)


def simulate_phases(phases: List[Phase], hw: Hardware,
                    prefetch: bool = True) -> List[PhaseReport]:
    return [PhaseReport(p.name, [op_time(o, hw) for o in p.ops], p.repeat)
            for p in phases]


def simulate_vla(cfg: ModelConfig, hw: Hardware, B: int = 1,
                 prefetch: bool = True) -> StepReport:
    phases = build_vla_step(cfg, B)
    return StepReport(cfg.name, hw.name, simulate_phases(phases, hw, prefetch),
                      prefetch)


def speedup(cfg: ModelConfig, a: Hardware, b: Hardware) -> float:
    """e2e speedup of b over a."""
    return simulate_vla(cfg, a).e2e / simulate_vla(cfg, b).e2e
