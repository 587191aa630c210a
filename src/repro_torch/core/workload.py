"""Workloads: the operator-level IR for the XPU simulator, and the fleet
traffic generator for the serving front-end.

**Operator IR.** A VLA inference step is decomposed exactly as the paper's
Figure 1: vision encoding -> generation (prefill + autoregressive CoT
decode) -> action generation (action-token decode or DiT iterations). Each
phase is a list of ``Op``s (einsum-level granularity, like the paper's
simulator), with FLOPs and bytes derived analytically from the ModelConfig.

**Fleet traces** (``fleet_trace``). The serving front-end's workload is a
robot fleet, not a static request list: robots join as a Poisson process,
each then runs a periodic control loop (the paper's fig3 control-frequency
scenarios — 10 Hz is the canonical target) whose every step resubmits the
robot's observation context plus a small per-step delta, and context
lengths are long-tailed across robots. The generator is deterministic per
seed, so a trace is a reproducible benchmark input (same seed -> the same
arrival times, prompts, and deadlines, bit for bit).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import GLOBAL_WINDOW, ModelConfig

BYTES = 2  # bf16 weights/activations


@dataclass(frozen=True)
class Op:
    name: str
    kind: str                 # 'gemm' | 'gemv' | 'attn' | 'elementwise'
    flops: float
    weight_bytes: float       # streamed parameters (incl. KV/SSM state reads)
    act_bytes: float          # activations in+out

    @property
    def bytes(self) -> float:
        return self.weight_bytes + self.act_bytes

    @property
    def intensity(self) -> float:
        return self.flops / max(self.bytes, 1.0)


@dataclass
class Phase:
    name: str
    ops: List[Op] = field(default_factory=list)
    repeat: int = 1           # e.g. decode steps

    def add(self, *ops: Op):
        self.ops.extend(ops)

    @property
    def flops(self) -> float:
        return self.repeat * sum(o.flops for o in self.ops)

    @property
    def bytes(self) -> float:
        return self.repeat * sum(o.bytes for o in self.ops)


def _gemm(name: str, m: int, k: int, n: int, batch: int = 1,
          weight: bool = True, kind: Optional[str] = None) -> Op:
    """[m,k]x[k,n] (xbatch). GEMV when the streaming dim is tiny."""
    flops = 2.0 * batch * m * k * n
    wb = batch * k * n * BYTES if weight else 0.0
    ab = batch * (m * k + m * n) * BYTES + (0.0 if weight else batch * k * n * BYTES)
    return Op(name, kind or ("gemv" if m <= 8 else "gemm"), flops, wb, ab)


def _expected_experts_hit(E: int, k: int, tokens: int) -> float:
    """Expected number of distinct experts activated by `tokens` tokens
    with top-k routing (uniform assumption)."""
    return E * (1.0 - (1.0 - k / E) ** tokens)


# ---------------------------------------------------------------------------
# per-component builders
# ---------------------------------------------------------------------------

def tower_ops(cfg: ModelConfig, tower, B: int, tag: str) -> List[Op]:
    d, n, f, T = tower.d_model, tower.num_heads, tower.d_ff, tower.num_tokens
    ops = [_gemm(f"{tag}/in_proj", B * T, tower.embed_dim, d)]
    per_layer = [
        _gemm(f"{tag}/qkv", B * T, d, 3 * d),
        Op(f"{tag}/attn", "attn", 2 * 2.0 * B * n * T * T * (d // n),
           0.0, B * (2 * T * d + n * T * T) * BYTES),
        _gemm(f"{tag}/attn_out", B * T, d, d),
        _gemm(f"{tag}/mlp_up", B * T, d, f),
        _gemm(f"{tag}/mlp_down", B * T, f, d),
    ]
    for l in per_layer:
        ops.append(dataclasses.replace(l, flops=l.flops * tower.num_layers,
                                       weight_bytes=l.weight_bytes * tower.num_layers,
                                       act_bytes=l.act_bytes * tower.num_layers))
    ops.append(_gemm(f"{tag}/out_proj", B * T, d, cfg.d_model))
    return ops


def _layer_ops(cfg: ModelConfig, i: int, B: int, S: int, ctx: int,
               decode: bool, causal_half: bool = True) -> List[Op]:
    """Ops for decoder layer i processing S new tokens against `ctx` history.

    causal_half=False models an implementation that computes the full S^2
    score matrix with masking (our baseline flash_ref path); True models a
    causal-skipping schedule (the causal_pairs optimization / real kernels).
    """
    d, hd = cfg.d_model, cfg.head_dim
    N, K = cfg.num_heads, cfg.num_kv_heads
    m = B * S
    ops: List[Op] = []
    if cfg.is_attn_layer(i):
        w = cfg.layer_window(i)
        kv_len = ctx if w == GLOBAL_WINDOW else min(ctx, w + 512)
        ops.append(_gemm(f"L{i}/wq", m, d, N * hd))
        ops.append(_gemm(f"L{i}/wkv", m, d, 2 * K * hd))
        # scores+out: decode reads the KV cache (counted as streamed bytes)
        attn_flops = 2 * 2.0 * B * N * S * kv_len * hd
        if not decode and w == GLOBAL_WINDOW and causal_half:
            attn_flops *= 0.5  # causal
        kv_bytes = B * kv_len * K * hd * 2 * BYTES
        ops.append(Op(f"L{i}/attn", "attn", attn_flops, kv_bytes,
                      m * N * hd * 2 * BYTES))
        ops.append(_gemm(f"L{i}/wo", m, N * hd, d))
    elif cfg.family in ("ssm", "hybrid"):
        d_in = cfg.ssm_expand * d
        H = d_in // cfg.ssm_head_dim
        Nst = cfg.ssm_state
        conv_ch = d_in + 2 * Nst
        ops.append(_gemm(f"L{i}/ssm_in", m, d, d_in + conv_ch + H))
        ops.append(Op(f"L{i}/conv1d", "elementwise",
                      2.0 * m * conv_ch * cfg.ssm_conv,
                      cfg.ssm_conv * conv_ch * BYTES, 2 * m * conv_ch * BYTES))
        # SSD: state update + output (decode: one recurrence over state)
        state_bytes = B * H * (d_in // H) * Nst * 4  # fp32 state read+write
        ssd_flops = 2.0 * m * d_in * Nst * 2
        if not decode:
            Q = 128  # intra-chunk quadratic term
            ssd_flops += 2.0 * B * (S // max(Q, 1) or 1) * Q * Q * H * (d_in // H)
        ops.append(Op(f"L{i}/ssd", "gemv" if decode else "attn",
                      ssd_flops, 2 * state_bytes, 2 * m * d_in * BYTES))
        ops.append(_gemm(f"L{i}/ssm_out", m, d_in, d))
    if cfg.family == "encdec" and cfg.is_attn_layer(i):
        T_enc = cfg.encoder.num_tokens
        ops.append(_gemm(f"L{i}/xq", m, d, N * hd))
        ops.append(Op(f"L{i}/xattn", "attn", 2 * 2.0 * B * N * S * T_enc * hd,
                      B * T_enc * K * hd * 2 * BYTES, m * N * hd * 2 * BYTES))
        ops.append(_gemm(f"L{i}/xo", m, N * hd, d))
    # FFN
    if cfg.is_moe_layer(i):
        E, k, f = cfg.num_experts, cfg.top_k, cfg.moe_d_ff
        ops.append(_gemm(f"L{i}/router", m, d, E))
        # weights streamed = distinct experts hit; flops = routed tokens
        hit = _expected_experts_hit(E, k, m)
        flops = 2.0 * m * k * d * f * 3
        wbytes = hit * 3 * d * f * BYTES
        ops.append(Op(f"L{i}/moe", "gemv" if m * k <= E * 8 else "gemm",
                      flops, wbytes, 2 * m * d * BYTES * k))
        if cfg.dense_residual and cfg.d_ff:
            ops.append(_gemm(f"L{i}/mlp_up", m, d, 2 * cfg.d_ff))
            ops.append(_gemm(f"L{i}/mlp_down", m, cfg.d_ff, d))
    elif cfg.d_ff and cfg.family != "ssm":
        gate = 2 if cfg.act in ("silu", "gelu") else 1
        ops.append(_gemm(f"L{i}/mlp_up", m, d, gate * cfg.d_ff))
        ops.append(_gemm(f"L{i}/mlp_down", m, cfg.d_ff, d))
    return ops


def decoder_ops(cfg: ModelConfig, B: int, S: int, ctx: int,
                decode: bool, tag: str, causal_half: bool = True) -> List[Op]:
    ops: List[Op] = []
    for i in range(cfg.num_layers):
        for o in _layer_ops(cfg, i, B, S, ctx, decode, causal_half):
            ops.append(dataclasses.replace(o, name=f"{tag}/{o.name}"))
    m = B * S
    ops.append(_gemm(f"{tag}/lm_head", m, cfg.d_model, cfg.vocab_size))
    return ops


# ---------------------------------------------------------------------------
# the VLA step (paper Fig. 1)
# ---------------------------------------------------------------------------

def build_vla_step(cfg: ModelConfig, B: int = 1) -> List[Phase]:
    """Phases of one control step: vision -> generation -> action."""
    phases: List[Phase] = []
    n_vis = cfg.vision.num_tokens if cfg.vision else 0
    n_enc = cfg.encoder.num_tokens if cfg.encoder else 0

    vision = Phase("vision_encode")
    if cfg.vision:
        vision.add(*tower_ops(cfg, cfg.vision, B, "vision"))
    if cfg.encoder:
        vision.add(*tower_ops(cfg, cfg.encoder, B, "audio"))
    phases.append(vision)

    prompt = n_vis + cfg.n_prompt_tokens
    gen = Phase("generation_prefill")
    gen.add(*decoder_ops(cfg, B, prompt, prompt, decode=False, tag="prefill"))
    phases.append(gen)

    dec = Phase("generation_decode", repeat=cfg.n_cot_tokens)
    dec.add(*decoder_ops(cfg, B, 1, prompt + cfg.n_cot_tokens // 2,
                         decode=True, tag="decode"))
    phases.append(dec)

    act = Phase("action_generate")
    a = cfg.action
    if a is None or a.mode == "discrete":
        n_act = a.num_action_tokens if a else 24
        act.repeat = n_act
        act.add(*decoder_ops(cfg, B, 1, prompt + cfg.n_cot_tokens,
                             decode=True, tag="action"))
    else:
        act.repeat = a.dit_steps
        dd, dh, dn = a.dit_d_model, a.horizon, a.dit_heads
        per_layer = [
            _gemm("dit/qkv", B * dh, dd, 3 * dd),
            Op("dit/attn", "attn", 2 * 2.0 * B * dn * dh * dh * (dd // dn),
               0.0, B * 3 * dh * dd * BYTES),
            _gemm("dit/proj", B * dh, dd, dd),
            _gemm("dit/mlp_up", B * dh, dd, 4 * dd),
            _gemm("dit/mlp_down", B * dh, 4 * dd, dd),
        ]
        for l in per_layer:
            act.add(dataclasses.replace(
                l, flops=l.flops * a.dit_layers,
                weight_bytes=l.weight_bytes * a.dit_layers,
                act_bytes=l.act_bytes * a.dit_layers))
    phases.append(act)
    return phases


def workload_totals(phases: List[Phase]) -> Dict[str, float]:
    return {
        "flops": sum(p.flops for p in phases),
        "bytes": sum(p.bytes for p in phases),
    }


# ---------------------------------------------------------------------------
# fleet traffic traces (serving front-end workloads)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetRequest:
    """One request of a fleet trace, in arrival order.

    ``t`` is the arrival offset from trace start (seconds; the replayer
    submits at ``t`` and measures SLO attainment against ``t +
    deadline_s``). ``kind`` is ``"episode"`` for a robot's first request
    (cold prefix — the prompt's context pages are not in any pool yet) and
    ``"control"`` for the periodic repeats, whose prompt shares the
    robot's full context prefix and differs only in the last
    ``tail`` positions — the repeat-observation pattern the prefix cache
    and the front-end's replica routing are built around."""
    t: float
    robot: int
    step: int                 # control-loop step index (0 = episode start)
    kind: str                 # "episode" | "control"
    prompt: np.ndarray        # [ctx + tail] int32
    max_tokens: int           # action chunk length to decode
    deadline_s: float         # complete within t + deadline_s (SLO)
    priority: str = "best_effort"   # scheduling class: control-loop
    #                                 repeats are "realtime" (the robot is
    #                                 waiting on its action chunk),
    #                                 episode starts "best_effort"


def fleet_trace(n_robots: int = 8,
                steps_per_robot: int = 5,
                control_hz: float = 10.0,
                arrival_rate: float = 4.0,
                ctx_median: int = 32,
                ctx_sigma: float = 0.6,
                ctx_max: int = 96,
                tail: int = 4,
                action_tokens: int = 8,
                vocab_size: int = 1000,
                seed: int = 0) -> List[FleetRequest]:
    """Deterministic robot-fleet trace: Poisson arrivals x periodic control
    loops x long-tail context lengths.

    - **Arrivals.** Robot ``r`` joins at the r-th event of a Poisson
      process with rate ``arrival_rate`` robots/s (exponential
      inter-arrival times).
    - **Control loop.** From its join time, each robot issues
      ``steps_per_robot`` requests at period ``1 / control_hz``. Every
      request's prompt is the robot's fixed context (camera frame +
      instruction surrogate) followed by ``tail`` fresh per-step tokens;
      step 0 is the cold ``"episode"`` request, later steps are
      ``"control"`` repeats whose context prefix is prefix-cache shareable.
    - **Long-tail lengths.** Context lengths are lognormal
      (``ctx_median`` median, ``ctx_sigma`` log-stdev), clipped to
      ``[tail + 1, ctx_max]`` — a few robots carry much longer contexts
      than the median, the tail that makes admission policy matter.
    - **Deadlines & classes.** Control requests must complete within one
      control period (produce the action chunk before the next
      observation) and carry the ``"realtime"`` priority class — the
      SLO-aware scheduler admits them first and defends their deadline;
      episode requests get 10 periods and stay ``"best_effort"``
      (episode startup is not latency-critical at the control rate).

    Returns the trace sorted by arrival time (ties broken by robot id,
    then step — total order, so replay order is deterministic too). All
    randomness flows from one ``np.random.default_rng(seed)``: the same
    arguments give the same trace, bit for bit, on any platform numpy
    supports (gated by a seeded-replay unit test).
    """
    if n_robots < 1:
        raise ValueError(f"n_robots must be >= 1, got {n_robots}")
    if control_hz <= 0 or arrival_rate <= 0:
        raise ValueError("control_hz and arrival_rate must be positive")
    rng = np.random.default_rng(seed)
    period = 1.0 / control_hz
    trace: List[FleetRequest] = []
    t_join = 0.0
    for r in range(n_robots):
        t_join += float(rng.exponential(1.0 / arrival_rate))
        ctx_len = int(np.clip(
            np.rint(rng.lognormal(np.log(ctx_median), ctx_sigma)),
            tail + 1, ctx_max))
        ctx = rng.integers(0, vocab_size, ctx_len, dtype=np.int32)
        for step in range(steps_per_robot):
            prompt = np.concatenate(
                [ctx, rng.integers(0, vocab_size, tail, dtype=np.int32)])
            trace.append(FleetRequest(
                t=t_join + step * period,
                robot=r,
                step=step,
                kind="episode" if step == 0 else "control",
                prompt=prompt,
                max_tokens=action_tokens,
                deadline_s=period if step else 10 * period,
                priority="realtime" if step else "best_effort"))
    trace.sort(key=lambda e: (e.t, e.robot, e.step))
    return trace
