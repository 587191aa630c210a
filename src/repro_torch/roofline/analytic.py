"""Analytic per-cell cost model (the port's copy of the reference's
``roofline/analytic.py``, with the same arithmetic).

It prices a cell with the operator IR of the paper's XPU simulator
(``core.workload``) applied to the implementation as it runs: the plain
fresh attention computes the full S^2 scores with masking, the capacity
MoE reads every expert's weights, remat runs the forward again. A count
of the program itself (``roofline.counts`` over a meta-device run, see
``launch.dryrun``) is exact and checks it.

Sharding awareness: per-op shard factors follow the same divisibility
rules as the placements (``distributed.sharding``): smollm's 9 heads do
not shard over model=16, so its attention FLOPs replicate.

The one addition to the reference is ``analytic_cell``'s ``mesh=`` (and
``dtype_bytes=``): a one-card mesh ``{"pod": 1, "data": 1, "model": 1}``
prices the card's own runs, where no bytes cross between devices. With
the defaults every result is the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import workload as W
from repro_torch.distributed.sharding import DEFAULT_RULES, INFERENCE_RULES
from repro_torch.models import model as M
from repro_torch.models.params import leaves

BYTES = 2          # bf16
MOMENT_BYTES = 8   # fp32 mu+nu per param element (4+4)


@dataclass
class CellCost:
    flops_per_dev: float
    hbm_bytes_per_dev: float
    coll_bytes_per_dev: float
    breakdown: Dict[str, float] = field(default_factory=dict)


def _divs(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _mesh_sizes(multi_pod: bool):
    return {"pod": 2 if multi_pod else 1, "data": 16, "model": 16}


def params_bytes_per_dev(cfg: ModelConfig, mesh: Dict[str, int],
                         dtype_bytes: int = BYTES,
                         rules: Optional[dict] = None,
                         template: Optional[dict] = None) -> float:
    """Exact per-device parameter bytes under the logical-axis rules.
    ``template`` overrides the priced PSpec tree (e.g. the serving
    projection prices decoder/embed sharded but towers replicated)."""
    rules = rules or DEFAULT_RULES
    if template is None:
        template = M.model_template(cfg)
    total = 0.0
    for _, leaf in leaves(template):
        shard = 1
        used = set()
        for dim, ax in zip(leaf.shape, leaf.axes):
            phys = rules.get(ax) if ax else None
            if phys is None:
                continue
            phys_t = (phys,) if isinstance(phys, str) else tuple(phys)
            phys_t = tuple(a for a in phys_t if a in mesh and a not in used)
            while phys_t and dim % math.prod(mesh[a] for a in phys_t):
                phys_t = phys_t[:-1]
            if phys_t:
                used.update(phys_t)
                shard *= math.prod(mesh[a] for a in phys_t)
        total += float(math.prod(leaf.shape)) * dtype_bytes / shard
    return total


def _op_shard(cfg: ModelConfig, op: W.Op, mesh: Dict[str, int],
              batch_shardable: bool) -> float:
    """How many ways this op's FLOPs divide across the mesh."""
    model = mesh["model"]
    dp = mesh["pod"] * mesh["data"] if batch_shardable else 1
    n = op.name
    tp = 1
    if "/attn" in n or "/wq" in n or "/xq" in n or "/xattn" in n:
        tp = model if _divs(cfg.num_heads, model) else 1
    elif "/wkv" in n:
        tp = model if _divs(cfg.num_kv_heads, model) else 1
    elif "/wo" in n or "/xo" in n:
        tp = model if _divs(cfg.num_heads, model) else 1
    elif "/mlp" in n:
        tp = model if _divs(cfg.d_ff, model) else 1
    elif "/moe" in n:
        e_pad = max(cfg.num_experts_padded, cfg.num_experts)
        tp = model if _divs(e_pad, model) else 1
    elif "/router" in n:
        tp = 1
    elif "/ssm" in n or "/conv1d" in n or "/ssd" in n:
        d_in = cfg.ssm_expand * cfg.d_model
        tp = model if _divs(d_in, model) else 1
    elif "/lm_head" in n:
        tp = model if _divs(cfg.vocab_size, model) else 1
    elif "vision/" in n or "audio/" in n:
        enc = cfg.vision or cfg.encoder
        tp = model if enc and _divs(enc.num_heads, model) else 1
    return float(dp * tp)


def _fwd_ops(cfg: ModelConfig, shape: ShapeConfig, causal_half: bool):
    B = shape.global_batch
    S = shape.seq_len
    if shape.kind == "decode":
        ops = W.decoder_ops(cfg, B, 1, S, decode=True, tag="step")
    else:
        Stext = S
        ops = W.decoder_ops(cfg, B, Stext, Stext, decode=False, tag="step",
                            causal_half=causal_half)
        if cfg.vision is not None:
            ops += W.tower_ops(cfg, cfg.vision, B, "vision")
        if cfg.encoder is not None:
            ops += W.tower_ops(cfg, cfg.encoder, B, "audio")
    return ops


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeConfig,
                   mesh: Dict[str, int], window_cache: bool = False,
                   dtype_bytes: int = BYTES) -> float:
    """Per-device KV/SSM cache bytes (read each decode step); the SSM
    state is f32 whatever ``dtype_bytes``."""
    model, dp = mesh["model"], mesh["pod"] * mesh["data"]
    B = shape.global_batch
    b_shard = dp if _divs(B, dp) else (mesh["data"] if _divs(B, mesh["data"]) else 1)
    total = 0.0
    for i in range(cfg.num_layers):
        if cfg.is_attn_layer(i):
            w = cfg.layer_window(i)
            seq = shape.seq_len
            if window_cache and w:
                seq = min(seq, w)
            kshard = model if _divs(cfg.num_kv_heads, model) else 1
            seq_shard = 1
            if b_shard == 1 and _divs(seq, mesh["data"]):
                seq_shard = mesh["data"]     # kv_seq sequence parallelism
            total += (B * seq * cfg.num_kv_heads * cfg.head_dim * 2
                      * dtype_bytes / (b_shard * kshard * seq_shard))
            if cfg.family == "encdec":
                total += (B * cfg.encoder.num_tokens * cfg.num_kv_heads
                          * cfg.head_dim * 2 * dtype_bytes
                          / (b_shard * kshard))
        elif cfg.family in ("ssm", "hybrid"):
            d_in = cfg.ssm_expand * cfg.d_model
            H = d_in // cfg.ssm_head_dim
            ishard = model if _divs(d_in, model) else 1
            total += (B * H * cfg.ssm_head_dim * cfg.ssm_state * 4
                      / (b_shard * 1)) \
                + B * (cfg.ssm_conv - 1) * (d_in + 2 * cfg.ssm_state) \
                * dtype_bytes / (b_shard * ishard)
    return total


def analytic_cell(cfg: ModelConfig, shape: ShapeConfig, *,
                  multi_pod: bool = False, causal_pairs: bool = False,
                  window_cache: bool = False, remat: bool = True,
                  microbatches: int = 1, moe_gather_decode: bool = False,
                  infer_rules: bool = False, seq_parallel: bool = False,
                  moment_bytes: int = MOMENT_BYTES,
                  mesh: Optional[Dict[str, int]] = None,
                  dtype_bytes: int = BYTES) -> CellCost:
    """The cell's FLOPs, HBM bytes and collective wire bytes per device,
    with a breakdown. ``mesh`` (axis sizes with ``pod``, ``data`` and
    ``model``) defaults to the production mesh of ``multi_pod``; a mesh of
    one device moves no collective bytes. ``dtype_bytes`` is the width of
    the weights, activations and caches (2, bf16, as in the reference; 4
    for an f32 run); the optimizer's moments stay ``moment_bytes``."""
    mesh = mesh or _mesh_sizes(multi_pod)
    chips = mesh["pod"] * mesh["data"] * mesh["model"]
    dp = mesh["pod"] * mesh["data"]
    B = shape.global_batch
    batch_shardable = _divs(B, dp) or _divs(B, mesh["data"])
    eff_dp = dp if _divs(B, dp) else (mesh["data"] if _divs(B, mesh["data"]) else 1)
    wide = dtype_bytes / BYTES     # the workload IR prices bf16 activations

    ops = _fwd_ops(cfg, shape, causal_half=causal_pairs)
    br: Dict[str, float] = {}

    # ---- FLOPs ----
    fwd_flops = 0.0
    for op in ops:
        shard = _op_shard(cfg, op, mesh, batch_shardable)
        if not batch_shardable and "attn" in op.name and shape.kind == "decode":
            # long-context decode: attention shards over kv_seq on 'data'
            shard *= mesh["data"]
        fwd_flops += op.flops / shard
    mult = 1.0
    if shape.kind == "train":
        mult = 3.0 + (1.0 if remat else 0.0)   # fwd + bwd(2x) + remat refwd
    flops = fwd_flops * mult
    br["flops_fwd"] = fwd_flops

    # ---- HBM bytes ----
    template = M.model_template(cfg)
    pb = params_bytes_per_dev(cfg, mesh, dtype_bytes, template=template)
    # per-step working weights: with FSDP rules every step must materialize
    # the data-gathered weights; with inference rules the full model-shard
    # lives in HBM and streams from there.
    pb_nofsdp = params_bytes_per_dev(cfg, mesh, dtype_bytes,
                                     rules=INFERENCE_RULES,
                                     template=template)
    if shape.kind != "train":
        pb_work = pb_nofsdp
    else:
        pb_work = pb
    act = wide * sum(op.act_bytes
                     / max(_op_shard(cfg, op, mesh, batch_shardable), 1)
                     for op in ops)
    hbm = 0.0
    if shape.kind == "train":
        # weights: read fwd + bwd (+ remat refwd), per microbatch
        w_reads = (2.0 + (1.0 if remat else 0.0)) * microbatches
        hbm += pb * w_reads
        # optimizer: read+write params, grads, fp32 moments
        n_params_local = pb / dtype_bytes
        opt = n_params_local * (2 * dtype_bytes + 2 * dtype_bytes
                                + 2 * moment_bytes)
        hbm += opt
        hbm += act * (2.0 + (1.0 if remat else 0.0))
        br["hbm_weights"] = pb * w_reads
        br["hbm_opt"] = opt
        br["hbm_acts"] = act * (2.0 + (1.0 if remat else 0.0))
    elif shape.kind == "prefill":
        hbm += pb_work + act + kv_cache_bytes(cfg, shape, mesh, window_cache,
                                              dtype_bytes)
        br["hbm_weights"] = pb_work
        br["hbm_acts"] = act
    else:  # decode
        wb = pb_work
        if moe_gather_decode and cfg.num_experts:
            # only the top-k experts' weights stream per token (the gather
            # path), at the shard-local ideal
            counts = cfg.param_counts()
            moe_frac = counts["moe"] / max(counts["total"], 1.0)
            hit = W._expected_experts_hit(cfg.num_experts, cfg.top_k, B)
            wb = pb_work * (1.0 - moe_frac * (1.0 - hit / cfg.num_experts))
        cache = kv_cache_bytes(cfg, shape, mesh, window_cache, dtype_bytes)
        hbm += wb + cache + act
        br["hbm_weights"] = wb
        br["hbm_cache"] = cache
        br["hbm_acts"] = act

    # ---- collective bytes (per device, wire) ----
    coll = 0.0
    D = cfg.d_model
    b_loc = max(B / eff_dp, 1)
    s_new = 1 if shape.kind == "decode" else shape.seq_len
    tp_layers = sum(
        1 for i in range(cfg.num_layers)
        if (cfg.is_attn_layer(i) and _divs(cfg.num_heads, mesh["model"]))
        or (not cfg.is_attn_layer(i) and cfg.family in ("ssm", "hybrid")
            and _divs(cfg.ssm_expand * D, mesh["model"]))
        or (cfg.d_ff and _divs(cfg.d_ff, mesh["model"])))
    # sequence-parallel TP turns ARs into RS+AG: half the wire bytes
    ar = 1.0 if seq_parallel else 2.0
    fwd_bwd = 2.0 if shape.kind == "train" else 1.0
    coll += tp_layers * 2 * b_loc * s_new * D * dtype_bytes * ar * fwd_bwd
    br["coll_tp"] = coll
    if cfg.num_experts and _divs(max(cfg.num_experts_padded, cfg.num_experts),
                                 mesh["model"]):
        # EP all-to-all exists only when experts actually shard over 'model'
        moe_layers = sum(1 for i in range(cfg.num_layers)
                         if cfg.is_moe_layer(i))
        a2a = (2 * moe_layers * cfg.top_k * b_loc * s_new * D * dtype_bytes
               * fwd_bwd)
        coll += a2a
        br["coll_ep_a2a"] = a2a
    if shape.kind != "train" and not infer_rules:
        # FSDP rules at inference: the data-sharded weights are gathered
        # when the batch is sharded, but at batch=1 partial-sum activation
        # all-reduces are cheaper: the model takes the smaller.
        weight_ag = max(pb_nofsdp - pb, 0.0)
        act_ar = cfg.num_layers * 2 * b_loc * s_new * D * dtype_bytes * ar
        fsdp = weight_ag if batch_shardable else min(weight_ag, act_ar)
        coll += fsdp
        br["coll_fsdp_ag"] = fsdp
    if shape.kind == "train":
        # DP gradient all-reduce (+ hierarchical inter-pod stage) and FSDP
        # param all-gather / grad reduce-scatter over 'data'
        grad_sync = 2.0 * pb * (2.0 if multi_pod else 1.0)
        fsdp = 2.0 * pb * microbatches
        coll += grad_sync + fsdp
        br["coll_grad_sync"] = grad_sync
        br["coll_fsdp"] = fsdp
    if chips == 1:
        # one device: nothing crosses a link
        coll = 0.0
        br.update({k: 0.0 for k in br if k.startswith("coll_")})

    return CellCost(flops, hbm, coll, br)
