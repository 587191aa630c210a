"""Roofline terms from dry-run rows and measured runs (the port's copy of
the reference's ``roofline/report.py``):

    compute term    = FLOPs_per_device / peak FLOP/s
    memory term     = HBM_bytes_per_device / HBM rate
    collective term = collective_bytes_per_device / link rate

The reference prices on ``TPU_V5E`` with 256 or 512 chips; here the
hardware and the chip count are fields: ``TPU_V5E`` gives every term the
reference's, ``H100_SXM`` prices the card (data-sheet peaks, not a
measurement). The chip count defaults by mesh name: ``single_pod`` 256,
``multi_pod`` 512, ``one_card`` 1.
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.hardware import TPU_V5E, Hardware

MESH_CHIPS = {"single_pod": 256, "multi_pod": 512, "one_card": 1}


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float           # 6*N*D (dense) / 6*N_active*D (MoE)
    temp_bytes_per_dev: float = 0.0
    arg_bytes_per_dev: float = 0.0
    hardware: Hardware = field(default=TPU_V5E, repr=False)
    chips: Optional[int] = None  # None: MESH_CHIPS[mesh]
    peak_tflops: Optional[float] = None   # None: hardware.bf16_tflops (an
    #                                       f32 run passes its f32 peak)

    @property
    def n_chips(self) -> int:
        return self.chips if self.chips is not None else MESH_CHIPS[self.mesh]

    @property
    def _peak(self) -> float:
        tf = self.peak_tflops if self.peak_tflops is not None \
            else self.hardware.bf16_tflops
        return tf * 1e12

    @property
    def t_compute(self) -> float:
        return self.flops_per_dev / self._peak

    @property
    def t_memory(self) -> float:
        return self.bytes_per_dev / (self.hardware.mem_bw_gbs * 1e9)

    @property
    def t_collective(self) -> float:
        if not self.coll_bytes_per_dev:
            return 0.0
        return self.coll_bytes_per_dev / (self.hardware.ici_gbs * 1e9)

    @property
    def dominant(self) -> str:
        t = {"compute": self.t_compute, "memory": self.t_memory,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): remat and redundancy
        waste."""
        hlo_global = self.flops_per_dev * self.n_chips
        return self.model_flops / max(hlo_global, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the roofline-bound step time."""
        t_useful = self.model_flops / self.n_chips / self._peak
        return t_useful / max(self.bound_time, 1e-30)

    def row(self) -> Dict:
        d = asdict(self)
        d["hardware"] = self.hardware.name
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def model_flops_for(cfg, shape) -> float:
    """6*N_active*D for training; 2*N_active*D for single forward/decode."""
    n = cfg.param_counts()["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def load_artifacts(art_dir: str) -> List[Dict]:
    rows = []
    for f in sorted(os.listdir(art_dir)):
        if f.endswith(".json"):
            with open(os.path.join(art_dir, f)) as fh:
                rows.append(json.load(fh))
    return rows


def to_terms(row: Dict, use_analytic: bool = True,
             hardware: Hardware = TPU_V5E) -> RooflineTerms:
    """Roofline terms of a dry-run row, the reference's or the port's.

    use_analytic=True (default) prices with the operator-IR model
    (``roofline.analytic``); False takes the row's own counts: its
    per-device FLOPs and counted collective bytes
    (``row["collectives"]["total"]``: the dry run's partitioned trace, or a
    sharded engine's ``ShardGroup.counts()``). A row without counted
    collectives raises rather than report a zero."""
    an = row.get("analytic") if use_analytic else None
    if an:
        flops, bts, coll = (an["flops_per_dev"], an["hbm_bytes_per_dev"],
                            an["coll_bytes_per_dev"])
    else:
        if row.get("collectives") is None:
            raise ValueError(
                f"{row['arch']} x {row['shape']}: the row has no counted "
                "collective bytes; price it with use_analytic=True")
        flops = row["cost"].get("flops", 0.0)
        bts = row["cost"].get("bytes accessed", 0.0)
        coll = row["collectives"].get("total", 0.0)
    return RooflineTerms(
        arch=row["arch"], shape=row["shape"], mesh=row["mesh"],
        flops_per_dev=flops, bytes_per_dev=bts, coll_bytes_per_dev=coll,
        model_flops=row["model_flops"],
        temp_bytes_per_dev=row["memory"].get("temp_size_in_bytes", 0.0),
        arg_bytes_per_dev=row["memory"].get("argument_size_in_bytes", 0.0),
        hardware=hardware)


@dataclass
class ServingProjection:
    """Per-device view of a sharded serving engine (mesh shape in ->
    per-device cache + weight bytes and the bandwidth-bound tick floor)."""
    arch: str
    mesh_model: int
    heads_sharded: bool          # serving rule table outcome (GQA-atomic)
    weight_bytes_per_dev: float
    cache_bytes_per_dev: float
    cache_bytes_total: float     # the engine's summed figure, for reference
    hardware: Hardware = field(default=TPU_V5E, repr=False)

    @property
    def t_tick_s(self) -> float:
        """Bandwidth-bound decode-tick floor: one full weight + live-cache
        HBM pass per decoded token (the paper's memory-bound action
        generation term), at the per-device slice sizes."""
        return ((self.weight_bytes_per_dev + self.cache_bytes_per_dev)
                / (self.hardware.mem_bw_gbs * 1e9))

    def row(self) -> Dict:
        d = asdict(self)
        d["hardware"] = self.hardware.name
        d["t_tick_s"] = self.t_tick_s
        return d


def serving_projection(cfg, n_model: int, cache_bytes_total: float,
                       weight_dtype_bytes: int = 2,
                       hardware: Hardware = TPU_V5E) -> ServingProjection:
    """Project a single-device serving measurement onto a ``model=n_model``
    mesh, from the serving rule table (``distributed.serving_rules``).

    ``cache_bytes_total`` is the engine's summed cache figure
    (``EngineStats.cache_bytes_hwm``). Every paged leaf (K/V pools and
    their scale siblings) carries the KV-head axis, so per-device cache
    bytes are exactly ``total / n_model`` when the serving rules shard the
    head axis and ``total`` when GQA-atomic divisibility forces the
    replication fallback (smollm's 9/3 heads over model=2). Weights price
    through the analytic per-device pricer under the serving rules, with
    the tower parameters (vision / action head) held replicated."""
    from repro_torch.distributed.sharding import serving_rules
    from repro_torch.models import model as M
    from repro_torch.models.params import leaves
    from repro_torch.roofline.analytic import params_bytes_per_dev
    rules = serving_rules(n_model, cfg.num_heads, cfg.num_kv_heads)
    heads_sharded = rules["kv_heads"] is not None and n_model > 1
    templ = M.model_template(cfg)
    towers = [templ.pop(k) for k in ("vision", "encoder", "action_dit")
              if k in templ]
    wb = params_bytes_per_dev(cfg, {"model": n_model}, weight_dtype_bytes,
                              rules, template=templ)
    wb += sum(float(np.prod(leaf.shape)) * weight_dtype_bytes
              for t in towers for _, leaf in leaves(t))
    return ServingProjection(
        arch=cfg.name, mesh_model=n_model, heads_sharded=heads_sharded,
        weight_bytes_per_dev=wb,
        cache_bytes_per_dev=float(cache_bytes_total)
        / (n_model if heads_sharded else 1),
        cache_bytes_total=float(cache_bytes_total), hardware=hardware)


def markdown_table(rows: List[RooflineTerms]) -> str:
    hdr = ("| arch | shape | mesh | t_compute | t_memory | t_collective | "
           "dominant | useful/counted | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.mesh} | {r.t_compute:.3e}s "
            f"| {r.t_memory:.3e}s | {r.t_collective:.3e}s | {r.dominant} "
            f"| {r.useful_flops_ratio:.2f} | {r.roofline_fraction:.3f} |")
    return "\n".join(lines)
