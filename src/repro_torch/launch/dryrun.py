"""Dry run of one (arch x shape) cell on the meta device: the cell's step
runs once at its global shapes with no storage behind any tensor; then
once more partitioned, as DTensors on a fake 256- or 512-rank mesh, under
a count of one device's matrix products and of the collectives it
issues; and the cell's row is written for the roofline (the port's
counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles the cell for a 256- or 512-device mesh).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch]

Runs on the CPU in seconds and needs no card and no JAX. Rows go to
``artifacts/dryrun_torch`` by default, apart from the reference's
``artifacts/dryrun``. A row has the reference's keys, so
``roofline.load_artifacts`` / ``to_terms`` read the rows of both
packages. What differs:

- ``cost.flops`` counts the matrix products one device runs in the
  partitioned trace (``roofline.counts.DotCounter(local=True)``: each
  product on a rank's shards, the function's plain versions on the meta
  device), where the reference reads its compiled program's cost
  analysis; ``roofline.counts.dot_flops`` counts the whole step's;
- ``memory`` holds ``argument_size_in_bytes`` and ``output_size_in_bytes``
  per device, summed from each tensor's placement on the production mesh
  (``launch.specs``). There is no ``temp_size_in_bytes``, because the
  meta device allocates nothing;
- ``collectives`` holds one device's bytes by kind and their ``total``
  (``roofline.counts.CollectiveCounter``: each collective's result bytes,
  the reference's ``hlo.collective_bytes`` convention) of the step traced
  as DTensors on a fake mesh of the production mesh's size
  (``launch.mesh.fake_device_mesh``, rank 0 of 256 or 512 in this one
  process). Every argument is placed by its ``spec_for`` tuple, the
  activations are pinned at the reference's ``constrain`` sites, and
  DTensor's sharding propagation partitions the rest, with the weight
  products, attention cores, cache writes, the MoE dispatch and the
  loss's target pick partitioned explicitly (``distributed.sharding.
  dense`` / ``local_call``). Each layer's collectives are counted (the
  reference's scanned layers count once in its HLO); DTensor's
  resharding differs from XLA's in places (two all-gathers in sequence
  for a dim sharded over two mesh dims, no collective-permute). A trace
  that fails raises: the cell has no row;
- ``hlo_bytes`` is null (there is no HLO); ``t_lower_s`` is the time of
  the meta run and ``t_compile_s`` that of the partitioned trace.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import torch

from repro_torch.configs import SHAPES, get_config, shape_supported
from repro_torch.distributed.sharding import (DEFAULT_RULES, INFERENCE_RULES,
                                              SEQ_PARALLEL_RULES, global_mesh,
                                              serving_rules, spec_for)
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import fake_device_mesh, production_mesh_shape
from repro_torch.models import model as M
from repro_torch.models.layers import ModelOptions
from repro_torch.models.params import map_tree
from repro_torch.roofline.analytic import analytic_cell
from repro_torch.roofline.counts import CollectiveCounter, DotCounter
from repro_torch.roofline.report import model_flops_for
from repro_torch.training import (AdamWConfig, TrainConfig, init_train_state,
                                  make_train_step)

META = SP.META


def build_step(cfg, shape, opts: ModelOptions, tcfg: TrainConfig,
               cache_dtype=SP.CACHE_DTYPE):
    """Returns (fn, argument names) for the cell, on the meta device."""
    if shape.kind == "train":
        step = make_train_step(cfg, opts, tcfg, device=META)
        return step, ("params", "opt_state", "batch")
    if shape.kind == "prefill":
        def prefill_step(params, batch):
            return M.prefill(cfg, opts, params, batch, shape.seq_len,
                             cache_dtype=cache_dtype, device=META)
        return prefill_step, ("params", "batch")

    def serve_step(params, token, caches, index):
        return M.decode_step(cfg, opts, params, token, caches, index,
                             device=META)
    return serve_step, ("params", "token", "caches", "index")


def partitioned(fn, placed_args, sizes, rules):
    """Trace ``fn(*placed_args(mesh))`` partitioned: ``placed_args`` makes
    the step's arguments as DTensors on ``mesh``, a fake mesh of axis
    ``sizes``; the trace runs under the sharding ``rules`` (which
    ``constrain`` reads), with the constants the model builds (positions,
    masks) taken as replicated. Returns (the ``CollectiveCounter``, with
    its counts; a ``DotCounter`` of one device's matrix products; the
    seconds the trace took)."""
    from torch.distributed.tensor.experimental import implicit_replication
    t0 = time.time()
    with fake_device_mesh(sizes) as mesh, global_mesh(mesh, rules):
        args = placed_args(mesh)
        with CollectiveCounter() as counter, DotCounter(local=True) as dots, \
                implicit_replication():
            fn(*args)
    return counter, dots, time.time() - t0


def step_collectives(cfg, shape, sizes, rules, opts=None, tcfg=None,
                     dtype=None):
    """(collective bytes by kind and ``total``, one device's matrix-product
    FLOPs, seconds) of the cell's step partitioned over a fake mesh of
    axis ``sizes`` (``partitioned``): the parameters, inputs and caches
    placed by their ``spec_for`` tuples under ``rules``; a train step's
    AdamW state made from the placed parameters (moments placed as they
    are, the count replicated). ``dtype`` (default: the dry run's bf16
    parameters and caches) gives every floating tensor another type."""
    opts = opts or ModelOptions()
    tcfg = tcfg or TrainConfig(opt=AdamWConfig())
    params, params_pl = SP.model_specs_and_placements(
        cfg, sizes, dtype or SP.PARAM_DTYPE, rules=rules)
    inputs = SP.input_specs(cfg, shape, opts)
    if dtype is not None:
        inputs = map_tree(lambda t: (torch.empty(t.shape, dtype=dtype,
                                                 device=META)
                                     if t.is_floating_point() else t),
                          inputs)
    in_pl = SP.input_placements(cfg, shape, sizes, opts, rules)
    fn, order = build_step(cfg, shape, opts, tcfg,
                           cache_dtype=dtype or SP.CACHE_DTYPE)

    def placed(mesh):
        out = []
        for name in order:
            if name == "params":
                out.append(SP.as_dtensors(params, params_pl, mesh))
            elif name == "opt_state":
                out.append(init_train_state(cfg, tcfg, out[0]))
            else:
                out.append(SP.as_dtensors(inputs[name], in_pl[name], mesh))
        return out
    counter, dots, seconds = partitioned(fn, placed, sizes, rules)
    return counter.counts(), dots.total, seconds


def serving_decode_collectives(cfg, n_model: int, batch: int, max_seq: int,
                               dtype=torch.float32) -> dict:
    """Collective bytes one device issues in one decode step of the sharded
    serving engine (``ServingEngine(mesh=...)`` over a ``model`` mesh of
    ``n_model`` ranks, ``serving_rules``), from the dry run's trace: the
    step as DTensors on a fake ('model',) mesh with parameters in
    ``dtype``, a dense cache of ``max_seq`` rows and ``batch`` slots, and
    the logits gathered whole for sampling, as the engine's rank 0
    samples them. ``ShardGroup.counts()`` of the engine's step should
    equal it."""
    from torch.distributed.tensor import Replicate
    opts = ModelOptions()
    sizes = {"model": n_model}
    rules = serving_rules(n_model, cfg.num_heads, cfg.num_kv_heads)
    params, params_pl = SP.model_specs_and_placements(cfg, sizes, dtype,
                                                      rules=rules)
    caches = M.init_caches(cfg, batch, max_seq, dtype, opts, device=META)
    caches_pl = SP.cache_placements(cfg, batch, max_seq, sizes, opts, rules)
    token = torch.empty((batch, 1), dtype=torch.int32, device=META)
    index = torch.empty((batch,), dtype=torch.int32, device=META)

    def step(params, token, caches, index):
        logits, _ = M.decode_step(cfg, opts, params, token, caches, index,
                                  device=META)
        return logits.redistribute(placements=[Replicate()])

    def placed(mesh):
        return (SP.as_dtensors(params, params_pl, mesh),
                SP.as_dtensors(token, (None, None), mesh),
                SP.as_dtensors(caches, caches_pl, mesh),
                SP.as_dtensors(index, (None,), mesh))
    return partitioned(step, placed, sizes, rules)[0].counts()


def _output_bytes(cfg, shape, opts, out, mesh, rules, params_pl) -> float:
    """Per-device bytes of the step's outputs: a train step's parameters
    and optimizer state placed as its arguments (its metrics are scalars,
    replicated); a prefill's or decode step's logits over (batch, vocab)
    and its caches over the cache template's axes."""
    if shape.kind == "train":
        new_params, new_state, metrics = out
        return (SP.tree_bytes_per_dev(new_params, params_pl, mesh)
                + _state_bytes(new_state, params_pl, mesh)
                + sum(float(t.element_size()) for t in metrics.values()))
    logits, caches = out
    lg = SP.tree_bytes_per_dev(
        logits, spec_for(logits.shape, ("batch", None, "act_vocab"), mesh,
                         rules), mesh)
    return lg + SP.tree_bytes_per_dev(
        caches, SP.cache_placements(cfg, logits.shape[0], shape.seq_len,
                                    mesh, opts, rules), mesh)


def _state_bytes(state, params_pl, mesh) -> float:
    """AdamW's moments placed as the parameters; its count replicated."""
    inner = state["inner"]
    n = (SP.tree_bytes_per_dev(inner["mu"], params_pl, mesh)
         + SP.tree_bytes_per_dev(inner["nu"], params_pl, mesh)
         + float(inner["count"].element_size()))
    if "error" in state:
        n += SP.tree_bytes_per_dev(state["error"], params_pl, mesh)
    return n


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir: Optional[str] = None, opts: Optional[ModelOptions] = None,
             microbatches: int = 1, moment_dtype: str = "float32",
             infer_rules: bool = False, seq_parallel: bool = False,
             pad_experts: int = 0, tag: str = "", verbose: bool = True) -> dict:
    cfg = get_config(arch)
    if pad_experts:
        cfg = dataclasses.replace(cfg, num_experts_padded=pad_experts)
    shape = SHAPES[shape_name]
    ok, why = shape_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    opts = opts or ModelOptions()
    tcfg = TrainConfig(opt=AdamWConfig(moment_dtype=getattr(torch,
                                                            moment_dtype)),
                       microbatches=microbatches)
    mesh = production_mesh_shape(multi_pod=multi_pod)
    mesh_name = "multi_pod" if multi_pod else "single_pod"
    rules = dict(DEFAULT_RULES)
    if infer_rules:
        rules.update(INFERENCE_RULES)
    if seq_parallel:
        rules.update({k: v for k, v in SEQ_PARALLEL_RULES.items()
                      if k == "act_seq"})

    params, params_pl = SP.model_specs_and_placements(cfg, mesh, rules=rules)
    inputs = SP.input_specs(cfg, shape, opts)
    in_pl = SP.input_placements(cfg, shape, mesh, opts, rules)
    fn, order = build_step(cfg, shape, opts, tcfg)

    args, arg_bytes = [], 0.0
    for name in order:
        if name == "params":
            args.append(params)
            arg_bytes += SP.tree_bytes_per_dev(params, params_pl, mesh)
        elif name == "opt_state":
            state = init_train_state(cfg, tcfg, params)
            args.append(state)
            arg_bytes += _state_bytes(state, params_pl, mesh)
        else:
            args.append(inputs[name])
            arg_bytes += SP.tree_bytes_per_dev(inputs[name], in_pl[name],
                                               mesh)

    t0 = time.time()
    out = fn(*args)
    t_lower = time.time() - t0
    out_bytes = _output_bytes(cfg, shape, opts, out, mesh, rules, params_pl)

    collectives, flops, t_part = step_collectives(cfg, shape, mesh, rules,
                                                  opts, tcfg)

    ac = analytic_cell(cfg, shape, multi_pod=multi_pod,
                       causal_pairs=opts.causal_pairs,
                       window_cache=opts.window_cache, remat=opts.remat,
                       microbatches=microbatches, infer_rules=infer_rules, seq_parallel=seq_parallel)
    counts = cfg.param_counts()
    row = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "kind": shape.kind,
        "cost": {"flops": flops},
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes},
        "collectives": collectives,
        "analytic": {"flops_per_dev": ac.flops_per_dev,
                     "hbm_bytes_per_dev": ac.hbm_bytes_per_dev,
                     "coll_bytes_per_dev": ac.coll_bytes_per_dev,
                     "breakdown": ac.breakdown},
        "model_flops": model_flops_for(cfg, shape),
        "params_total": counts["total"],
        "params_active": counts["active"],
        "t_lower_s": t_lower, "t_compile_s": t_part,
        "hlo_bytes": None,
    }
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: "
              f"flops/dev={flops:.6e} (counted) "
              f"args/dev={arg_bytes / 2**30:.3f}GiB "
              f"out/dev={out_bytes / 2**30:.3f}GiB "
              f"coll/dev={collectives['total']:.6e} "
              f"analytic flops/dev={ac.flops_per_dev:.6e} "
              f"(meta run {t_lower:.1f}s, partitioned trace "
              f"{t_part:.1f}s)")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"-{tag}" if tag else ""
        fname = f"{arch}__{shape_name}__{mesh_name}{suffix}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(row, f, indent=1)
    return row


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--shape", required=True, choices=list(SHAPES))
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default="artifacts/dryrun_torch")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--tag", default="")
    p.add_argument("--causal-pairs", action="store_true")
    p.add_argument("--window-cache", action="store_true")
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--infer-rules", action="store_true",
                   help="inference sharding rules (no FSDP)")
    p.add_argument("--seq-parallel", action="store_true",
                   help="sequence-parallel TP residual sharding")
    p.add_argument("--moe-per-seq", action="store_true",
                   help="per-sequence-local MoE dispatch")
    p.add_argument("--pad-experts", type=int, default=0,
                   help="pad the expert dim to divide the TP axis")
    p.add_argument("--moe-gather", action="store_true",
                   help="tiny-batch decode: gather top-k expert weights")
    p.add_argument("--remat-sublayers", action="store_true",
                   help="nested per-sublayer remat")
    args = p.parse_args(argv)
    opts = ModelOptions(causal_pairs=args.causal_pairs,
                        window_cache=args.window_cache,
                        remat=not args.no_remat,
                        moe_per_seq_dispatch=args.moe_per_seq,
                        moe_gather_decode=args.moe_gather,
                        remat_sublayers=args.remat_sublayers)
    row = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   out_dir=args.out, opts=opts,
                   microbatches=args.microbatches, tag=args.tag,
                   infer_rules=args.infer_rules,
                   seq_parallel=args.seq_parallel,
                   pad_experts=args.pad_experts)
    if "skipped" in row:
        print(f"[dryrun] SKIP {args.arch} x {args.shape}: {row['skipped']}")
    return row


if __name__ == "__main__":
    main()
