"""Meta-tensor input stand-ins and their placements for every (arch x
shape) cell: the surface the dry run runs against (the port's counterpart
of the reference's ``launch/specs.py``, whose ShapeDtypeStructs become
tensors on the meta device and whose NamedShardings become ``spec_for``
tuples over a mesh's axis sizes). Nothing is allocated."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.sharding import (dtensor_placements, local_shape,
                                              mesh_sizes, shard_bytes,
                                              spec_for)
from repro_torch.models import model as M
from repro_torch.models import stacks
from repro_torch.models.layers import ModelOptions
from repro_torch.models.params import leaves, map_tree, meta_params

CACHE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.bfloat16
META = torch.device("meta")


def text_len(cfg: ModelConfig, total_seq: int) -> int:
    """Text-token count once the vision prefix is folded into the sequence."""
    if cfg.vision is not None:
        return total_seq - cfg.vision.num_tokens
    return total_seq


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    B = shape.global_batch
    S = text_len(cfg, shape.seq_len)
    out = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    if cfg.vision is not None:
        out["patches"] = torch.empty(
            (B, cfg.vision.num_tokens, cfg.vision.embed_dim),
            dtype=PARAM_DTYPE, device=META)
    if cfg.encoder is not None:
        out["frames"] = torch.empty(
            (B, cfg.encoder.num_tokens, cfg.encoder.embed_dim),
            dtype=PARAM_DTYPE, device=META)
    return out


def batch_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    out = {"tokens": ("batch", "act_seq")}
    if cfg.vision is not None:
        out["patches"] = ("batch", None, None)
    if cfg.encoder is not None:
        out["frames"] = ("batch", None, None)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                opts: Optional[ModelOptions] = None) -> Dict:
    """All inputs for the cell's step function, as meta tensors.

    train/prefill: {'batch': ...}
    decode:        {'token', 'caches', 'index'} with a seq_len-deep cache.
    """
    opts = opts or ModelOptions()
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs(cfg, shape)}
    B = shape.global_batch
    return {
        "token": torch.empty((B, 1), dtype=torch.int32, device=META),
        "caches": M.init_caches(cfg, B, shape.seq_len, CACHE_DTYPE, opts,
                                device=META),
        "index": torch.empty((), dtype=torch.int32, device=META),
    }


def cache_placements(cfg: ModelConfig, batch: int, max_seq: int, mesh,
                     opts: Optional[ModelOptions] = None,
                     rules: Optional[dict] = None) -> Dict:
    """``spec_for`` tuples of a dense decode cache's leaves."""
    t = stacks.cache_template(cfg, batch, max_seq, opts)
    return map_tree(lambda s: spec_for(s.shape, s.axes, mesh, rules), t)


def input_placements(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     opts: Optional[ModelOptions] = None,
                     rules: Optional[dict] = None) -> Dict:
    """Placements matching ``input_specs``: one ``spec_for`` tuple per
    tensor, over ``mesh``'s axis sizes."""
    if shape.kind in ("train", "prefill"):
        specs = batch_specs(cfg, shape)
        axes = batch_axes(cfg)
        return {"batch": {k: spec_for(specs[k].shape, axes[k], mesh, rules)
                          for k in specs}}
    B = shape.global_batch
    return {
        "token": spec_for((B, 1), ("batch", None), mesh, rules),
        "caches": cache_placements(cfg, B, shape.seq_len, mesh, opts, rules),
        "index": spec_for((), (), mesh, rules),
    }


def model_specs_and_placements(cfg: ModelConfig, mesh, dtype=PARAM_DTYPE,
                               rules: Optional[dict] = None):
    """(meta parameters, their ``spec_for`` tuples)."""
    template = M.model_template(cfg)
    return (meta_params(template, dtype),
            map_tree(lambda s: spec_for(s.shape, s.axes, mesh, rules),
                     template))


def tree_bytes_per_dev(tree, placements, mesh) -> float:
    """Bytes one device holds of a tree of tensors placed by a tree of
    ``spec_for`` tuples of the same layout."""
    place = dict(leaves(placements)) if isinstance(placements, dict) else \
        {"": placements}
    items = leaves(tree) if isinstance(tree, dict) else [("", tree)]
    return sum(shard_bytes(t.shape, place[path], mesh, t.element_size())
               for path, t in items)


def as_dtensors(tree, placements, mesh):
    """A tree of meta tensors as DTensors on the ``DeviceMesh`` ``mesh``,
    each placed by its ``spec_for`` tuple in ``placements`` (a tree of the
    same layout, or one tuple for a single tensor): each rank's shard is a
    meta tensor of its local shape."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: as_dtensors(v, placements[k], mesh)
                for k, v in tree.items()}
    local = torch.empty(local_shape(tree.shape, placements,
                                    mesh_sizes(mesh)),
                        dtype=tree.dtype, device=META)
    return DTensor.from_local(local, mesh,
                              dtensor_placements(placements, mesh),
                              run_check=False, shape=tree.shape,
                              stride=tree.stride())
