"""Parameter templates, seeded initialisation and the bridge from the JAX
reference's parameters.

A template is a nested dict whose leaves are ``PSpec`` (shape + logical
axes + init); the parameters are the same nested dict with tensors at the
leaves, in the reference's layout (stacked layers on a leading ``"layers"``
axis), so a parameter tree of the reference maps onto the port leaf for
leaf. The logical axes name each dim for the rule tables of
``distributed.sharding`` (the dry run's placements, the analytic cost
model's per-device bytes, and each rank's slice of a sharded serving
engine: ``shard_params``, ``shard_template``, and the ``shard`` hook of
``init_params`` / ``from_jax``, which slices each leaf as it is made so
that no rank holds the whole tree).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.sharding import (local_shape, rank_coords,
                                              shard_slice, spec_for)

# the towers run as plain stacks with no collective in them, so every
# shard keeps them whole (the reference's engine does the same)
WHOLE = ("vision", "encoder", "action_dit")


@dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | ssm_a | ssm_dt | pos
    fan_in: Optional[int] = None

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)

    @property
    def stacked(self) -> bool:
        """Whether the leading axis is a stack of layers."""
        return bool(self.axes) and self.axes[0] == "layers"


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def stack(template, n: int, axis_name: Optional[str] = "layers"):
    """Prepend a stacked dimension named ``axis_name`` to every leaf of a
    layer template."""
    return {k: (stack(v, n, axis_name) if isinstance(v, dict) else
                dataclasses.replace(v, shape=(n,) + v.shape,
                                    axes=(axis_name,) + v.axes))
            for k, v in template.items()}


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs of a nested dict, in sorted key order (the order
    in which the reference flattens its pytrees)."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from leaves(v, path)
        else:
            yield path, v


def map_tree(fn, tree, *rest):
    """``fn`` applied leaf by leaf over nested dicts of one layout (the
    first tree's keys)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def set_leaf(tree: Dict, path: str, value) -> None:
    """Store ``value`` at a "/"-joined ``path`` of a nested dict."""
    *parents, last = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[last] = value


def _scale(spec: PSpec) -> float:
    if spec.init == "pos":
        return 0.02
    fan_in = spec.fan_in
    if fan_in is None:
        fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1))


def _init_leaf(spec: PSpec, gen, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init not in ("normal", "pos", "ssm_a", "ssm_dt"):
        raise ValueError(f"init {spec.init!r} is not used by this port")
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    # a stacked leaf is drawn one layer at a time, so no f32 copy of a
    # whole stack exists (stacked wi of molmoact-7b is 7.6 GB in f32)
    for part in (out.unbind(0) if spec.stacked else (out,)):
        part.copy_(_draw(spec, part.shape, gen, device))
    return out


def _draw(spec: PSpec, shape, gen, device):
    """One f32 draw of ``spec``'s init: normal * scale, or the Mamba2
    inits: ``ssm_a`` is A_log = log(U[1, 16]); ``ssm_dt`` is the dt bias
    whose softplus is exp(U[log 1e-3, log 1e-1])."""
    if spec.init in ("normal", "pos"):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * _scale(spec)
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    if spec.init == "ssm_a":
        return torch.log(1.0 + 15.0 * u)
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + (hi - lo) * u)
    return dt + torch.log(-torch.expm1(-dt))


def init_params(template, generator: torch.Generator,
                dtype=torch.float32, device="cuda", shard=None):
    """Random parameters for a template: normal * 1/sqrt(fan_in), ``ones``,
    ``zeros``, normal * 0.02 for ``pos``, or the Mamba2 ``ssm_a`` /
    ``ssm_dt`` draws (see ``_draw``), leaf by leaf on
    ``device`` from ``generator`` (which must live on that device). The
    draws differ from the reference's ``jax.random``; use ``from_jax`` for
    the reference's own weights. ``shard(path, spec, leaf)`` (e.g.
    ``shard_fn``) replaces each leaf as soon as it is drawn: the draws are
    the unsharded ones, and only one whole leaf exists at a time."""
    dev = resolve_device(device)
    if torch.device(generator.device).type != dev.type:
        raise ValueError(f"generator on {generator.device}, params on {dev}")
    params: Dict = {}
    for path, spec in leaves(template):
        leaf = _init_leaf(spec, generator, dtype, dev)
        set_leaf(params, path, shard(path, spec, leaf) if shard else leaf)
    return params


def shard_fn(mesh, rules: dict, rank: int, whole=WHOLE):
    """``shard(path, spec, leaf)`` for ``init_params`` / ``from_jax`` /
    ``shard_params``: the rank's slice of a whole leaf under
    ``spec_for(spec.shape, spec.axes, mesh, rules)``; leaves under the
    top-level keys ``whole`` stay whole."""
    coords = rank_coords(mesh)[rank]

    def fn(path, spec, leaf):
        if path.split("/")[0] in whole:
            return leaf
        return shard_slice(leaf, spec_for(spec.shape, spec.axes, mesh,
                                          rules), mesh, coords)
    return fn


def shard_template(template, mesh, rules: dict, whole=WHOLE):
    """The template of one rank's shard: every leaf at its local shape
    (``whole`` top-level keys as they are)."""
    out: Dict = {}
    for path, spec in leaves(template):
        if path.split("/")[0] not in whole:
            spec = dataclasses.replace(spec, shape=local_shape(
                spec.shape, spec_for(spec.shape, spec.axes, mesh, rules),
                mesh))
        set_leaf(out, path, spec)
    return out


def shard_params(template, params, mesh, rules: dict, rank: int,
                 whole=WHOLE):
    """Rank ``rank``'s shard of ``params``, leaf by leaf: a leaf at the
    template's (whole) shape is sliced; one already at the rank's local
    shape is taken as it is; any other shape raises."""
    fn = shard_fn(mesh, rules, rank, whole)
    local = dict(leaves(shard_template(template, mesh, rules, whole)))
    src = dict(leaves(params))
    out: Dict = {}
    for path, spec in leaves(template):
        x = src[path]
        if tuple(x.shape) == tuple(spec.shape):
            x = fn(path, spec, x)
        elif tuple(x.shape) != tuple(local[path].shape):
            raise ValueError(f"{path}: shape {tuple(x.shape)} is neither "
                             f"the whole {spec.shape} nor the shard "
                             f"{local[path].shape}")
        set_leaf(out, path, x)
    return out


def meta_params(template, dtype=torch.bfloat16):
    """The template's leaves as meta tensors of ``dtype``: shapes without
    storage, the counterpart of the reference's ``param_shapes`` (which
    returns ShapeDtypeStructs) for a run on the meta device."""
    params: Dict = {}
    for path, spec in leaves(template):
        set_leaf(params, path, torch.empty(spec.shape, dtype=dtype,
                                           device="meta"))
    return params


def from_jax(template, tree, dtype=None, device="cuda", shard=None):
    """Map the reference's parameter pytree (a nested dict of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``, or a flat dict keyed by
    "/"-joined paths) onto the port's parameters. Every leaf of ``tree``
    must be consumed and every leaf of ``template`` filled, with equal
    shapes; anything else raises. ``shard`` as in ``init_params``."""
    dev = resolve_device(device)
    src = dict(leaves(tree))
    params: Dict = {}
    for path, spec in leaves(template):
        if path not in src:
            raise KeyError(f"reference tree has no leaf {path!r}")
        arr = np.asarray(src.pop(path))
        if arr.dtype.kind != "f":          # bfloat16 arrives as a numpy
            arr = arr.astype(np.float32)   # extension type
        if tuple(arr.shape) != tuple(spec.shape):
            raise ValueError(f"{path}: reference shape {arr.shape}, port "
                             f"shape {spec.shape}")
        t = torch.from_numpy(np.array(arr))       # a writable copy
        t = t.to(device=dev, dtype=dtype or t.dtype)
        set_leaf(params, path, shard(path, spec, t) if shard else t)
    if src:
        raise KeyError(f"reference leaves the port does not use: "
                       f"{sorted(src)}")
    return params


def param_count(template) -> int:
    return sum(int(np.prod(s.shape)) for _, s in leaves(template))
