"""Logical-axis sharding rules (the port's copy of the reference's
``distributed.sharding`` rule tables) with its divisibility-aware walk.

Parameters and caches name each dim with a *logical* axis (``PSpec.axes``);
a rule table maps a logical axis to a physical mesh axis (or a tuple of
them). A dim shards only if its size divides by the mesh axes' product,
dropping trailing axes until it does, and no physical axis is used twice
in one leaf: otherwise it replicates (smollm's 9 heads replicate over
model=16 while its mlp and vocab dims shard). One rule table so stays
valid for every architecture.

A mesh here is its axis sizes: a mapping of axis name to size, or any
object with such a ``.shape`` (``launch.mesh.production_mesh_shape``, a
``launch.mesh.Mesh``). The port has no partitioner: a sharded program
places every tensor by hand, slicing each leaf to a rank's shard from its
``spec_for`` entries (``shard_slice``), and ``constrain`` is the identity.
``Placed`` holds a tensor as the shards of every rank of a mesh (the
elastic shrink gathers and re-slices it).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import (Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch

Axes = Tuple[Optional[str], ...]
Entry = Union[None, str, Tuple[str, ...]]

# logical axis -> physical mesh axis (or tuple of axes). None = replicate.
DEFAULT_RULES = {
    # parameter axes
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "ssm_inner": "model",
    "embed": "data",          # FSDP / ZeRO-3 style weight sharding
    "embed_noshard": None,
    "layers": None,
    "blocks": None,
    "inner": None,
    "head_dim": None,
    "ssm_state": None,
    "conv": None,
    # activation axes
    "batch": ("pod", "data"),
    "act_seq": None,
    "kv_seq": "data",         # sequence-parallel KV cache (long-context decode)
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_experts": "model",
    "act_embed": None,
    "act_vocab": "model",
}

# Inference rules: FSDP ('embed' -> data) is wrong for decode, because it
# gathers every weight over the data axis each step where reading the
# locally stored shard would do. Parameters replicate over 'data'; the MoE
# expert width takes the freed 'data' axis, so a mega-MoE (arctic 480B)
# still stores 1/256 of its experts per device.
INFERENCE_RULES = {**DEFAULT_RULES, "embed": None, "mlp": ("model", "data")}

# Sequence-parallel tensor parallelism (Korthikanti et al.): the residual
# stream's sequence dim shards over 'model' between the attention and MLP
# regions, which turns each layer's all-reduces into a reduce-scatter and
# an all-gather (half the wire bytes).
SEQ_PARALLEL_RULES = {**DEFAULT_RULES, "act_seq": "model"}

# Serving (tensor parallelism over a one-axis 'model' mesh): batch is the
# engine's slot axis and never shards, the KV cache partitions on its head
# axis only (kv_seq parallelism would split pages mid-stream), and weights
# replicate over everything but 'model' (the INFERENCE_RULES argument).
SERVING_RULES = {**INFERENCE_RULES,
                 "mlp": "model",
                 "batch": None,
                 "kv_seq": None,
                 "act_seq": None}


def serving_rules(n_model: int, num_heads: int, num_kv_heads: int) -> dict:
    """SERVING_RULES specialized to one model: the head axes shard only if
    *both* ``num_heads`` and ``num_kv_heads`` divide the model-axis size,
    else both replicate.

    Per-leaf divisibility (``spec_for``) is not enough for GQA: it would
    shard 16 query heads over model=4 while replicating 9 KV heads, and
    the grouped head mapping (query head ``n`` reads KV head ``n // G``)
    would pair the wrong heads when only one side is local. Sharding both
    or neither keeps the local group structure the global one (smollm's
    9/3 heads replicate over model=2, 4; shard over model=3). MLP and
    vocab dims still fall back per leaf."""
    heads_ok = (num_heads % n_model == 0) and (num_kv_heads % n_model == 0)
    head_ax = "model" if heads_ok else None
    return {**SERVING_RULES,
            "heads": head_ax, "kv_heads": head_ax,
            "act_heads": head_ax, "act_kv_heads": head_ax}


def mesh_sizes(mesh) -> Mapping[str, int]:
    """Axis name -> size of a mesh given as a mapping or by its
    ``.shape``."""
    return mesh if isinstance(mesh, Mapping) else mesh.shape


def axis_size(mesh, phys: Entry) -> int:
    """Devices along a ``spec_for`` entry (1 for a replicated dim)."""
    sizes = mesh_sizes(mesh)
    if phys is None:
        return 1
    n = 1
    for a in ((phys,) if isinstance(phys, str) else phys):
        n *= sizes[a]
    return n


class _State(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict = dict(DEFAULT_RULES)


_STATE = _State()


@contextlib.contextmanager
def global_mesh(mesh, rules: Optional[dict] = None):
    """Activate a mesh (and rule overrides) for ``sharding_for`` and
    ``spec_for`` on this thread (two replicas' threads keep their own)."""
    prev_mesh, prev_rules = _STATE.mesh, _STATE.rules
    _STATE.mesh = mesh
    if rules is not None:
        _STATE.rules = {**DEFAULT_RULES, **rules}
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev_mesh, prev_rules


def get_mesh():
    """The mesh ``global_mesh`` activated on this thread, or None."""
    return _STATE.mesh


def spec_for(shape: Sequence[int], axes: Axes, mesh,
             rules: Optional[dict] = None) -> Tuple[Entry, ...]:
    """One entry per dim of ``shape`` given its logical ``axes``: None
    (replicated), a physical axis name, or a tuple of names. It honours
    divisibility (trailing physical axes are dropped until the dim
    divides) and never uses a physical axis twice. ``rules`` defaults to
    the thread's (DEFAULT_RULES outside ``global_mesh``)."""
    rules = rules or _STATE.rules
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries = []
    for dim, name in zip(shape, axes):
        phys = rules.get(name) if name else None
        if phys is None:
            entries.append(None)
            continue
        phys_t = (phys,) if isinstance(phys, str) else tuple(phys)
        # drop already-used axes and axes unknown to this mesh
        phys_t = tuple(a for a in phys_t if a in sizes and a not in used)
        # honour divisibility: drop trailing axes until it divides
        while phys_t and dim % axis_size(sizes, phys_t) != 0:
            phys_t = phys_t[:-1]
        if not phys_t:
            entries.append(None)
            continue
        used.update(phys_t)
        entries.append(phys_t[0] if len(phys_t) == 1 else phys_t)
    return tuple(entries)


def shard_bytes(shape: Sequence[int], spec: Sequence[Entry], mesh,
                itemsize: int) -> float:
    """Bytes one device holds of a ``shape`` leaf placed by ``spec``."""
    n = float(itemsize)
    for dim in shape:
        n *= dim
    for entry in spec:
        n /= axis_size(mesh, entry)
    return n


def sharding_for(shape: Sequence[int], axes: Axes, mesh=None
                 ) -> Optional[Tuple[Entry, ...]]:
    """``spec_for`` over ``mesh`` (default the thread's ``global_mesh``),
    or None without a mesh."""
    mesh = mesh if mesh is not None else _STATE.mesh
    if mesh is None:
        return None
    return spec_for(shape, axes, mesh)


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The identity. The reference pins an activation's placement for
    XLA's partitioner here; the port has no partitioner, and its sharded
    program computes each tensor where it is used (the engine's ranks
    slice their parameters and caches by hand, and the layers call the
    collectives themselves)."""
    return x


def local_shape(shape: Sequence[int], spec: Sequence[Entry],
                mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` leaf placed by
    ``spec``."""
    return tuple(d // axis_size(mesh, e) for d, e in zip(shape, spec))


def _index(entry: Entry, sizes: Mapping[str, int],
           coords: Mapping[str, int]) -> int:
    """Which of a dim's ``axis_size`` chunks the rank at ``coords`` holds:
    row-major over the entry's axes, as the reference's
    ``NamedSharding`` splits a dim over a tuple of axes."""
    idx = 0
    for a in ((entry,) if isinstance(entry, str) else entry):
        idx = idx * sizes[a] + coords[a]
    return idx


def shard_slice(x: torch.Tensor, spec: Sequence[Entry], mesh,
                coords: Mapping[str, int]) -> torch.Tensor:
    """The shard of ``x`` (a whole leaf) that the rank at ``coords`` (axis
    -> index) holds under ``spec``. A copy of its own when anything is
    sliced, so the whole leaf can be freed; ``x`` itself when the spec
    replicates it."""
    sizes = mesh_sizes(mesh)
    out = x
    for dim, e in enumerate(spec):
        if e is not None:
            n = x.shape[dim] // axis_size(sizes, e)
            out = out.narrow(dim, _index(e, sizes, coords) * n, n)
    return out if out is x else out.clone(
        memory_format=torch.contiguous_format)


def rank_coords(mesh) -> List[Dict[str, int]]:
    """Every rank's coordinates of a mesh, in rank order (row-major)."""
    sizes = mesh_sizes(mesh)
    out: List[Dict[str, int]] = [{}]
    for a, n in sizes.items():
        out = [{**c, a: i} for c in out for i in range(n)]
    return out


@dataclass
class Placed:
    """A tensor placed on a mesh: every rank's shard under ``spec``, in
    rank order (the port's counterpart of a ``jax.Array`` with a
    ``NamedSharding``, on the host)."""
    spec: Tuple[Entry, ...]
    mesh_shape: Dict[str, int]
    shards: List[torch.Tensor]

    def gather(self) -> torch.Tensor:
        """The whole tensor, assembled from the shards on the host."""
        whole = None
        for coords, shard in zip(rank_coords(self.mesh_shape),
                                 self.shards):
            if whole is None:
                shape = [d * axis_size(self.mesh_shape, e)
                         for d, e in zip(shard.shape, self.spec)]
                whole = torch.empty(shape, dtype=shard.dtype)
            view = whole
            for dim, e in enumerate(self.spec):
                if e is not None:
                    n = shard.shape[dim]
                    view = view.narrow(
                        dim, _index(e, self.mesh_shape, coords) * n, n)
            view.copy_(shard.cpu())
        return whole


def place(x: torch.Tensor, spec: Sequence[Entry], mesh) -> Placed:
    """``x`` sliced for every rank of ``mesh`` under ``spec``."""
    sizes = dict(mesh_sizes(mesh))
    return Placed(tuple(spec), sizes,
                  [shard_slice(x, spec, sizes, c)
                   for c in rank_coords(sizes)])
