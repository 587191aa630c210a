"""Logical-axis sharding rules (the port's copy of the reference's
``distributed.sharding`` rule tables) with its divisibility-aware walk.

Parameters and caches name each dim with a *logical* axis (``PSpec.axes``);
a rule table maps a logical axis to a physical mesh axis (or a tuple of
them). A dim shards only if its size divides by the mesh axes' product,
dropping trailing axes until it does, and no physical axis is used twice
in one leaf: otherwise it replicates (smollm's 9 heads replicate over
model=16 while its mlp and vocab dims shard). One rule table so stays
valid for every architecture.

A mesh here is its axis sizes: a mapping of axis name to size, any
object with such a ``.shape`` (``launch.mesh.production_mesh_shape``, a
``launch.mesh.Mesh``), or a torch ``DeviceMesh`` with named dims. The
serving engine places every tensor by hand, slicing each leaf to a rank's
shard from its ``spec_for`` entries (``shard_slice``). The dry run places
its tensors as DTensors on a ``DeviceMesh`` (``dtensor_placements``) and
lets DTensor's sharding propagation partition the step; there
``constrain`` pins an activation's placement, as the reference's
``with_sharding_constraint`` does for XLA's partitioner. ``Placed`` holds
a tensor as the shards of every rank of a mesh (the elastic shrink
gathers and re-slices it).
"""
from __future__ import annotations

import contextlib
import sys
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
    """Axis name -> size of a mesh given as a mapping, by its ``.shape``
    or as a ``DeviceMesh`` (named dims)."""
    if isinstance(mesh, Mapping):
        return mesh
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return mesh.shape


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


def dtensor_placements(spec: Sequence[Entry], mesh) -> tuple:
    """DTensor placements, one per dim of the ``DeviceMesh`` ``mesh``, of a
    tensor placed by ``spec_for`` entries: ``Shard(d)`` on each mesh dim
    that dim ``d``'s entry names, ``Replicate()`` on the others.

    A tuple entry shards one dim over several mesh dims (INFERENCE_RULES'
    ``mlp: ("model", "data")``). DTensor splits such a dim in mesh-dim
    order (data-major on a ``data`` x ``model`` mesh) where the
    reference's ``NamedSharding`` follows the entry's order (model-major):
    a rank holds other rows of the dim, as many bytes of it."""
    from torch.distributed.tensor import Replicate, Shard
    owner = {}
    for dim, entry in enumerate(spec):
        if entry is not None:
            for a in ((entry,) if isinstance(entry, str) else entry):
                owner[a] = dim
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in mesh.mesh_dim_names)


def _device_mesh():
    """The ``DeviceMesh`` ``global_mesh`` activated on this thread, or
    None (no mesh, or a mesh of axis sizes only)."""
    mesh = _STATE.mesh
    return mesh if hasattr(mesh, "mesh_dim_names") else None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (False without importing DTensor when
    nothing has: the serving and training paths never do)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local_call(fn, args: Sequence, placements: Sequence, out_placements,
               grad_placements: Optional[Sequence] = None):
    """``fn(*args)`` on each rank's local shards, through DTensor's
    ``local_map``: each DTensor of ``args`` is redistributed to its entry
    of ``placements`` (None for an argument that is not a DTensor), and
    each tensor ``fn`` returns becomes a DTensor of its entry of
    ``out_placements`` (a tuple with one placements tuple per output).
    ``grad_placements`` places the gradients of the inputs' local shards
    (default: as the inputs), e.g. ``Partial`` where each rank's shard of
    the function reads only part of a whole input. Where DTensor has no
    sharding rule for an op, this makes the partitioning explicit."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(placements),
                     in_grad_placements=(None if grad_placements is None
                                         else tuple(grad_placements)),
                     redistribute_inputs=True)(*args)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for activations ``x`` [..., d] and a weight ``w`` [d, n]:
    the product itself for plain tensors. For DTensors the partitioning
    is explicit (``local_call``), as XLA's partitioner places a dot, mesh
    dim by mesh dim:

    - ``w`` sharded on ``d`` and ``x`` sharded on ``d`` too, or whole
      (then sliced where it lies): partial sums (``Partial``; the
      row-parallel product, which the next constraint all-reduces);
    - ``w`` sharded on ``d`` where ``x`` is sharded on another dim (its
      batch): ``w`` gathered (the FSDP weight all-gather);
    - ``x`` sharded on ``d`` alone: ``x`` gathered;
    - ``w`` sharded on ``n`` (column-parallel): kept, unless ``x`` is
      sharded (or partial) on the same mesh dim, which gathers ``w``;
    - ``x`` sharded on another dim, or partial with ``w`` whole: kept.

    Each input's gradient is placed as its local product makes it (a
    weight's is partial over the mesh dims that shard the batch, so the
    backward of the weight gather is its reduce-scatter)."""
    if not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    x, w = replicated_like(x, w), replicated_like(w, x)
    nd = x.dim()
    px, pw, po, gx, gw = [], [], [], [], []
    for a, b in zip(x.placements, w.placements):
        xs = a.dim % nd if a.is_shard() else None
        xp = a.is_partial()
        ws = b.dim % 2 if b.is_shard() else None
        if ws == 0 and (xs == nd - 1 or (xs is None and not xp)):
            px.append(Shard(nd - 1)), pw.append(b), po.append(Partial())
            gx.append(Shard(nd - 1)), gw.append(b)
            continue
        if xs == nd - 1 or (xp and ws is not None):
            xs, xp, a = None, False, Replicate()
        if ws == 0 or (ws == 1 and (xs is not None or xp)) or b.is_partial():
            ws, b = None, Replicate()
        px.append(a), pw.append(b)
        if xs is not None:
            po.append(Shard(xs)), gx.append(a), gw.append(Partial())
        elif xp:
            po.append(Partial()), gx.append(Replicate()), gw.append(Partial())
        elif ws == 1:
            po.append(Shard(nd - 1)), gx.append(Partial()), gw.append(b)
        else:
            po.append(Replicate()), gx.append(a), gw.append(b)
    return local_call(torch.matmul, (x, w), (tuple(px), tuple(pw)),
                      (tuple(po),), (tuple(gx), tuple(gw)))


def replicated_like(t: torch.Tensor, ref) -> torch.Tensor:
    """``t`` as a DTensor replicated on DTensor ``ref``'s mesh (a tensor
    the model built, e.g. positions or a mask), or ``t`` itself when it
    is a DTensor already or ``ref`` is not one."""
    if is_dtensor(t) or not is_dtensor(ref):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def zeros(shape: Sequence[int], axes: Axes, dtype, device) -> torch.Tensor:
    """A zero tensor; under a ``global_mesh`` holding a ``DeviceMesh`` (the
    dry run), a DTensor placed by its logical ``axes``, each rank holding
    its zeroed shard."""
    mesh = _device_mesh()
    if mesh is None:
        return torch.zeros(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor
    spec = spec_for(shape, axes, mesh)
    local = torch.zeros(local_shape(shape, spec, mesh_sizes(mesh)),
                        dtype=dtype, device=device)
    return DTensor.from_local(local, mesh, dtensor_placements(spec, mesh),
                              run_check=False)


def shard_start(placements, mesh, dim: int, size: int) -> int:
    """Where this rank's shard of a dim of ``size`` starts under DTensor
    ``placements`` on ``mesh``: its coordinates on the mesh dims that
    shard ``dim``, in mesh-dim order (DTensor's split order), times the
    shard's length."""
    idx, n = 0, 1
    for m, p in enumerate(placements):
        if p.is_shard(dim):
            idx = idx * mesh.size(m) + mesh.get_local_rank(m)
            n *= mesh.size(m)
    return idx * (size // n)


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Pin activation ``x``'s placement to its logical ``axes`` (the
    reference's ``with_sharding_constraint``): under a ``global_mesh``
    holding a ``DeviceMesh``, a DTensor ``x`` is redistributed to the
    placements of ``spec_for(x.shape, axes, mesh)`` (the collectives that
    takes are issued here). The identity for a plain tensor or without
    such a mesh: the serving engine's ranks compute on their own shards
    and call the collectives themselves."""
    mesh = _device_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    return x.redistribute(mesh, dtensor_placements(
        spec_for(x.shape, axes, mesh), mesh))


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
