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
object with such a ``.shape`` (``launch.mesh.production_mesh_shape``).
Process groups and the tensors they place come with the sharded serving
path (ROADMAP item 11).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

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


def spec_for(shape: Sequence[int], axes: Axes, mesh,
             rules: Optional[dict] = None) -> Tuple[Entry, ...]:
    """One entry per dim of ``shape`` given its logical ``axes``: None
    (replicated), a physical axis name, or a tuple of names. It honours
    divisibility (trailing physical axes are dropped until the dim
    divides) and never uses a physical axis twice. ``rules`` defaults to
    DEFAULT_RULES."""
    rules = rules or DEFAULT_RULES
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
