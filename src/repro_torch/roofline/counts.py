"""Operation counts of a function as the port computes it (the port's
counterpart of the reference's ``roofline/hlo.py``, which reads compiled
HLO text; the port has no HLO).

``dot_flops`` runs the function under a dispatch mode that prices every
matrix product with ``torch.utils.flop_counter``'s formulas (the ones
``FlopCounterMode`` uses: mm, addmm, bmm, baddbmm, convolutions and the
fused attention ops, each 2 x multiply-adds); ``count_ops`` counts the
calls to one aten op. Both see the aten ops the function dispatches and
nothing else:

- on the CPU and the meta device every kernel wrapper runs its plain
  version, so the count is that of the plain function, layer by layer
  (no loop body is counted once, unlike a scanned program's HLO);
- on the card a hand-written kernel is a ``ctypes`` launch that dispatches
  no aten op, so its products are not counted (the dense decode kernel's
  two attention products, for one), and a 3xTF32 body's three products
  per product of the function are never seen.

``CollectiveCounter`` counts the collectives a partitioned run issues:
the dry run traces its step on DTensors over a fake mesh
(``launch.mesh.fake_device_mesh``), and DTensor's redistributions desugar
into functional collectives on the local shards, which the counter files
under the reference's kinds (``hlo.COLLECTIVES``) by their result bytes
on one device. The sharded serving path counts its own
(``distributed.collectives.ShardGroup.counts``), by the same convention.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# shape queries the dispatch mode passes through untouched (as
# FlopCounterMode does)
_PASS = {torch.ops.aten.is_contiguous.default,
         torch.ops.aten.is_contiguous.memory_format,
         torch.ops.aten.is_strides_like_format.default,
         torch.ops.aten.is_non_overlapping_and_dense.default,
         torch.ops.aten.size.default,
         torch.ops.aten.sym_size.default,
         torch.ops.aten.stride.default,
         torch.ops.aten.sym_stride.default,
         torch.ops.aten.storage_offset.default,
         torch.ops.aten.sym_storage_offset.default,
         torch.ops.aten.numel.default,
         torch.ops.aten.sym_numel.default,
         torch.ops.aten.dim.default,
         torch.ops.prim.layout.default}


def _shapes(args) -> str:
    return " x ".join(str(list(a.shape)) for a in args
                      if isinstance(a, torch.Tensor))


class DotCounter(TorchDispatchMode):
    """A dispatch mode that prices each call of an op in
    ``flop_registry`` as it runs; an op without a formula that decomposes
    into ops with one is decomposed first (``FlopCounterMode``'s rule).
    ``calls`` holds (flops, op and operand shapes) per call. On DTensors
    an op is priced at its global shapes; with ``local`` it is passed on
    to DTensor and the ops on the local shards are priced: one device's
    share of a partitioned program."""

    def __init__(self, local: bool = False):
        super().__init__()
        self.local = local
        self.calls: List[Tuple[float, str]] = []

    @property
    def total(self) -> float:
        return float(sum(f for f, _ in self.calls))

    def top(self, n: int = 0) -> List[Tuple[float, str]]:
        items = sorted(self.calls, key=lambda t: -t[0])
        return items[:n] if n else items

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PASS:
            return NotImplemented
        if self.local and _has_dtensor(types):
            return NotImplemented
        packet = func._overloadpacket
        if packet not in flop_registry \
                and func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.calls.append((float(n), f"{packet} {_shapes(args)}"))
        return out


class _OpCounter(TorchDispatchMode):
    def __init__(self, opname: str):
        super().__init__()
        self.opname = opname.removeprefix("aten.")
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._overloadpacket.__name__ == self.opname:
            self.n += 1
        return func(*args, **(kwargs or {}))


def dot_flops(fn, *args, top: int = 0, **kw):
    """Sum of the matrix products' FLOPs of ``fn(*args, **kw)`` as it runs
    (2 x multiply-adds each). Returns (total, top-N [(flops, op and operand
    shapes)]), all calls when ``top`` is 0, largest first: the reference's
    return shape."""
    with DotCounter() as c:
        fn(*args, **kw)
    return c.total, c.top(top)


def count_ops(fn, *args, opname: str, **kw) -> int:
    """Calls of the aten op ``opname`` ("mm" or "aten.mm") that
    ``fn(*args, **kw)`` dispatches."""
    with _OpCounter(opname) as c:
        fn(*args, **kw)
    return c.n


# the reference's kinds (``roofline/hlo.py``'s COLLECTIVES)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional collective (``torch.ops._c10d_functional``) -> kind
_KIND = {"all_reduce": "all-reduce",
         "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
# DTensor's own collective ops (``torch.ops._dtensor``) -> kind
_DTENSOR_KIND = {"shard_dim_alltoall": "all-to-all"}
# functional ops that move nothing (waits and autograd wrappers)
_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    return sum(_bytes(t) for t in out)


class CollectiveCounter(TorchDispatchMode):
    """A dispatch mode that adds each functional collective's *result*
    bytes on one device to its kind: the reference's definition
    (``hlo.py``: the per-device wire traffic of a ring is (n-1)/n of it).
    An op that reaches a DTensor is passed on (``NotImplemented``), so
    DTensor runs it and the mode sees the collectives it desugars into,
    on the local shards. A functional op of an unknown kind raises:
    nothing is dropped from the count.

    What DTensor issues is counted as it is issued. It gathers a dim
    sharded over two mesh dims as two all-gathers in sequence (each
    counted by its own result, the first of them a partial gather), where
    XLA issues one all-gather over the flattened axes; it reshards
    between two dims of one mesh dim with an all-to-all, and it never
    issues a collective-permute."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = defaultdict(float)
        self.calls: List[Tuple[str, int, str]] = []

    def counts(self) -> Dict[str, float]:
        """Bytes by kind and ``total``: ``hlo.collective_bytes``'s dict."""
        out = {k: float(v) for k, v in self.bytes.items()}
        out["total"] = float(sum(self.bytes.values()))
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        ns = getattr(func, "namespace", "")
        name = func._overloadpacket.__name__
        kind = None
        if ns in ("_c10d_functional", "c10d_functional") \
                and name not in _NOT_COLLECTIVES:
            kind = _KIND.get(name)
        elif ns == "_dtensor" and name in _DTENSOR_KIND:
            kind = _DTENSOR_KIND[name]
        elif ns not in ("_c10d_functional", "c10d_functional", "_dtensor") \
                or name in _NOT_COLLECTIVES:
            return out
        if kind is None:
            raise NotImplementedError(f"CollectiveCounter: no kind for "
                                      f"{func}")
        n = _bytes(out)
        self.bytes[kind] += n
        self.calls.append((kind, n, _shapes(args)))
        return out
