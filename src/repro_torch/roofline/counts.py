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

Collective bytes are not counted here: the dry run runs unpartitioned on
the meta device and issues no collective (ROADMAP item 16, the dry run's
collective bytes). The sharded serving path counts its own
(``distributed.collectives.ShardGroup.counts``).
"""
from __future__ import annotations

from typing import List, Tuple

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
    ``calls`` holds (flops, op and operand shapes) per call."""

    def __init__(self):
        super().__init__()
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
