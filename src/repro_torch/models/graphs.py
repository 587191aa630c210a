"""A decode step captured once in a CUDA graph and replayed: the port's
counterpart of the reference's one-dispatch decode (``jax.jit`` over a
``lax.scan`` or ``lax.while_loop``), which costs the host one launch a
step instead of one per kernel.

``StepGraph(body, device)`` holds a step ``body``: a function of no
arguments that reads and writes, in place, only tensors that outlive it
(static input and output buffers, caches, parameters). ``step(key)`` runs
the body once:

- on the card, by replaying the graph captured for ``key``. With no graph
  yet, or another ``key``, the body first runs eagerly on a side stream
  (a warm-up that is this call's step: it reaches every kernel's one-time
  setup and runs under ``torch.cuda.set_sync_debug_mode("error")``, so a
  host sync raises), then is captured. A capture that fails raises; there
  is no eager fallback. Every capture of one ``StepGraph`` uses one memory
  pool;
- on the CPU, or with ``eager=True``, by running the body as it is, on the
  same buffers (the oracle the graphed step is held to).

``key`` names what the graph baked in: ``tensor_key`` of every tensor the
body reads or writes (address, shape, strides, type), plus whatever else
its kernels depend on. Equal keys mean the same addresses hold tensors of
the same layout, so a replay computes on the caller's tensors.

A replay calls no kernel wrapper, so each wrapper's ``launches`` count is
kept by the runner: the launches the captured body made are taken back
after the capture (a capture runs nothing) and added again on each
replay, so the counts stay the kernels' launches on the device.

Threads: the warm-up's sync check, the collector and the launch counts
are process-wide, and a capture forbids some CUDA calls on every thread
while it runs, so a capture must not run beside another thread's CUDA
work. A caller that steps replicas on threads captures each one first,
one after another (``ServingEngine.capture_tick``, which the serving
front end calls for every replica before its drivers start).
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import count_launches
from repro_torch.models.params import leaves


def counted_wrappers():
    """Every kernel wrapper that counts its launches (``fn.launches``)."""
    from repro_torch.kernels.chunk_prefill.ops import chunk_prefill_attention
    from repro_torch.kernels.chunk_prefill.paged import (
        paged_chunk_prefill_attention)
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.paged import (
        paged_decode_attention)
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.moe_gmm.ops import gmm_down, gmm_gated
    from repro_torch.kernels.ssd.ops import ssd
    return (decode_attention, paged_decode_attention,
            chunk_prefill_attention, paged_chunk_prefill_attention,
            gmm_gated, gmm_down, ssd, flash_attention)


def tensor_key(*items) -> tuple:
    """What a captured graph depends on in ``items``: for each tensor (a
    tree of them is walked with ``leaves``, a list or tuple item by item)
    its address, shape, strides and type; any other item as it is."""
    out = []
    for item in items:
        if isinstance(item, torch.Tensor):
            out.append((item.data_ptr(), tuple(item.shape), item.stride(),
                        item.dtype, item.device))
        elif isinstance(item, dict):
            out.append(tensor_key(*(t for _, t in leaves(item))))
        elif isinstance(item, (list, tuple)):
            out.append(tensor_key(*item))
        else:
            out.append(item)
    return tuple(out)


class StepGraph:
    """One step ``body``, captured in a CUDA graph on the card and replayed
    (see the module docstring). ``captures`` and ``capture_s`` count the
    captures and the host seconds they took (the warm-up step excluded),
    ``replays`` the replays; ``recorded`` maps each kernel wrapper to its
    launches per replay."""

    def __init__(self, body: Callable[[], None], device, *,
                 eager: bool = False):
        self.body = body
        self.device = torch.device(device)
        self.eager = eager or self.device.type != "cuda"
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.pool = None if self.eager else torch.cuda.graph_pool_handle()
        self.recorded: Dict = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def step(self, key=None) -> None:
        """Run the body once (see the module docstring)."""
        if self.eager:
            self.body()
        elif self.graph is None or key != self.key:
            self._capture(key)
        else:
            self.graph.replay()
            self.replays += 1
            for fn, n in self.recorded.items():
                count_launches(fn, n)

    def _capture(self, key) -> None:
        """A warm-up step (eager, on a side stream, no host sync allowed),
        then the body captured into a new graph for ``key``."""
        self.graph, self.key = None, None     # its pool memory goes back
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                self.body()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        stream.wait_stream(side)
        t0 = time.perf_counter()
        wrappers = counted_wrappers()
        before = {fn: fn.launches for fn in wrappers}
        graph = torch.cuda.CUDAGraph()
        # a graph freed during the capture (an unreachable engine's, by the
        # cycle collector) would invalidate it: collect first, then hold
        # the collector off until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                self.body()
        finally:
            if collecting:
                gc.enable()
        self.recorded = {fn: fn.launches - before[fn] for fn in wrappers
                         if fn.launches != before[fn]}
        for fn, n in self.recorded.items():
            count_launches(fn, -n)            # the capture launched nothing
        self.graph, self.key = graph, key
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
