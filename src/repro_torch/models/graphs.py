"""Steps captured in CUDA graphs and replayed: the port's counterpart of
the reference's one-dispatch programs (``jax.jit`` over a prefill, a
``lax.scan`` or a ``lax.while_loop``), which cost the host one launch a
step instead of one per kernel.

``StepGraph(body, device)`` holds a step ``body``: a function of no
arguments that reads and writes, in place, only tensors that outlive it
(static input and output buffers, caches, parameters). ``step(key)`` runs
the body once:

- on the card, by replaying the graph captured for ``key``. With no graph
  for ``key`` yet, the body first runs eagerly on a side stream (a warm-up
  that is this call's step: it reaches every kernel's one-time setup and
  runs under ``torch.cuda.set_sync_debug_mode("error")``, so a host sync
  raises), then is captured. A capture that fails raises; there is no
  eager fallback. A runner keeps up to ``max_graphs`` graphs by key (the
  reference's jit cache, one program a shape; one unless the caller asks
  for more), all in its one memory pool, and evicts the least recently
  used one past that; they replay one at a time on the caller's stream;
- on the CPU, or with ``eager=True``, by running the body as it is, on the
  same buffers (the oracle the graphed step is held to).

``key`` names what the graph baked in: ``tensor_key`` of every tensor the
body reads or writes (address, shape, strides, type), plus whatever else
its kernels depend on. Equal keys mean the same addresses hold tensors of
the same layout, so a replay computes on the caller's tensors.

**A guard.** ``guard`` (optional) computes a 0-d bool device tensor from
the runner's buffers. The capture records the guard, then the body inside
a CUDA graph conditional IF node on it: a replay whose guard is false runs
the guard's few kernels and nothing of the body (the reference's
``lax.while_loop`` that stops on the device). The warm-up step and eager
runs run the body unguarded, so a guarded body must change nothing that a
later step or a readback sees when its guard is false: a body that
computes the guard's condition itself and masks every write with it (the
serving ticks: a masked decode step writes a live slot's KV at its next
position, and the next real step rewrites that row with the same value).
The IF node is made through the CUDA runtime (``kernels.graph_cond``;
CUDA 12.4 or later), since the installed torch binds no conditional node:
the body is captured into a graph of its own, kept uninstantiated; the
guard is captured into the step's graph, where ``graph_cond.if_node`` adds
the kernel that sets the node's condition and the node; the node's body
becomes a copy of the body's graph, and the step's graph is instantiated.
A guarded capture that fails raises: the steps never run unguarded in its
place.

A replay calls no kernel wrapper, so each wrapper's ``launches`` count is
kept by the runner: the launches the captured body made are taken back
after the capture (a capture runs nothing) and, for an unguarded graph,
added again on each replay, so the counts stay the kernels' launches on
the device. A guarded replay may run nothing, so a guarded runner counts
the replays that ran the body in its device counter ``ran`` instead, and
the caller that reads it back (with the rest of its carry) hands the
value to ``settle``, which adds those launches.

Threads: the warm-up's sync check, the collector and the launch counts
are process-wide, and a capture forbids some CUDA calls on every thread
while it runs, so a capture must not run beside another thread's CUDA
work. Code that drives the card from several threads captures every
graph its threads will replay first, on one thread, and then seals the
runners (``sealed = True``): a sealed runner raises on a key it holds no
graph for instead of capturing it beside other threads' work.
"""
from __future__ import annotations

import gc
import time
from collections import OrderedDict
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


class OutputBuffers:
    """Output buffers a graphed body fills, one a slot: made by the body's
    first (warm-up or eager) run from the values it computes, written in
    place after, so a captured graph keeps their addresses."""

    def __init__(self):
        self.bufs: Dict = {}

    def write(self, slot, value: torch.Tensor) -> None:
        buf = self.bufs.get(slot)
        if buf is None:
            self.bufs[slot] = value.clone()
        else:
            buf.copy_(value)


class StepGraph:
    """One step ``body``, captured in CUDA graphs on the card, one a key,
    and replayed (see the module docstring). ``captures`` and
    ``capture_s`` count the captures and the host seconds they took (the
    warm-up step excluded), ``replays`` the replays; ``graph``, ``key`` and
    ``recorded`` (each kernel wrapper's launches per replay) are those of
    the graph run last. With ``guard``, ``ran`` counts on the device the
    replays that ran the body, ``settle`` takes it back (``replays_ran``
    sums what it took), and ``guarded`` says whether a step whose guard is
    false skips the body (on the card) or runs it (eagerly). ``sealed``
    refuses further captures (see the module docstring)."""

    def __init__(self, body: Callable[[], None], device, *,
                 eager: bool = False,
                 guard: Optional[Callable[[], torch.Tensor]] = None,
                 max_graphs: int = 1):
        self.body = body
        self.guard = guard
        self.device = torch.device(device)
        self.eager = eager or self.device.type != "cuda"
        self.max_graphs = max_graphs
        self.graphs: "OrderedDict[object, tuple]" = OrderedDict()
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.key = None
        self.pool = None if self.eager else torch.cuda.graph_pool_handle()
        self.recorded: Dict = {}
        self.ran = (torch.zeros((), dtype=torch.long, device=self.device)
                    if guard is not None else None)
        # a step whose guard is false skips the body (on the card); an
        # eager runner runs it, and the body masks itself
        self.guarded = guard is not None and not self.eager
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0
        self.replays_ran = 0
        self.sealed = False

    def step(self, key=None) -> None:
        """Run the body once (see the module docstring)."""
        if self.eager:
            self.body()
            return
        entry = self.graphs.get(key)
        if entry is None:
            if self.sealed:
                raise RuntimeError(
                    "a sealed StepGraph has no graph for this key: its "
                    "graphs were captured before other threads drove the "
                    "card, and a capture now could run beside their work")
            self._capture(key)
            return
        self.graphs.move_to_end(key)
        self.graph, self.recorded, _ = entry
        self.key = key
        self.graph.replay()
        self.replays += 1
        if self.guard is None:
            for fn, n in self.recorded.items():
                count_launches(fn, n)

    def settle(self, ran: int) -> None:
        """A guarded runner's ``ran``, read back: add the launches of the
        ``ran`` replays that ran the body of the graph run last, and zero
        the counter (on the device, in stream order)."""
        for fn, n in self.recorded.items():
            count_launches(fn, n * ran)
        self.replays_ran += ran
        if self.ran is not None and not self.eager:
            self.ran.zero_()

    def _capture(self, key) -> None:
        """A warm-up step (eager, on a side stream, no host sync allowed),
        then the body captured into a new graph for ``key``."""
        if len(self.graphs) >= self.max_graphs:
            self.graphs.popitem(last=False)   # its pool memory returns
        self.graph, self.key = None, None
        stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(stream)
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                if self.guard is not None:
                    self.guard()
                self.body()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        stream.wait_stream(side)
        t0 = time.perf_counter()
        wrappers = counted_wrappers()
        before = {fn: fn.launches for fn in wrappers}
        # a graph freed during the capture (an unreachable engine's, by
        # the cycle collector) would invalidate it: collect first, then
        # hold the collector off until the capture ends
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            if self.guard is None:
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph, pool=self.pool):
                    self.body()
                held = graph
            else:
                graph, held = self._guarded()
        finally:
            if collecting:
                gc.enable()
        recorded = {fn: fn.launches - before[fn] for fn in wrappers
                    if fn.launches != before[fn]}
        for fn, n in recorded.items():
            count_launches(fn, -n)        # the capture launched nothing
        self.graphs[key] = (graph, recorded, held)
        self.graph, self.key, self.recorded = graph, key, recorded
        self.captures += 1
        self.capture_s += time.perf_counter() - t0

    def _guarded(self):
        """The guard, then the body and the ``ran`` count inside an IF node
        on it: (the step's graph, instantiated; the body's graph, which
        stays beside it). Both captures share the runner's pool: the body's
        intermediates are free when the guard's are made, and the guard
        runs first."""
        from repro_torch.kernels.graph_cond import ops as cond
        body = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(body, pool=self.pool):
            self.body()
            self.ran.add_(1)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, pool=self.pool):
            pred = self.guard()
            node = cond.if_node(pred)
        cond.fill(node, body)
        graph.instantiate()
        return graph, (body, pred)
