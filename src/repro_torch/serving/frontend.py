"""Asyncio serving front-end: the production rim over one or more engines
(the port of ``repro.serving.frontend`` over the port's ``ServingEngine``).

Everything below this module is a synchronous tick machine
(``ServingEngine.step_fused`` advances every live request by up to one
token-budget's worth of work); everything above it is a robot fleet —
thousands of clients that arrive at their own times, stream tokens as they
are produced, hang up mid-generation, and must be told to back off when the
system is full. ``AsyncFrontend`` is the adapter between the two:

- **Streaming.** ``submit()`` returns a :class:`TokenStream` — an async
  iterator that yields tokens as the owning replica's ticks produce them.
  The first yielded token is the client-observed TTFT boundary
  (``FrontendStats.ttft_s``), which includes front-end queueing the
  engine-side ``EngineStats.ttft_s`` cannot see.
- **Cancellation.** ``TokenStream.cancel()`` (or ``AsyncFrontend.cancel``)
  aborts a request wherever it is — staged, queued, mid-prefill, or
  mid-decode. The engine-side hook (``ServingEngine.cancel``) frees the
  slot and its pool pages, so a robot that hung up stops holding KV
  capacity within one tick.
- **Backpressure.** Admission is bounded per replica (``queue_limit``
  requests staged + pending). When every routable replica is at its limit,
  ``submit`` raises :class:`Backpressure` carrying a ``retry_after_s``
  estimate (depth x the replica's EWMA tick time) instead of queueing
  unboundedly — the reject-with-retry-after contract load balancers expect.
- **Prefix-cache-aware routing.** The content-addressed page digests the
  KV pool already shares pages under (``engine.prefix_page_keys``) double
  as the routing key: a repeat observation is routed to the replica whose
  pool holds the longest run of its prefix pages (``KVPool.match_prefix``),
  falling back to least-loaded. A robot's control loop therefore sticks to
  the replica that has its camera-frame + instruction KV, and the prefix
  cache keeps paying off across replicas instead of being diluted by
  round-robin.

Concurrency model — everything engine-flavoured happens at tick
boundaries, on one driver coroutine per replica::

      submit()/cancel() (event loop)          driver i (coroutine)
      ───────────────────────────────         ─────────────────────────
      stage request -> _staged[i]   ──────►   drain staged + cancels
      stage uid     -> _cancels[i]            eng.submit / eng.cancel
      set _wake[i]                            tick: eng.step_fused()
                                                (in a worker thread, so
                                                 replicas tick in parallel
                                                 and the loop stays live)
      async for tok in stream  ◄──────────    pump: push new out_tokens
                                              per live stream, close
                                              finished ones

    The engine is only ever touched between its own ticks by its own
    driver, so no engine state needs locking; the staging deques and the
    per-stream asyncio queues are the only cross-context structures.

    On the card, ``start`` captures every graph of every replica (the
    decode tick's, the vision graph and the chunk graphs:
    ``ServingEngine.capture``), one after another, before any driver
    runs, and seals them: a capture must not run beside another thread's
    CUDA work (``models.graphs``), and none runs later. A driver whose
    engine raises ends its replica's streams with the error (a consumer
    raises it) and fails later submissions, where the reference's streams
    would wait for ever.

No HTTP here on purpose: the launch driver (``repro_torch.launch.serve``)
speaks to this class directly, and a transport (FastAPI/grpc) would wrap
``submit`` / ``TokenStream`` 1:1 without touching the scheduling
semantics.
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.engine import (Request, ServingEngine,
                                        prefix_page_keys)
from repro_torch.serving.scheduler import BEST_EFFORT, REALTIME


class Backpressure(RuntimeError):
    """Every replica routable *for this request's class* is at its
    admission limit.

    Carries ``retry_after_s`` — the least-loaded replica's queue depth x
    its EWMA tick wall time (the engine's own measurement once it has
    ticked, the front-end's driver-side estimate before that), i.e. a
    first-order estimate of when a slot's worth of queue will have
    drained. Clients (and the workload replayer) are expected to back off
    for that long and resubmit. ``priority`` echoes the rejected class:
    with a ``realtime_reserve`` configured, best-effort traffic hits its
    (lower) limit first, so a flood of best-effort rejects while realtime
    still admits is the system working as designed."""

    def __init__(self, retry_after_s: float, depth: int, limit: int,
                 priority: str = BEST_EFFORT):
        super().__init__(
            f"admission queues full (depth {depth} >= limit {limit} for "
            f"{priority} on every replica); retry after "
            f"{retry_after_s:.3f}s")
        self.retry_after_s = retry_after_s
        self.depth = depth
        self.limit = limit
        self.priority = priority


_DONE = object()        # stream sentinel: request finished or was cancelled


class TokenStream:
    """Handle for one in-flight request: async-iterate it for tokens.

    ``async for tok in stream`` yields ints as the replica produces them
    and ends when the request finishes or is cancelled; ``await
    stream.tokens()`` collects the remainder. ``cancelled`` distinguishes
    a cancel-truncated stream from a naturally finished one. The underlying
    engine :class:`Request` is exposed as ``.request`` (its ``out_tokens``
    is the authoritative full list, identical to what the stream yielded)."""

    def __init__(self, uid: int, req: Request, replica: int):
        self.uid = uid
        self.request = req
        self.replica = replica
        self.cancelled = False
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None       # first streamed token
        self.t_done: Optional[float] = None
        self._chan: asyncio.Queue = asyncio.Queue()
        self._sent = 0                             # tokens pumped so far
        self._closed = False
        self._error: Optional[BaseException] = None

    def __aiter__(self):
        return self

    async def __anext__(self) -> int:
        item = await self._chan.get()
        if item is _DONE:
            if self._error is not None:
                raise self._error
            raise StopAsyncIteration
        return item

    async def tokens(self) -> List[int]:
        """Drain the stream: every remaining token, in order."""
        return [tok async for tok in self]

    def cancel(self):
        """Stage a cancellation with the owning front-end (set by submit)."""
        self._frontend.cancel(self)

    # internal: wired by AsyncFrontend.submit
    _frontend: "AsyncFrontend" = None


@dataclass
class FrontendStats:
    """Fleet-facing counters, aggregated across replicas.

    ``ttft_s`` / ``latency_s`` are client-observed (submit wall time ->
    first streamed token / stream close), so they include front-end
    queueing and routing — the numbers an SLO is written against, unlike
    the engine-internal ``EngineStats`` boundaries."""
    submitted: int = 0
    completed: int = 0
    cancelled: int = 0
    rejected: int = 0           # Backpressure raises
    routed_prefix: int = 0      # routed by prefix-cache affinity
    routed_load: int = 0        # least-loaded fallback
    ttft_s: List[float] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)

    def report(self) -> Dict[str, float]:
        rep = {"submitted": self.submitted, "completed": self.completed,
               "cancelled": self.cancelled, "rejected": self.rejected,
               "routed_prefix": self.routed_prefix,
               "routed_load": self.routed_load}
        if self.ttft_s:
            rep["ttft_p50_s"] = float(np.percentile(self.ttft_s, 50))
            rep["ttft_p99_s"] = float(np.percentile(self.ttft_s, 99))
        if self.latency_s:
            rep["latency_p50_s"] = float(np.percentile(self.latency_s, 50))
            rep["latency_p99_s"] = float(np.percentile(self.latency_s, 99))
        return rep


class AsyncFrontend:
    """Asyncio front-end over ``engines`` (homogeneous or not).

    Parameters
    ----------
    engines: the replica set. Each must be exclusively owned by this
        front-end (its queue/slots are mutated from the driver).
    queue_limit: per-replica admission bound — staged + engine-pending
        requests. ``submit`` raises :class:`Backpressure` when every
        replica is at the limit.
    offload_ticks: run each replica's ticks in a worker thread (default),
        so replicas tick in parallel and the event loop stays responsive
        during a tick. ``False`` ticks inline on the loop — fully
        single-threaded and deterministic, the mode the bit-equality bench
        uses.
    realtime_reserve: admission slots per replica held back for the
        ``realtime`` class: best-effort requests admit against
        ``queue_limit - realtime_reserve`` while realtime admits against
        the full ``queue_limit``, so a flood of best-effort traffic can
        fill its share and start bouncing without ever crowding a control
        loop out of admission. 0 (default) disables the split — both
        classes see one limit, the pre-priority behavior.

    Use as an async context manager (``async with AsyncFrontend(...)``),
    or call ``start()`` / ``stop()`` explicitly. ``stop()`` cancels the
    drivers without draining; call ``drain()`` first to wait for in-flight
    work."""

    def __init__(self, engines: Sequence[ServingEngine],
                 queue_limit: int = 64, offload_ticks: bool = True,
                 realtime_reserve: int = 0):
        if not engines:
            raise ValueError("AsyncFrontend needs at least one engine")
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        if not 0 <= realtime_reserve < queue_limit:
            raise ValueError(
                f"realtime_reserve must be in [0, queue_limit), got "
                f"{realtime_reserve} with queue_limit {queue_limit}")
        self.engines = list(engines)
        self.queue_limit = queue_limit
        self.realtime_reserve = realtime_reserve
        self.offload_ticks = offload_ticks
        self.stats = FrontendStats()
        n = len(self.engines)
        self._staged: List[Deque[TokenStream]] = [deque() for _ in range(n)]
        self._cancels: List[set] = [set() for _ in range(n)]
        self._live: List[Dict[int, TokenStream]] = [{} for _ in range(n)]
        self._wake: List[asyncio.Event] = []
        self._tick_ewma = [1e-3] * n        # per-replica tick wall estimate
        self._uid = 0
        self._running = False
        self._tasks: List[asyncio.Task] = []
        self._pool: Optional[ThreadPoolExecutor] = None
        self._failed: Optional[BaseException] = None   # a driver's error

    # -- lifecycle ---------------------------------------------------------
    async def start(self):
        if self._running:
            return
        for eng in self.engines:       # before any thread ticks a replica
            eng.capture()
        self._running = True
        self._wake = [asyncio.Event() for _ in self.engines]
        if self.offload_ticks:
            self._pool = ThreadPoolExecutor(
                max_workers=len(self.engines),
                thread_name_prefix="engine-tick")
        self._tasks = [asyncio.ensure_future(self._drive(i))
                       for i in range(len(self.engines))]

    async def stop(self):
        """Stop the drivers. In-flight streams are closed (their consumers
        see end-of-stream); un-drained requests stay in the engines."""
        if not self._running:
            return
        self._running = False
        for ev in self._wake:
            ev.set()
        results = await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks = []
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        for live in self._live:
            for stream in live.values():
                stream._chan.put_nowait(_DONE)
            live.clear()
        for eng in self.engines:    # a sharded replica's workers end here
            if eng.mesh is not None:
                eng.close()
        for r in results:
            if isinstance(r, BaseException) \
                    and not isinstance(r, asyncio.CancelledError):
                raise r

    async def __aenter__(self):
        await self.start()
        return self

    async def __aexit__(self, *exc):
        await self.stop()

    async def drain(self, poll_s: float = 1e-3):
        """Wait until every accepted request has finished or been
        cancelled (staged queues empty, no live streams)."""
        while any(self._staged) or any(self._live) or any(self._cancels):
            await asyncio.sleep(poll_s)

    # -- observability -----------------------------------------------------
    def stats_snapshot(self) -> Dict[str, float]:
        """One flat, JSON-serializable dict of fleet health — the payload an
        autoscaler or metrics scraper polls between ticks.

        Keys: every :meth:`FrontendStats.report` entry under a
        ``frontend_`` prefix, ``replicas``, and per-replica gauges
        ``replica{i}_depth`` (staged + engine-pending), ``replica{i}_pending``
        (engine-side only), ``replica{i}_tick_ewma_s`` (EWMA tick wall time —
        engine-measured once it has ticked; with depth, the retry-after
        estimate Backpressure quotes), and ``replica{i}_tokens_decoded``;
        speculative replicas additionally report
        ``replica{i}_spec_accept_per_pass``, and replicas that scored any
        deadlined request report the per-class SLO scoreboard
        (``replica{i}_deadline_attainment_realtime`` / ``_best_effort``
        and ``replica{i}_preemptions_*`` counters); paged replicas report
        cache gauges (``replica{i}_pages_in_use`` / ``_pages_hwm`` /
        ``_cache_bytes_hwm``), and sharded replicas their mesh's axis sizes
        (``replica{i}_mesh_model``) and one rank's own figures
        (``replica{i}_cache_bytes_hwm_shard`` / ``_pages_in_use_shard``):
        the summed ``cache_bytes_hwm`` is not a per-device number once the
        pool is partitioned. All values are floats, the snapshot is safe to take before
        ``start()`` (gauges read zero), and nothing here blocks on a
        tick."""
        snap: Dict[str, float] = {}
        for k, v in self.stats.report().items():
            snap[f"frontend_{k}"] = float(v)
        snap["replicas"] = float(len(self.engines))
        for i, eng in enumerate(self.engines):
            snap[f"replica{i}_depth"] = float(self.depth(i))
            snap[f"replica{i}_pending"] = float(eng.pending)
            snap[f"replica{i}_tick_ewma_s"] = float(self.tick_ewma(i))
            snap[f"replica{i}_tokens_decoded"] = float(
                eng.stats.tokens_decoded)
            ph = eng.stats.phase_report()
            for k, v in ph.items():
                if k.startswith(("deadline_attainment_", "deadline_total_",
                                 "preemptions_", "pages_", "cache_bytes_",
                                 "mesh_")) \
                        or k == "spec_accept_per_pass":
                    snap[f"replica{i}_{k}"] = float(v)
        return snap

    # -- admission ---------------------------------------------------------
    def depth(self, i: int) -> int:
        """Replica ``i``'s admission depth: staged + engine-pending."""
        return len(self._staged[i]) + self.engines[i].pending

    def class_limit(self, priority: str) -> int:
        """Admission limit the class admits against: realtime sees the
        full ``queue_limit``, best-effort yields ``realtime_reserve``
        slots of it."""
        if priority == REALTIME:
            return self.queue_limit
        return self.queue_limit - self.realtime_reserve

    def tick_ewma(self, i: int) -> float:
        """Replica ``i``'s per-tick wall-time estimate: the engine's own
        EWMA once it has ticked (it sees every tick, including those
        driven outside this front-end), the driver-side estimate before
        that."""
        eng_ewma = self.engines[i].stats.tick_ewma_s
        return eng_ewma if eng_ewma > 0 else self._tick_ewma[i]

    def _route(self, prompt: np.ndarray, patches: Optional[np.ndarray],
               priority: str = BEST_EFFORT) -> int:
        """Pick a replica: longest prefix-page match first, least-loaded
        fallback. Raises :class:`Backpressure` when everything is full.

        The digest is computed per distinct (model, page_size, kv_dtype)
        signature — identical replicas share one computation — and matched
        against each pool's live prefix cache. A match only wins while the
        replica is under the class's admission limit
        (``class_limit(priority)``): affinity never overrides admission
        control (a full replica's cache hit is worth less than another
        replica's free slot, because the hit only skips prefill while the
        queue costs whole requests)."""
        limit = self.class_limit(priority)
        keys_cache: Dict[tuple, List[bytes]] = {}
        best, best_hits = -1, 0
        for i, eng in enumerate(self.engines):
            if eng.pool is None:
                continue
            if self.depth(i) >= limit:
                continue
            n_prefix = (eng.cfg.vision.num_tokens
                        if patches is not None and eng.cfg.vision is not None
                        else 0)
            sig = (eng.cfg.name, eng.page_size, eng.kv_dtype, n_prefix)
            if sig not in keys_cache:
                keys_cache[sig] = prefix_page_keys(
                    eng.cfg.name, eng.page_size, eng.kv_dtype, prompt,
                    patches, n_prefix)
            hits = eng.pool.match_prefix(keys_cache[sig])
            if hits > best_hits:
                best, best_hits = i, hits
        if best >= 0:
            self.stats.routed_prefix += 1
            return best
        cands = [i for i in range(len(self.engines))
                 if self.depth(i) < limit]
        if not cands:
            i = min(range(len(self.engines)), key=self.depth)
            retry = max(1e-3, self.depth(i) * self.tick_ewma(i))
            self.stats.rejected += 1
            raise Backpressure(retry, self.depth(i), limit, priority)
        self.stats.routed_load += 1
        return min(cands, key=self.depth)

    async def submit(self, prompt: np.ndarray, max_tokens: int,
                     patches: Optional[np.ndarray] = None,
                     priority: str = BEST_EFFORT,
                     deadline_s: float = 0.0) -> TokenStream:
        """Admit one request: route it, stage it with the chosen replica's
        driver, and return its :class:`TokenStream`. Raises
        :class:`Backpressure` instead of queueing past the class's
        admission limit. ``priority``/``deadline_s`` ride the engine
        :class:`Request` into the scheduler: realtime requests admit
        against the full ``queue_limit``, jump the replica's waiting
        queue (EDF within class), and have their deadline defended by the
        engine's SLO controller when it runs one (``slo_hz > 0``)."""
        if not self._running:
            raise RuntimeError("AsyncFrontend not started")
        if self._failed is not None:
            raise RuntimeError("a replica's driver failed") \
                from self._failed
        i = self._route(prompt, patches, priority)
        uid, self._uid = self._uid, self._uid + 1
        req = Request(uid=uid, prompt=np.asarray(prompt, np.int32),
                      max_tokens=max_tokens, patches=patches,
                      priority=priority, deadline_s=deadline_s)
        stream = TokenStream(uid, req, i)
        stream._frontend = self
        self._staged[i].append(stream)
        self.stats.submitted += 1
        self._wake[i].set()
        return stream

    def cancel(self, stream: TokenStream):
        """Stage a cancellation for ``stream``; the owning driver frees the
        slot/pages at the next tick boundary and closes the stream. Safe on
        an already-finished stream (no-op)."""
        if stream._closed:
            return
        self._cancels[stream.replica].add(stream.uid)
        self._wake[stream.replica].set()

    # -- the per-replica driver --------------------------------------------
    def _drain_control(self, i: int):
        """Move staged submissions and cancellations into engine ``i``.
        Runs on the event loop between ticks — the only place besides the
        tick itself that mutates the engine."""
        eng = self.engines[i]
        while self._staged[i]:
            stream = self._staged[i].popleft()
            if stream.uid in self._cancels[i]:
                # cancelled before it ever reached the engine
                self._cancels[i].discard(stream.uid)
                self._close(i, stream, cancelled=True)
                continue
            eng.submit(stream.request)
            self._live[i][stream.uid] = stream
        for uid in sorted(self._cancels[i]):
            self._cancels[i].discard(uid)
            stream = self._live[i].pop(uid, None)
            if stream is None:
                continue        # finished before the cancel drained
            eng.cancel(uid)
            self._close(i, stream, cancelled=True)

    def _close(self, i: int, stream: TokenStream, cancelled: bool):
        now = time.perf_counter()
        stream.t_done = now
        stream.cancelled = cancelled
        stream._closed = True
        if cancelled:
            self.stats.cancelled += 1
        else:
            self.stats.completed += 1
            self.stats.latency_s.append(now - stream.t_submit)
        stream._chan.put_nowait(_DONE)

    def _pump(self, i: int):
        """Push tokens the last tick produced into their streams; close
        streams whose requests finished."""
        now = time.perf_counter()
        done_uids = []
        for uid, stream in self._live[i].items():
            toks = stream.request.out_tokens
            if stream._sent < len(toks):
                if stream.t_first is None:
                    stream.t_first = now
                    self.stats.ttft_s.append(now - stream.t_submit)
                for tok in toks[stream._sent:]:
                    stream._chan.put_nowait(tok)
                stream._sent = len(toks)
            if stream.request.done:
                done_uids.append(uid)
        for uid in done_uids:
            self._close(i, self._live[i].pop(uid), cancelled=False)

    async def _drive(self, i: int):
        """Replica ``i``'s driver. A failure (an engine that raised in a
        tick) ends every stream of the replica with the error, which
        their consumers raise, and fails later ``submit`` calls; ``stop``
        raises it again."""
        try:
            await self._drive_loop(i)
        except asyncio.CancelledError:
            raise
        except BaseException as exc:
            self._failed = exc
            for stream in [*self._staged[i], *self._live[i].values()]:
                stream._error = exc
                stream._closed = True
                stream._chan.put_nowait(_DONE)
            self._staged[i].clear()
            self._live[i].clear()
            self._cancels[i].clear()
            raise

    async def _drive_loop(self, i: int):
        """Replica ``i``'s tick loop: drain control -> tick -> pump, or
        park on the wake event when there is nothing to do."""
        eng = self.engines[i]
        loop = asyncio.get_event_loop()
        while self._running:
            self._drain_control(i)
            if not eng.pending:
                if not self._staged[i] and not self._cancels[i]:
                    self._wake[i].clear()
                    # re-check after clear: a submit between the test and
                    # the clear must not be lost (set-then-clear race)
                    if not self._staged[i] and not self._cancels[i] \
                            and self._running:
                        await self._wake[i].wait()
                continue
            t0 = time.perf_counter()
            if self.offload_ticks:
                await loop.run_in_executor(self._pool, eng.step_fused)
            else:
                eng.step_fused()
                await asyncio.sleep(0)      # let submit/cancel interleave
            self._tick_ewma[i] = (0.8 * self._tick_ewma[i]
                                  + 0.2 * (time.perf_counter() - t0))
            self._pump(i)
