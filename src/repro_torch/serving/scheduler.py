"""Continuous-batching scheduler of the serving engine (the port of
``repro.serving.scheduler``, pure Python, copied): request classes and the
admission queue order, and the chunked-prefill policy behind
``ServingEngine(chunked_prefill=True)``.

Every prompt is split into fixed-size prefill chunks (``chunk_size``
positions; a partial final chunk is padded and its tail masked through
``n_valid``). Each tick packs work under ``token_budget`` positions: the
decoding slots are served first, then prefill chunks in class order
(realtime EDF, then best-effort FCFS), so a long prompt never holds a
decoder back for more than the budget. On a prefix-cache hit the first
chunk starts at the first position not shared. ``SLOController`` turns a
control-frequency target into each tick's decode depth and best-effort
chunk quota. The mechanism (running chunks, sampling the first token) is
``serving.engine.ServingEngine``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Tuple

# Priority classes. ``realtime`` models the paper's control loop: a robot
# that must receive its action chunk before the next observation lands.
# ``best_effort`` is everything else (episode starts, offline queries).
# The class is carried on the request object (``Request.priority`` /
# ``FleetRequest.priority``); policy code reads it through ``is_realtime``
# so plain test doubles without the attribute default to best-effort.
REALTIME = "realtime"
BEST_EFFORT = "best_effort"


def is_realtime(req: Any) -> bool:
    """Class of a request-like object (missing attribute = best-effort)."""
    return getattr(req, "priority", BEST_EFFORT) == REALTIME


def req_deadline(req: Any) -> float:
    """Absolute deadline (``t_submit + deadline_s``) of a request-like
    object; ``inf`` when it carries none — an undeadlined realtime request
    still outranks best-effort but sorts last within its class."""
    return getattr(req, "t_deadline", math.inf)


def insert_by_class(queue: List[Any], req: Any, front: bool = False):
    """Insert ``req`` into a waiting ``queue`` kept in admission order:
    one realtime segment at the head (EDF — earliest absolute deadline
    first, FCFS among equal deadlines), then the best-effort segment
    (FCFS). This is the single insertion policy shared by the chunked
    scheduler's waiting list and the legacy engine queue, so realtime
    admission priority holds on both paths.

    ``front=True`` restores seniority after a preemption or capacity
    deferral: a best-effort request re-enters at the head of *its own
    segment* (it can never leapfrog realtime work), a realtime request
    re-enters ahead of equal-deadline peers (its deadline already encodes
    its urgency). With no realtime requests anywhere this degrades exactly
    to ``append`` / ``insert(0)`` — the static FCFS order, bit for bit."""
    if is_realtime(req):
        dl = req_deadline(req)
        i = 0
        while i < len(queue) and is_realtime(queue[i]) and (
                req_deadline(queue[i]) < dl
                or (not front and req_deadline(queue[i]) == dl)):
            i += 1
        queue.insert(i, req)
        return
    if front:
        i = 0
        while i < len(queue) and is_realtime(queue[i]):
            i += 1
        queue.insert(i, req)
    else:
        queue.append(req)


def task_order_key(task: "PrefillTask") -> Tuple:
    """Chunk-priority key for ``plan_tick``: healthy before stalled, then
    realtime (EDF within class) before best-effort, then admission order.
    With no realtime tasks this reduces to the static ``(stalled, seq)``
    FCFS order — the bit-equality anchor."""
    rt = is_realtime(task.req)
    return (task.stalled, 0 if rt else 1,
            req_deadline(task.req) if rt else math.inf, task.seq)


def eviction_victims(tasks: Dict[int, "PrefillTask"],
                     exclude: int = -1) -> List[int]:
    """Slots whose in-flight prefill may be preempted to free pool pages:
    *stalled* (already queued-behind on pool pressure) *best-effort*
    tasks only. Realtime tasks are never victims — a realtime beneficiary
    must not preempt its own class (EDF already ordered them; evicting a
    peer trades one deadline for another), and a best-effort beneficiary
    evicting realtime would be priority inversion. The invariant the
    property suite checks: no call path ever selects a realtime victim."""
    return [s for s, t in tasks.items()
            if s != exclude and t.stalled and not is_realtime(t.req)]


@dataclass
class SLOTick:
    """Deadline context for one ``plan_tick`` call, produced by
    :class:`SLOController` from live engine state (never computed inside
    the scheduler — ``plan_tick`` stays a pure function of its inputs).

    ``decode_need`` is the per-slot decode depth realtime work requires
    this tick (0 = no realtime decode pressure; the static split already
    suffices). ``be_chunk_quota`` caps the prefill-chunk tokens
    best-effort tasks may take this tick (``None`` = no cap; ``0`` =
    realtime work is under pressure and best-effort prefill yields its
    whole quota — chunk dispatches are the tick's wall-time heavy stage,
    so shedding them is what actually shortens the next tick)."""
    decode_need: int = 0
    be_chunk_quota: Optional[int] = None


class SLOController:
    """Closes the loop from a latency SLO to per-tick budget decisions.

    The target is a control frequency (``slo_hz``, e.g. the paper's 10 Hz
    action rate): every realtime request must finish its action chunk
    before its absolute deadline. The controller converts that into this
    tick's knobs using the engine's per-tick EWMA wall time — the live
    measurement of what one tick costs end to end:

    - A realtime decoding slot with ``remaining`` tokens and ``slack``
      seconds has ``floor(slack / ewma)`` ticks left; it needs
      ``ceil(remaining / ticks_left)`` tokens per tick to make its
      deadline. ``decode_need`` is the max over realtime slots, so the
      fused decode stage (which runs all slots at one depth) is deep
      enough for the tightest deadline.
    - A slot is *under pressure* when its slack is less than ``safety``
      times the time it still needs at the measured tick rate; any
      realtime request still waiting or mid-prefill also counts as
      pressure (its deadline is burning in the queue). Under pressure
      best-effort prefill chunks are quota'd to zero for the tick.

    Host-side, like the rest of the policy layer."""

    def __init__(self, slo_hz: float, safety: float = 2.0):
        if slo_hz <= 0:
            raise ValueError(f"slo_hz must be > 0, got {slo_hz}")
        self.slo_hz = slo_hz
        self.period_s = 1.0 / slo_hz
        self.safety = safety

    def plan(self, now: float, tick_ewma_s: float,
             rt_decode: Iterable[Tuple[int, float]],
             rt_prefill_pending: bool) -> SLOTick:
        """``rt_decode``: (remaining_tokens, absolute_deadline) per
        realtime decoding slot. ``rt_prefill_pending``: any realtime
        request waiting or mid-prefill."""
        ewma = max(float(tick_ewma_s), 1e-6)
        need = 0
        pressure = bool(rt_prefill_pending)
        for remaining, t_dl in rt_decode:
            remaining = int(remaining)
            if remaining <= 0 or not math.isfinite(t_dl):
                continue
            slack = t_dl - now
            ticks_left = max(1, int(slack / ewma))
            need = max(need, -(-remaining // ticks_left))
            if slack < self.safety * remaining * ewma:
                pressure = True
        return SLOTick(decode_need=need,
                       be_chunk_quota=0 if pressure else None)


@dataclass
class PrefillTask:
    """One request mid-prefill: admitted to a slot, pages allocated up to
    the next chunk, ``pos`` .. ``total`` still to run. ``n_skip`` prompt
    positions were served from the prefix cache and are never recomputed."""
    req: Any                    # serving.engine.Request
    slot: int
    total: int                  # n_prefix + len(prompt) positions
    n_skip: int = 0             # positions skipped via prefix-cache hit
    pos: int = 0                # next position to prefill (starts at n_skip)
    seq: int = 0                # admission order (FCFS tiebreak)
    embeds: Any = None          # [1, total, d] prompt embeddings (engine)
    cache1: Any = None          # dense engines: batch-1 prefill cache
    prefix_keys: Any = None     # paged engines: prefix-closed page digests
    t_start: float = 0.0        # prefill start (queue_s boundary)
    stalled: bool = False       # pool pressure on last attempt; cleared by
    #                             the next successful chunk. Stalled tasks
    #                             are planned last (healthy work first) and
    #                             are the only admission-side eviction
    #                             victims — a stalled task is by definition
    #                             queued-behind, while decoders and
    #                             progressing tasks free pages by finishing

    @property
    def remaining(self) -> int:
        return self.total - self.pos


@dataclass
class ChunkPlan:
    """One prefill-chunk dispatch: ``n_tok`` valid tokens of ``task``'s
    prompt starting at position ``start`` (padded to the engine's static
    chunk shape)."""
    task: PrefillTask
    start: int
    n_tok: int


@dataclass
class TickPlan:
    """What one engine tick executes: prefill chunks, then up to
    ``decode_steps`` fused decode steps for the active slots."""
    chunks: List[ChunkPlan] = field(default_factory=list)
    decode_steps: int = 0
    budget_used: int = 0


class ChunkedScheduler:
    """Token-budget continuous-batching policy.

    Budget math per tick (``plan_tick``):

    1. **Decode first.** ``n_active`` decoding slots reserve
       ``n_active * decode_steps`` tokens, with
       ``decode_steps = clamp(token_budget // n_active, 1, tick_tokens)``.
       Active decoders always advance at least one step — prefill pressure
       can slow decode to one token per tick but never stall it — and when
       the budget is generous they keep the engine's full fused-tick depth.
    2. **Chunks fill the remainder.** In-flight prefills (FCFS by admission
       order) take chunks of ``min(chunk_size, remaining prompt, remaining
       budget)`` valid tokens until the budget is spent. A task may receive
       several chunks in one tick on an idle engine; with zero leftover
       budget it simply waits (decoders free budget when they finish).
    3. **Progress floor.** With no active decoders the whole budget (>= 1
       token, enforced at construction) goes to prefill, so the head task
       always gets a chunk — even ``token_budget < chunk_size`` degrades to
       slow prefill, not deadlock.

    The scheduler owns the waiting queue and the in-flight task table; the
    engine owns slots, pools, and device state. ``stalled`` tasks (pool
    pressure on their last attempt) are planned after healthy tasks and
    retried every tick until pages free up or they are evicted.

    Invariants the engine relies on:

    - ``tasks`` is keyed by slot and a slot holds at most one in-flight
      prefill (asserted in ``start_task``); a slot is *either* decoding
      or mid-prefill, never both.
    - ``seq`` is monotone in admission order, so the FCFS tiebreak in
      ``plan_tick`` is stable across ticks — a task's chunk priority
      never changes while it is in flight.
    - ``waiting`` is class-ordered (realtime EDF segment, then
      best-effort FCFS — ``insert_by_class``); within a class arrival
      order is preserved except for ``front=True`` re-queues (preemption
      victims and admission-capacity deferrals keep their seniority).
    - ``plan_tick`` only *reads* scheduler state: planning a tick and
      then not executing it (or executing it partially under pool
      pressure) leaves nothing to roll back here — ``task.pos`` advances
      only when the engine reports the chunk ran.
    """

    def __init__(self, chunk_size: int, token_budget: int):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        if token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, "
                             f"got {token_budget}")
        self.chunk_size = chunk_size
        self.token_budget = token_budget
        self.waiting: List[Any] = []            # Requests not yet admitted
        self.tasks: Dict[int, PrefillTask] = {}  # slot -> in-flight prefill
        self._seq = 0

    # -- queue / task lifecycle -------------------------------------------
    def submit(self, req, front: bool = False):
        """Queue a request for admission, class-ordered: realtime requests
        EDF at the head, best-effort FCFS behind (``insert_by_class``).
        ``front=True`` restores seniority within the request's own class
        (preempted / capacity-deferred requests re-enter at the head of
        their segment so they cannot be starved by a steady arrival
        stream)."""
        insert_by_class(self.waiting, req, front=front)

    @property
    def pending(self) -> int:
        """Requests this scheduler still owes work: waiting + mid-prefill.
        (Decoding slots are the engine's; the engine's own ``pending``
        adds them.)"""
        return len(self.waiting) + len(self.tasks)

    def start_task(self, task: PrefillTask) -> PrefillTask:
        """Admit a request into a slot: it now competes for chunk budget."""
        assert task.slot not in self.tasks, f"slot {task.slot} mid-prefill"
        task.seq = self._seq
        task.pos = task.n_skip
        self._seq += 1
        self.tasks[task.slot] = task
        return task

    def finish_task(self, slot: int) -> PrefillTask:
        """Prefill complete (or request finished at prefill): drop the
        task; the engine flips the slot to decoding."""
        return self.tasks.pop(slot)

    def requeue_task(self, slot: int) -> Optional[PrefillTask]:
        """Preemption: the slot's in-flight prefill is abandoned and its
        request goes back to the *front* of the waiting queue (it has
        seniority). Written chunks are discarded — on re-admission the
        prefix cache may still serve the pages the first attempt
        registered, so the retry can be cheaper than the original."""
        task = self.tasks.pop(slot, None)
        if task is not None:
            self.submit(task.req, front=True)
        return task

    # -- the per-tick policy ----------------------------------------------
    def plan_tick(self, n_active: int, tick_tokens: int,
                  slo: Optional[SLOTick] = None) -> TickPlan:
        """Pack one tick: decode reservation first, then prefill chunks
        class-ordered (realtime EDF, then best-effort FCFS) under what is
        left of ``token_budget``.

        With an :class:`SLOTick` context the deadline check runs before
        packing: the decode reservation deepens to ``slo.decode_need``
        when realtime decode is behind schedule (clamped to
        ``tick_tokens``; the reservation may then exceed ``token_budget``
        — the budget is the fairness policy, the deadline is the point,
        and the overdraw self-limits because chunks only pack into
        ``max(0, budget - reservation)``), and best-effort chunk tokens
        are capped at ``slo.be_chunk_quota`` (realtime tasks' chunks are
        never quota'd — their prefill is on the deadline path). With
        ``slo=None`` (or an all-best-effort workload) the plan is
        bit-identical to the static policy.

        The budget bounds *planned* work. A prefill that completes during
        this tick's chunk stage joins the same tick's decode stage (the
        engine re-reads the active set), adding up to ``decode_steps``
        unplanned decode tokens — deliberate: delaying that slot one tick
        would cost first-token latency to enforce an accounting nicety.

        ``decode_steps`` is denominated in *emitted tokens per slot*, not
        engine-loop iterations — the contract that keeps this policy
        mechanism-agnostic. The plain fused tick emits one token per loop
        step, so the two readings coincide; the speculative tick
        (``spec_decode=True``) emits a variable 1..spec_k accepted tokens
        per verify pass and clamps its emit count to this same cap, so a
        tick's decode stage never exceeds ``n_active * decode_steps``
        tokens regardless of how few HBM passes produced them."""
        plan = TickPlan()
        if n_active:
            plan.decode_steps = max(
                1, min(tick_tokens, self.token_budget // n_active))
            if slo is not None and slo.decode_need > plan.decode_steps:
                plan.decode_steps = min(tick_tokens, slo.decode_need)
        left = max(0, self.token_budget - n_active * plan.decode_steps)
        be_left = left
        if slo is not None and slo.be_chunk_quota is not None:
            be_left = min(be_left, slo.be_chunk_quota)
        # stalled tasks go last: healthy work first, but they still retry
        # every tick (their stall may clear the moment a decoder finishes)
        for task in sorted(self.tasks.values(), key=task_order_key):
            rt = is_realtime(task.req)
            pos = task.pos
            while (left if rt else min(left, be_left)) > 0 \
                    and pos < task.total:
                n = min(self.chunk_size, task.total - pos,
                        left if rt else min(left, be_left))
                plan.chunks.append(ChunkPlan(task, pos, n))
                pos += n
                left -= n
                if not rt:
                    be_left -= n
        plan.budget_used = (n_active * plan.decode_steps
                            + sum(c.n_tok for c in plan.chunks))
        return plan
