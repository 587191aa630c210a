"""Request classes and the admission queue order of the serving engine:
the part of ``repro.serving.scheduler`` that the admit-stall engine uses
(pure Python, copied). ``ChunkedScheduler`` and ``SLOController`` come with
chunked prefill (ROADMAP item 8).
"""
from __future__ import annotations

import math
from typing import Any, List

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
