"""Median wall of the engine's ticks in the window (EngineStats.tick_s),
ms."""

from harness.readers import tick_ms_p50 as read  # noqa: F401

LAYER = "serving engine (serving/engine.ServingEngine)"
SOURCE = "program_span"
UNIT = "ms"
MOVES = "request_latency_p95_ms"

