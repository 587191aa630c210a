"""Model FLOPs of one control step over the window's time a step at the
bf16 peak, %."""

from harness.readers import control_mfu as read  # noqa: F401

LAYER = "whole control step (core/vla.vla_control_step)"
SOURCE = "host_clock"
UNIT = "%"
MOVES = "control_step_ms"

