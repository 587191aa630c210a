"""Least time of the traced control step's decode attention over its
kernels' device time, %."""

from harness.readers import decode_attention_roofline as read  # noqa: F401

LAYER = "kernels (kernels/decode_attention)"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "control_step_ms"

