"""Share of the traced control step with no device operation running, %."""

from harness.readers import idle_share as read  # noqa: F401

LAYER = "device"
SOURCE = "device_trace"
UNIT = "%"
MOVES = "control_step_ms"

