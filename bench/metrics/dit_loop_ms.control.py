"""Device span of the traced control step's DiT loop replay
(models/model.DiTGraph), ms."""

from harness.readers import control_replays, span_ms

LAYER = "action head (models/action under models/model.DiTGraph)"
SOURCE = "device_trace"
UNIT = "ms"
MOVES = "control_step_ms"


def read(run):
    reps = control_replays(run)
    return span_ms(reps[2]) if reps and reps[2] else None
