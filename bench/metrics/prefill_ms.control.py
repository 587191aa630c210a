"""Device span of the traced control step's vision + prefill graph replay
(models/model.PrefillGraph), ms."""

from harness.readers import control_replays, span_ms

LAYER = "control step (core/vla, models/model.PrefillGraph)"
SOURCE = "device_trace"
UNIT = "ms"
MOVES = "control_step_ms"


def read(run):
    reps = control_replays(run)
    return span_ms(reps[0]) if reps else None
