"""Device span of the traced control step's decode graph replays
(models/model.DecodeGraph) over their number, ms."""

from harness.readers import control_replays, span_ms

LAYER = ("decode step graphs (models/graphs.StepGraph under "
         "models/model.DecodeGraph)")
SOURCE = "device_trace"
UNIT = "ms"
MOVES = "control_step_ms"


def read(run):
    reps = control_replays(run)
    if not reps or not reps[1]:
        return None
    return sum(span_ms(r) for r in reps[1]) / len(reps[1])
