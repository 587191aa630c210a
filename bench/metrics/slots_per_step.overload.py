"""Tokens decoded over device steps in the window (EngineStats): the decode
batch's occupancy."""
LAYER = "scheduler and KV pool (serving/scheduler, serving/kv_pool)"
SOURCE = "program_counter"
UNIT = "slots"
MOVES = "tokens_per_s"

def read(run):
    steps = run.window.get("device_steps")
    return run.window["tokens_decoded"] / steps if steps else None
