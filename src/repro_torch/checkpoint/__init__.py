"""Checkpoints of the port: the store (the reference's on-disk layout) and
the resilient training loop."""
from repro_torch.checkpoint import store
from repro_torch.checkpoint.resilience import ResilientLoop, StepFailure
from repro_torch.checkpoint.store import latest_step, restore, save

__all__ = ["ResilientLoop", "StepFailure", "latest_step", "restore", "save",
           "store"]
