"""Checkpoints of the port: the store (the reference's on-disk layout),
the resilient training loop and the elastic shrink."""
from repro_torch.checkpoint import store
from repro_torch.checkpoint.resilience import (ResilientLoop, StepFailure,
                                               elastic_shrink)
from repro_torch.checkpoint.store import latest_step, restore, save

__all__ = ["ResilientLoop", "StepFailure", "elastic_shrink", "latest_step",
           "restore", "save", "store"]
