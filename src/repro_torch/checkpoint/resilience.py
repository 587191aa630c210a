"""Fault tolerance for the training loop (the port's copy of
``repro.checkpoint.resilience``): ``ResilientLoop`` wraps a step function
with retry + restore-from-latest; a fault hook lets tests inject failures
deterministically. ``elastic_shrink`` needs a device mesh and is not
ported yet (ROADMAP item 11).
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

from repro_torch.checkpoint import store

log = logging.getLogger(__name__)


class StepFailure(RuntimeError):
    pass


class ResilientLoop:
    def __init__(self, step_fn: Callable, ckpt_dir: str, save_every: int = 50,
                 max_retries: int = 3, fault_hook: Optional[Callable] = None,
                 async_save: bool = True):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_retries = max_retries
        self.fault_hook = fault_hook
        self.async_save = async_save
        self._pending = None
        self.retries = 0
        self.restores = 0

    def _maybe_save(self, step, state):
        if step % self.save_every == 0:
            if self._pending is not None:
                self._pending.join()
            self._pending = store.save(self.ckpt_dir, step, state,
                                       async_=self.async_save)

    def run(self, state, start_step: int, num_steps: int, *args):
        """Runs ``state = step_fn(state, step, *args)`` with retry+restore."""
        step = start_step
        last_good = start_step
        while step < start_step + num_steps:
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                state = self.step_fn(state, step, *args)
                self._maybe_save(step, state)
                if step % self.save_every == 0:
                    last_good = step
                step += 1
                self.retries = 0
            except StepFailure as e:  # injected/detected node failure
                self.retries += 1
                log.warning("step %d failed (%s); retry %d", step, e,
                            self.retries)
                if self.retries > self.max_retries:
                    raise
                ck = store.latest_step(self.ckpt_dir)
                if ck is not None and ck <= step:
                    if self._pending is not None:
                        self._pending.join()
                        self._pending = None
                    state = store.restore(self.ckpt_dir, ck, state)
                    step = ck + 1
                    self.restores += 1
        if self._pending is not None:
            self._pending.join()
        return state, step
