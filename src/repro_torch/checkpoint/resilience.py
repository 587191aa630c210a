"""Fault tolerance for the training loop (the port's copy of
``repro.checkpoint.resilience``): ``ResilientLoop`` wraps a step function
with retry + restore-from-latest; a fault hook lets tests inject failures
deterministically. ``elastic_shrink``: on permanent node loss, shrink the
``data`` axis, rebuild the mesh and re-slice the state for it.
"""
from __future__ import annotations

import logging
from typing import Callable, Optional

from repro_torch.checkpoint import store
from repro_torch.distributed.sharding import Placed, place
from repro_torch.models.params import map_tree

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


def elastic_shrink(state, old_mesh, make_mesh: Callable, sharding_fn: Callable,
                   lost_nodes: int = 1):
    """Rebuild a smaller mesh after node loss and re-slice ``state`` for it
    (the reference's contract). ``make_mesh(new_data_size)`` -> mesh;
    ``sharding_fn(state, mesh)`` -> a tree of ``spec_for`` entries (None:
    leave the leaf as it is). Each leaf to move is gathered whole on the
    host (a ``Placed`` leaf from its shards) and sliced for every rank of
    the new mesh (``distributed.sharding.place``). Returns (new_state,
    new_mesh)."""
    old_data = old_mesh.shape["data"]
    new_data = old_data - lost_nodes
    assert new_data >= 1, "cannot shrink below one data shard"
    new_mesh = make_mesh(new_data)
    specs = sharding_fn(state, new_mesh)

    def move(x, spec):
        if spec is None:
            return x
        whole = x.gather() if isinstance(x, Placed) else x.detach().cpu()
        return place(whole, spec, new_mesh)
    return map_tree(move, state, specs), new_mesh
