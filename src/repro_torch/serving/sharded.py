"""Ranks 1..N-1 of a sharded serving engine: the worker loop, the helper
that starts them, and picklable weight sources.

One controller, as under ``shard_map``: rank 0 runs the ``ServingEngine``
(scheduler, pool, sampling, the front end) and takes every host decision;
each device stage it runs it first broadcasts, by name with its host
arguments, to the other ranks (``ServingEngine._dev``). A worker rank
builds the same engine on its own shard when rank 0 sends it one
(``("engine", cfg, opts, kwargs, weights)``), runs each stage it receives
until ``("close",)``, and waits for the next engine; ``("exit",)`` ends
it. A worker that raises writes its traceback to the mesh's store under
``error/<rank>`` and exits with code 1, so rank 0's next collective fails
at once and raises ``ShardWorkerError`` with that report; a worker that
stops answering makes rank 0's collective raise after the group's
timeout. A worker that ends shuts its group down and leaves by
``os._exit``, without the interpreter's teardown (see ``_worker_main``).

    mesh = spawn_mesh(2, device="cpu")          # rank 0 here, rank 1 spawned
    eng = ServingEngine(cfg, opts, SeededWeights(0), mesh=mesh,
                        device="cpu")
    ...
    eng.close()                                 # and join the worker
"""
from __future__ import annotations

import dataclasses
import itertools
import multiprocessing
import os
import sys
import tempfile
import traceback
from typing import Optional

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh, make_serving_mesh
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.serving.engine import ServingEngine

_SEQ = itertools.count()        # one store file per mesh a process starts


class SeededWeights:
    """The seeded draw of ``models.model.init_params``: a ``torch.Generator``
    on the rank's device seeded with ``seed``, in ``dtype``. Every rank
    draws every leaf whole, in order, and keeps its slice, so the shards
    are those of the unsharded draw. ``draw_layers``: draw a model of that
    many layers and keep the config's first ones (a depth cut of a deeper
    model's weights, as ``chip_smoke.first_layers`` makes)."""

    def __init__(self, seed: int = 0, dtype=torch.float32,
                 draw_layers: Optional[int] = None):
        self.seed, self.dtype, self.draw_layers = seed, dtype, draw_layers

    def __call__(self, cfg, device, shard=None):
        gen = torch.Generator(device=device).manual_seed(self.seed)
        n = cfg.num_layers
        if self.draw_layers is None or self.draw_layers == n:
            return P.init_params(M.model_template(cfg), gen, self.dtype,
                                 device, shard=shard)
        deep = dataclasses.replace(cfg, num_layers=self.draw_layers)

        def cut(path, spec, leaf):
            if path.startswith("decoder/blocks/"):
                leaf = leaf[:n].clone()
                spec = dataclasses.replace(spec, shape=(n,) + spec.shape[1:])
            return shard(path, spec, leaf) if shard else leaf
        return P.init_params(M.model_template(deep), gen, self.dtype, device,
                             shard=cut)


class ArrayWeights:
    """Weights from an ``.npz`` file of "/"-joined paths (``save_arrays``;
    e.g. the reference's parameters), mapped as ``params.from_jax`` maps
    them, each leaf sliced as it is loaded."""

    def __init__(self, path: str, dtype=None):
        self.path, self.dtype = path, dtype

    def __call__(self, cfg, device, shard=None):
        with np.load(self.path) as f:
            tree = {k: f[k] for k in f.files}
        return P.from_jax(M.model_template(cfg), tree, self.dtype, device,
                          shard=shard)


def save_arrays(path: str, tree) -> None:
    """Write a nested dict of arrays for ``ArrayWeights``."""
    np.savez(path, **{k: np.asarray(v) for k, v in P.leaves(tree)})


def serve_worker(mesh: Mesh, device) -> None:
    """The loop of a rank other than 0: build each engine rank 0 sends,
    run its stages until it closes, until rank 0 says exit."""
    group = mesh.group
    while True:
        msg = group.broadcast_object(wait=True)
        if msg[0] == "exit":
            return
        if msg[0] != "engine":
            raise ValueError(f"expected an engine, got {msg[0]!r}")
        _, cfg, opts, kw, weights = msg
        eng = ServingEngine(cfg, opts, weights, mesh=mesh, device=device,
                            **kw)
        while True:
            msg = group.broadcast_object(wait=True)
            if msg[0] == "exit":        # rank 0 gave its engine up
                return
            if msg[0] == "close":
                break
            _, name, args = msg
            eng._dev(name, *args)
        del eng


def _worker_main(rank: int, size: int, store_path: str, device: str,
                 timeout: float) -> None:
    """A worker rank's process: its loop, then its end. The process ends
    with ``os._exit`` once its group is shut down: a spawned process that
    returned would tear the interpreter down with the gloo group's threads
    still joinable, which now and then aborted it (SIGABRT, "terminate
    called without an active exception", exit code -6) after a clean
    exit, and rank 0's ``Mesh.shutdown`` raised on that code."""
    torch.set_num_threads(1)
    store = torch.distributed.FileStore(store_path, size)
    code, mesh = 0, None
    try:
        mesh = make_serving_mesh(size, store=store, rank=rank,
                                 timeout=timeout)
        serve_worker(mesh, device)
    except BaseException:
        report = traceback.format_exc()
        store.set(f"error/{rank}", report)
        print(report, file=sys.stderr)
        code = 1
    shutdown = getattr(getattr(mesh, "group", None) and mesh.group.pg,
                       "shutdown", None)
    if shutdown is not None:
        try:
            shutdown()
        except RuntimeError:
            pass            # a group that a failure left broken
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)


def spawn_mesh(model: int, *, device="cpu", timeout: float = 60.0,
               store_dir=None) -> Mesh:
    """A gloo serving mesh of ``model`` ranks: this process is rank 0, and
    ranks 1..N-1 are started here with the ``spawn`` method (never
    ``fork``, which a CUDA context does not survive), each on ``device``
    (ranks share one card). They meet through a ``FileStore`` in
    ``store_dir`` (a new temporary directory by default). The mesh's
    ``workers`` are the processes: ``ServingEngine.close()`` or
    ``mesh.shutdown()`` joins them."""
    if model == 1:
        return make_serving_mesh(1)
    scratch = None
    if store_dir is None:
        scratch = tempfile.TemporaryDirectory(prefix="repro_torch_mesh_")
        store_dir = scratch.name
    path = os.path.join(str(store_dir), f"store_{os.getpid()}_{next(_SEQ)}")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker_main,
                         args=(r, model, path, str(device), timeout),
                         name=f"shard-rank{r}", daemon=True)
             for r in range(1, model)]
    for p in procs:
        p.start()
    try:
        mesh = make_serving_mesh(model, store=path, rank=0,
                                 timeout=timeout)
    except BaseException:
        for p in procs:
            p.kill()
            p.join()
        raise
    mesh.workers = procs
    mesh.scratch = scratch
    return mesh
