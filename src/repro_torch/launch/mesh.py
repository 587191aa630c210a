"""Meshes of the port (the counterpart of the reference's
``launch/mesh.py``): the production mesh shapes the dry run places
parameters, caches and inputs over, and the meshes of ranks that the
sharded serving engine and the elastic shrink run on.

A ``Mesh`` is its axis sizes (``.shape``, ``.axis_names``: what
``distributed.sharding.spec_for`` reads), this process's ``rank`` in it,
and, for a serving mesh, the ``ShardGroup`` its ranks share. A rank is a
process: ``serving.sharded.spawn_mesh`` starts ranks 1..N-1 and makes
rank 0's mesh. With ``backend="gloo"`` several ranks may share one card
(or run on the CPU); ``"nccl"`` takes one card a rank.

``fake_device_mesh`` is the dry run's mesh: a torch ``DeviceMesh`` of the
production mesh's size whose process group is torch's fake backend, so
one process traces the partitioned step as rank 0 and no collective
moves a byte.
"""
from __future__ import annotations

import contextlib
import datetime
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.collectives import ShardGroup, make_group


def _validate_axes(devices: Optional[int] = None, **sizes) -> None:
    for name, n in sizes.items():
        if not isinstance(n, int) or isinstance(n, bool) or n < 1:
            raise ValueError(f"mesh axis {name!r} must be a positive int, "
                             f"got {n!r}")
    total = 1
    for n in sizes.values():
        total *= n
    if devices is not None and total > devices:
        raise ValueError(
            f"mesh {dict(sizes)} needs {total} ranks but only {devices} "
            f"are available (the port runs one rank a process: start "
            f"them with serving.sharded.spawn_mesh; gloo ranks may share "
            f"one card, nccl takes one card a rank)")


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    """Axis sizes of the production mesh: 16 x 16 ``data`` x ``model``, or
    2 x 16 x 16 with a leading ``pod`` axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    sizes = dict(zip(axes, shape))
    _validate_axes(**sizes)
    return sizes


@contextlib.contextmanager
def fake_device_mesh(sizes):
    """A ``DeviceMesh`` of axis ``sizes`` (a mapping of name to size, as
    ``production_mesh_shape`` or a dev mesh's ``.shape`` gives) backed by
    torch's fake process group: this process is rank 0 of prod(sizes)
    ranks, and the collectives it issues complete at once without moving
    data. Its device type is ``cuda``, the production mesh's: on a
    ``cpu`` mesh DTensor replaces each all-to-all by an all-gather, as
    gloo has none. It touches no card (the fake group moves nothing and
    the dry run's tensors live on the meta device), so it needs none.
    The fake group is the process's default group while the context
    lasts and is destroyed at its end; a process that already has a
    default group is refused (run the trace in a child process). A
    serving mesh's groups are never the default group
    (``collectives.make_group``), so they are left as they were."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    sizes = dict(sizes)
    _validate_axes(**sizes)
    if dist.is_initialized():
        raise RuntimeError("fake_device_mesh needs a process without a "
                           "default process group: run the trace in a "
                           "child process")
    world = 1
    for n in sizes.values():
        world *= n
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())
    try:
        yield DeviceMesh("cuda", torch.arange(world).reshape(
            tuple(sizes.values())), mesh_dim_names=tuple(sizes))
    finally:
        dist.destroy_process_group()


@dataclass
class Mesh:
    """Axis sizes (row-major: the last axis varies fastest over ranks),
    this process's ``rank``, and a serving mesh's ``group`` and ``store``.
    ``workers`` holds the processes of ranks 1..N-1 when this process
    started them (``serving.sharded.spawn_mesh``)."""
    shape: Dict[str, int]
    rank: int = 0
    group: Optional[ShardGroup] = None
    store: object = None
    backend: Optional[str] = None
    workers: List = field(default_factory=list)
    scratch: object = None      # a temporary directory the store lives in

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def worker_error(self) -> Optional[str]:
        """What a failed worker rank reported (``serving.sharded`` writes
        its traceback to the store before it exits), or the exit code of
        a worker process that ended, or None."""
        if self.store is not None:
            for r in range(1, self.size):
                key = f"error/{r}"
                if self.store.check([key]):
                    return (f"worker rank {r} failed:\n"
                            + self.store.get(key).decode())
        for p in self.workers:
            if not p.is_alive():
                return f"worker {p.name} exited with code {p.exitcode}"
        return None

    def shutdown(self, timeout: float = 60.0) -> None:
        """Tell the worker ranks this process started to exit, and join
        them; a worker that does not exit in ``timeout`` is killed, and one
        that failed raises here."""
        if not self.workers:
            return
        try:
            self.group.broadcast_object(("exit",))
        except RuntimeError:
            pass            # a worker already gone: its exit code says why
        failed = []
        for p in self.workers:
            p.join(timeout)
            if p.is_alive():
                p.kill()
                p.join()
            if p.exitcode != 0:
                failed.append((p.name, p.exitcode))
        self.workers = []
        if failed:
            raise RuntimeError(f"worker ranks exited with {failed}")


def _store(store, size: int, timeout: float):
    """A ``torch.distributed`` store: the one given, or a ``FileStore`` at
    a path."""
    if not isinstance(store, str):
        return store
    st = torch.distributed.FileStore(store, size)
    st.set_timeout(datetime.timedelta(seconds=timeout))
    return st


def make_serving_mesh(model: int, *, backend: str = "gloo", store=None,
                      rank: int = 0, timeout: float = 60.0) -> Mesh:
    """A one-axis ``model`` mesh for tensor-parallel serving
    (``ServingEngine(mesh=...)``): attention heads, MLP width, vocab and
    the KV pool's head axis shard over it (``serving_rules``). Every rank
    calls this with its ``rank`` and the same ``store`` (a
    ``torch.distributed`` store, e.g. a ``TCPStore`` across hosts, or the
    path of a ``FileStore``);
    the call returns once all ``model`` ranks have joined the group, or
    raises after ``timeout`` seconds, which also bounds each collective
    afterwards. A mesh of one rank needs no store."""
    devices = None
    if backend == "nccl":
        devices = torch.cuda.device_count()
    _validate_axes(devices=devices, model=model)
    if not 0 <= rank < model:
        raise ValueError(f"rank {rank} is outside a mesh of {model}")
    if store is None:
        if model > 1:
            raise ValueError("a mesh of more than one rank needs a store "
                             "its ranks share")
        store = torch.distributed.HashStore()
    st = _store(store, model, timeout)
    group = make_group(st, rank, model, backend=backend, timeout=timeout)
    return Mesh({"model": model}, rank=rank, group=group, store=st,
                backend=backend)


def make_elastic_mesh(data: int, model: int = 16, *,
                      devices: Optional[int] = None) -> Mesh:
    """A ``data`` x ``model`` mesh of sizes only, for the elastic shrink
    after node loss (``checkpoint.resilience.elastic_shrink`` re-slices a
    state for it). ``devices`` bounds the ranks it may use."""
    _validate_axes(devices=devices, data=data, model=model)
    return Mesh({"data": data, "model": model})


def make_dev_mesh(data: int = 1, model: int = 2, *,
                  devices: Optional[int] = None) -> Mesh:
    """A small ``data`` x ``model`` mesh of sizes only for tests and
    examples, validated against ``devices`` when given."""
    _validate_axes(devices=devices, data=data, model=model)
    return Mesh({"data": data, "model": model})
