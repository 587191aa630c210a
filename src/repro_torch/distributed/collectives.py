"""Collectives of the sharded serving path over a ``torch.distributed``
process group: the port's counterpart of ``jax.lax.psum`` /
``jax.lax.all_gather`` inside ``shard_map``, and of the reference's
``roofline/hlo.collective_bytes``.

A ``ShardGroup`` is one mesh axis's process group as its ranks see it. The
model calls ``all_reduce_sum`` (the attention and MLP output projections,
the vocab-sharded embedding) and ``all_gather_last`` (the vocab-sharded lm
head); the serving engine's rank 0 sends each device stage to the other
ranks with ``broadcast_object``.

Every data collective adds its *result's* bytes to a counter by kind
(``all-reduce``, ``all-gather``; ``counts()`` adds ``total``), the
reference's convention (``hlo.py``: the per-device wire traffic of a ring
is (n-1)/n of it), so a row carrying ``counts()`` as its ``collectives``
prices through ``roofline.report.to_terms(row, use_analytic=False)``.
Control messages are not counted. With ``seconds`` set to a dict (zeros
by kind), each data collective also adds the seconds it took, the card
synchronized before and after it so that its wait on earlier work is not
counted: a measurement switch, off (None) on the serving path.

Gloo takes the card's tensors for both data collectives (ranks sharing
one card); a collective it refused would raise.
"""
from __future__ import annotations

import datetime
import pickle
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather")


class ShardWorkerError(RuntimeError):
    """A rank other than 0 failed or stopped answering: raised on rank 0,
    with the failed rank's report when it left one."""

# the first broadcast of a control message carries its length and, when
# it fits, the message itself; a longer one takes a second broadcast
_INLINE = 4096
_FOREVER = datetime.timedelta(days=365)


class ShardGroup:
    """A process group over one mesh axis (``axis``), seen from ``rank`` of
    ``size``. ``timeout`` (seconds) bounds every data collective and every
    control message a rank other than 0 sends; a rank waiting for its next
    control message waits without a bound (rank 0 may idle between
    requests), and learns of rank 0's end from its closed connection."""

    def __init__(self, pg, rank: int, size: int, *, axis: str = "model",
                 backend: str = "gloo", timeout: float = 60.0):
        self.pg, self.rank, self.size = pg, rank, size
        self.axis, self.backend, self.timeout = axis, backend, timeout
        self.bytes: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.seconds: Optional[Dict[str, float]] = None

    # -- counters ----------------------------------------------------------
    def counts(self) -> Dict[str, float]:
        """Bytes by kind since the last ``reset_counts``, and ``total``."""
        out = {k: float(v) for k, v in self.bytes.items()}
        out["total"] = float(sum(self.bytes.values()))
        return out

    def reset_counts(self) -> None:
        self.bytes = dict.fromkeys(KINDS, 0)

    # -- data collectives ----------------------------------------------------
    def _opts(self, cls):
        o = cls()
        o.timeout = datetime.timedelta(seconds=self.timeout)
        return o

    def _run(self, kind: str, call, *tensors):
        """``call(*tensors)`` (returns a Work), timed into ``seconds`` when
        that is set."""
        if self.seconds is None:
            call(*tensors).wait()
            return
        cuda = tensors[0].is_cuda
        if cuda:
            torch.cuda.synchronize(tensors[0].device)
        t0 = time.perf_counter()
        call(*tensors).wait()
        if cuda:
            torch.cuda.synchronize(tensors[0].device)
        self.seconds[kind] += time.perf_counter() - t0

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group's ranks (``psum``)."""
        y = x.contiguous()
        self.bytes["all-reduce"] += y.numel() * y.element_size()
        self._run("all-reduce",
                  lambda t: self.pg.allreduce(
                      [t], self._opts(dist.AllreduceOptions)), y)
        return y

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated on the last axis in rank order
        (``all_gather(..., axis=-1, tiled=True)``)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self.bytes["all-gather"] += (x.numel() * x.element_size()
                                     * self.size)
        self._run("all-gather",
                  lambda src, *out: self.pg.allgather(
                      [list(out)], [src],
                      self._opts(torch._C._distributed_c10d
                                 .AllgatherOptions)), x, *parts)
        return torch.cat(parts, dim=-1)

    # -- control messages ----------------------------------------------------
    def broadcast_object(self, obj=None, *, wait: bool = False):
        """Rank 0's ``obj`` on every rank (pickled through CPU byte
        buffers). ``wait`` (ranks other than 0) waits without a bound for
        the next message."""
        head = torch.zeros(_INLINE + 8, dtype=torch.uint8)
        if self.rank == 0:
            data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
            head[:8] = torch.tensor([len(data)], dtype=torch.int64).view(
                torch.uint8)
            inline = data[:_INLINE]
            head[8:8 + len(inline)] = torch.frombuffer(
                bytearray(inline), dtype=torch.uint8)
        o = dist.BroadcastOptions()
        o.rootRank = 0
        o.timeout = (_FOREVER if wait
                     else datetime.timedelta(seconds=self.timeout))
        self.pg.broadcast([head], o).wait()
        n = int(head[:8].view(torch.int64)[0])
        if n > _INLINE:
            rest = torch.zeros(n - _INLINE, dtype=torch.uint8)
            if self.rank == 0:
                rest.copy_(torch.frombuffer(bytearray(data[_INLINE:]),
                                            dtype=torch.uint8))
            o.timeout = datetime.timedelta(seconds=self.timeout)
            self.pg.broadcast([rest], o).wait()
            payload = bytes(head[8:].numpy()) + bytes(rest.numpy())
        else:
            payload = bytes(head[8:8 + n].numpy())
        return obj if self.rank == 0 else pickle.loads(payload)


def make_group(store, rank: int, size: int, *, backend: str = "gloo",
               timeout: float = 60.0, axis: str = "model") -> ShardGroup:
    """A ``ShardGroup`` of its own over ``store`` (never the default
    group, so two engines in one process never interleave their
    collectives). ``backend`` "gloo" (CPU tensors, or ranks sharing one
    card) or "nccl" (one card a rank; accepted, not verified here)."""
    td = datetime.timedelta(seconds=timeout)
    if backend == "gloo":
        pg = dist.ProcessGroupGloo(store, rank, size, td)
    elif backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = td
        pg = dist.ProcessGroupNCCL(store, rank, size, opts)
    else:
        raise ValueError(f"backend must be 'gloo' or 'nccl', got "
                         f"{backend!r}")
    return ShardGroup(pg, rank, size, axis=axis, backend=backend,
                      timeout=timeout)
