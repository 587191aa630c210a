"""The device trace of a short slice of a run, by torch.profiler (CUPTI),
exported as a Chrome trace into the run's temporary directory, read and
deleted. Adapted from the program's ``chip_smoke.py`` (``_traced``: a
warm-up cycle and an idle pause at each edge, since device events near
the edges of a traced window were sometimes missing; ``_short``: kernel
names without types and arguments).

A CUDA graph replay's kernels carry the correlation id of the host's
``cudaGraphLaunch``, so each replay's kernels are found by it
(``replays``). Kernels that a graph's conditional (IF) node runs are
dropped or misordered by the profiler: a trace of such a graph does not
account for them."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

PAD_S = 0.2
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cuda_runtime", "cuda_driver")


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and parameters."""
    name = name.replace("void ", "").replace("(anonymous namespace)::", "")
    return name.split("<")[0].split("(")[0].split("::")[-1].strip()


class Trace:
    """Device operations and host runtime calls of one traced slice, in
    microseconds on the trace's clock, each (name, start, end, corr)."""

    def __init__(self, events):
        self.ops, self.calls = [], []
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            rec = (e.get("name", ""), float(e["ts"]),
                   float(e["ts"]) + float(e["dur"]),
                   (e.get("args") or {}).get("correlation"))
            if cat in DEVICE_CATS:
                self.ops.append(rec)
            elif cat in HOST_CATS:
                self.calls.append(rec)
        self.ops.sort(key=lambda r: r[1])
        self.calls.sort(key=lambda r: r[1])

    def busy_intervals(self):
        merged = []
        for _, a, b, _ in self.ops:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    @property
    def window_s(self) -> float:
        """From the first host runtime call (or device operation) to the
        end of the last device operation."""
        if not self.ops:
            return 0.0
        start = min([self.ops[0][1]] + [c[1] for c in self.calls[:1]])
        return (max(o[2] for o in self.ops) - start) / 1e6

    def kernel_s(self, *keys) -> float:
        """Seconds of the operations whose name holds one of ``keys``."""
        return sum(b - a for n, a, b, _ in self.ops
                   if any(k in n for k in keys)) / 1e6

    def replays(self):
        """[(start, end, busy)] in seconds, one entry per host
        ``cudaGraphLaunch`` in launch order: the span of the device
        operations that carry its correlation id, and their busy time."""
        by_corr = {}
        for n, a, b, c in self.ops:
            by_corr.setdefault(c, []).append((a, b))
        out = []
        for n, a, b, c in self.calls:
            if "GraphLaunch" not in n:
                continue
            ops = by_corr.get(c)
            if not ops or c is None:
                out.append(None)
                continue
            out.append((min(o[0] for o in ops) / 1e6,
                        max(o[1] for o in ops) / 1e6,
                        sum(o[1] - o[0] for o in ops) / 1e6))
        return out

    def breakdown(self, top: int = 10):
        """The device operations that took the most time, and the longest
        idle gaps summed by the host runtime call in progress at each
        gap's end (``host`` where none was): [[name, seconds], ...]."""
        ops = {}
        for n, a, b, _ in self.ops:
            k = short(n)
            ops[k] = ops.get(k, 0.0) + (b - a) / 1e6
        gaps = {}
        merged = self.busy_intervals()
        starts = [c[1] for c in self.calls]
        for (_, b0), (a1, _) in zip(merged, merged[1:]):
            i = bisect.bisect_right(starts, a1) - 1
            # the runtime call the host was in when the device went idle
            # again, if it overlaps the gap; else Python between calls
            call = (self.calls[i][0] if i >= 0 and self.calls[i][2] > b0
                    else "host")
            gaps[call] = gaps.get(call, 0.0) + (a1 - b0) / 1e6
        rank = lambda d: [[k, v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def traced(body) -> Trace:
    """Run ``body()`` under torch.profiler's CUDA activity and return its
    ``Trace``. The trace file lives in a temporary directory under the
    run's ``TMPDIR`` and is deleted once read."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)
                     ) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            time.sleep(PAD_S)
            body()
            torch.cuda.synchronize()
            time.sleep(PAD_S)
            prof.step()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return Trace(events)
