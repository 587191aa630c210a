"""One run of one cell: set-up, the measured window, the traced slice
(``--trace 1``), the comparison that decides ``correct``, and the result
line. ``run`` is the whole run without the look for a card, so that the
tests drive it on the CPU at small sizes."""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Any, Optional

from harness import manifest as MF
from harness.port import Weights, port_config

DRIVERS = {"control_loop": "harness.control_loop",
           "open_loop": "harness.open_loop"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """When this process started, on ``time.perf_counter``'s clock (its
    start time in /proc, against the boot clock), so that ``setup_s``
    counts the interpreter's start and the imports too."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter()


@dataclass
class Context:
    """What a driver is handed: the cell's files, the run's arguments,
    the port's configuration and the weights on the device."""
    workload: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    pcfg: Any
    params: dict
    readings: tuple = (None,)     # None: the program; "fp8", "fp8w"

    def sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        self.sync()
        return int(torch.cuda.max_memory_allocated())

    def empty_cache(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


@dataclass
class RunData:
    """What a per-layer metric's reader is handed."""
    workload: str
    cfg: dict
    traffic: dict
    window: dict
    traced: dict
    trace: Optional[Any]


def card() -> dict:
    """The card's name and power limit, by nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
        name, limit = [s.strip() for s in out.split(",")]
        return {"nvidia_smi": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


def verdict(readings: dict, limits: dict, failed: int, mode=None):
    """(correct, checks): every number that ``limits`` names, as ``mode``
    read it, within its limit, each present, and no request failed."""
    key = "" if mode is None else "/" + mode
    checks = {k: {"value": readings[k + key], "limit": lim}
              for k, lim in limits.items() if k + key in readings}
    ok = bool(checks) and len(checks) == len(limits) and failed == 0 and \
        all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", root: str = MF.ROOT, adjust=None, weights=None,
        readings=(None,), t_start: Optional[float] = None,
        raw: bool = False) -> dict:
    """One run of ``workload``: the result line as a dict, plus
    ``readings`` (every number read, for each mode of ``readings``: None
    the program, a precision of the reference its control, whose verdict
    by the same limits goes under ``controls``) and ``window`` (the
    driver's counters, their lists only under ``raw``).
    ``adjust(cfg, traffic)`` may return smaller
    copies (the CPU tests); ``weights``, a ``Weights`` of the same
    configuration, is drawn anew from ``seed`` instead of allocated."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    t_import = time.perf_counter()
    man = MF.load(root)
    wl, cfg, traffic = MF.cell(man, workload, root)
    if adjust is not None:
        cfg, traffic = adjust(cfg, traffic)
    dev = torch.device(device)
    pcfg = port_config(cfg)
    if weights is None:
        weights = Weights(pcfg, getattr(torch, cfg["dtype"]), dev)
    params = weights.draw(seed)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_weights = time.perf_counter()
    ctx = Context(workload, cfg, traffic, seed, seconds, trace, dev, pcfg,
                  params, tuple(readings))
    out = importlib.import_module(DRIVERS[traffic["kind"]]).run(ctx)
    e2e = dict(out["e2e"], setup_s=out["t_open"] - t_start)
    metrics = {}
    if not trace:
        for m in MF.end_to_end(man, workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        rd = RunData(workload, cfg, traffic, out["window"], out["traced"],
                     out["trace"])
        for m in MF.per_layer(man, workload):
            v = MF.reader(m["name"], root).read(rd)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    limits = cfg.get("limits", {})
    correct, checks = verdict(out["readings"], limits, out["failed"])
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": wl["chips"], "memory_peak_bytes": out["memory_peak"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": info}
    if trace and out["trace"] is not None:
        info["busy_s"] = out["trace"].busy_s
        info["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    controls = [m for m in readings if m is not None]
    if controls:
        result["controls"] = {m: verdict(out["readings"], limits,
                                         out["failed"], m)[0]
                              for m in controls}
    result["checks"] = checks
    result["readings"] = dict(out["readings"])
    result["window"] = {k: v for k, v in out["window"].items()
                        if raw or not isinstance(v, list)}
    # where set-up went: the interpreter and imports, the weights (and
    # the configuration), the driver's graphs, warm-up and lead-in
    result["window"].update(setup_import_s=t_import - t_start,
                            setup_weights_s=t_weights - t_import,
                            setup_driver_s=out["t_open"] - t_weights)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = process_start()
    import torch
    wl = MF.entry(MF.load()["workloads"], args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 t_start=t_start)
    result["device"].update(card())
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"the run loaded {loaded}: the benchmark measures the port "
              "alone", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    extra = {k: result.pop(k) for k in ("readings", "window")}
    print(json.dumps(extra), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result["checks"] = checks
    print(json.dumps(result))
    return 0
