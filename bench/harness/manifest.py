"""``BENCHMARK.json`` and the files it names: a cell's configuration and
traffic mix, and the metrics it reports. Everything is found by name, so a
new configuration, mix or per-layer metric is a new file and a new entry."""
from __future__ import annotations

import importlib.util
import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def entry(entries, name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def cell(manifest: dict, workload: str, root: str = ROOT):
    """(workload entry, configuration file, traffic file) of a cell."""
    wl = entry(manifest["workloads"], workload)
    cfg_entry = entry(manifest["configs"], wl["config"])
    with open(os.path.join(root, cfg_entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "bench", "traffic",
                           wl["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return wl, cfg, traffic


def end_to_end(manifest: dict, workload: str):
    """The end-to-end metrics a cell reports: those that list it, and
    those that list no cells."""
    return [m for m in manifest["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(manifest: dict, workload: str):
    """The per-layer metrics a cell reports: those whose ``workloads``
    list it (every per-layer entry has the list)."""
    return [m for m in manifest["per_layer"] if workload in m["workloads"]]


def reader(name: str, root: str = ROOT):
    """The module ``bench/metrics/<name>.py``: ``read(run)`` gives the
    metric's value, or None where the run has nothing for it to read."""
    path = os.path.join(root, "bench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
