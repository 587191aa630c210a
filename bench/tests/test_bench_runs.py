"""Whole runs of each cell on the CPU at small sizes (``run_cell.run``
past the look for a card): set-up, the window, the comparison, the result
line; the open loop's clock; and a cell added by files alone."""
import json
import os
import shutil
import time

import pytest

from conftest import ROOT, shrink
from harness import manifest as MF
from harness.run_cell import run

MAN = MF.load()
CELLS = [w["name"] for w in MAN["workloads"]]
SEED = 2 ** 33 + 101


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_at_small_size(cell):
    r = run(cell, SEED, 0.3, False, device="cpu", adjust=shrink)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in MF.end_to_end(MAN, cell)}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_its_counter_metrics(cell):
    r = run(cell, SEED + 1, 0.3, True, device="cpu", adjust=shrink)
    names = {m["name"]: m for m in MF.per_layer(MAN, cell)}
    # the CPU has no device trace: only the counters' and clocks' metrics
    assert set(r["metrics"]) == {n for n, m in names.items()
                                 if m["source"] != "device_trace"}
    for n, v in r["metrics"].items():
        assert v["value"] >= 0 and v["unit"] == names[n]["unit"]


def test_control_window_is_all_its_steps():
    t0 = time.perf_counter()
    r = run("molmoact-7b.control-b4", SEED, 0.5, False, device="cpu",
            adjust=shrink)
    w = r["window"]
    assert w["step_s"] * w["control_steps"] >= 0.5
    assert w["step_s"] * w["control_steps"] < time.perf_counter() - t0
    assert r["metrics"]["control_step_ms"]["value"] == pytest.approx(
        w["step_s"] * 1e3)
    assert r["attempted"] == w["control_steps"] * w["robots"]


def test_open_loop_counts_a_stall_against_every_later_request(monkeypatch):
    """One tick stalls for 0.6 s inside the window: every request that
    fell due during the stall waited for it, from its due time."""
    from repro_torch.serving.engine import ServingEngine
    real = ServingEngine.step_fused
    stall = {}

    def step_fused(self):
        t = time.perf_counter()
        if "at" in stall and "end" not in stall and t >= stall["at"]:
            stall["start"] = t
            time.sleep(0.6)
            stall["end"] = time.perf_counter()
        return real(self)

    def adjust(cfg, tr):
        cfg, tr = shrink(cfg, tr)
        return cfg, dict(tr, rate_per_s=15.0)

    monkeypatch.setattr(ServingEngine, "step_fused", step_fused)
    orig = MF.cell

    def cell(*a, **k):
        out = orig(*a, **k)
        stall["at"] = time.perf_counter() + 1.0
        return out
    monkeypatch.setattr(MF, "cell", cell)
    r = run("molmoact-7b.fleet-open", SEED, 1.5, False, device="cpu",
            adjust=adjust, raw=True)
    w = r["window"]
    assert "end" in stall
    start, end = stall["start"] - w["t_open"], stall["end"] - w["t_open"]
    hit = [(d, t) for d, t in zip(w["due_s"], w["ttft_s"])
           if start <= d < end]
    assert hit
    for d, t in hit:
        assert t >= end - d - 1e-6
    assert len(w["latency_s"]) == r["attempted"] == w["requests"]


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as new files and new entries; no existing file changes."""
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    cfg = json.load(open(os.path.join(ROOT, "bench", "configs",
                                      "molmoact-7b.json")))
    cfg["name"] = "throwaway-7b"
    (tmp_path / "bench" / "configs" / "throwaway-7b.json").write_text(
        json.dumps(cfg))
    (tmp_path / "bench" / "traffic" / "throwaway-mix.json").write_text(
        json.dumps({"kind": "control_loop", "robots": 3, "text_tokens": 8,
                    "warm_steps": 1, "check_steps": 2}))
    (tmp_path / "bench" / "metrics" / "throwaway_steps.py").write_text(
        '"""Control steps in the window."""\nLAYER = "control step"\n'
        'SOURCE = "program_counter"\nUNIT = "steps"\n'
        'MOVES = "control_step_ms"\n\n\ndef read(run):\n'
        '    return float(run.window["control_steps"])\n')
    man["configs"].append({"name": "throwaway-7b", "source": "x",
                           "file": "bench/configs/throwaway-7b.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "throwaway-7b.mix",
                             "config": "throwaway-7b",
                             "traffic": "throwaway-mix", "chips": 1,
                             "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "control_step_ms":
            m["workloads"].append("throwaway-7b.mix")
    man["per_layer"].append({"name": "throwaway_steps", "unit": "steps",
                             "better": "higher", "source": "program_counter",
                             "layer": "control step", "moves":
                             "control_step_ms",
                             "workloads": ["throwaway-7b.mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    def adjust(cfg, tr):
        cfg, small = shrink(cfg, tr)
        return cfg, dict(small, robots=tr["robots"])
    r = run("throwaway-7b.mix", SEED, 0.3, False, device="cpu",
            adjust=adjust, root=str(tmp_path))
    assert r["correct"] and r["attempted"] % 3 == 0
    assert set(r["metrics"]) == {"control_step_ms", "setup_s"}
    r = run("throwaway-7b.mix", SEED, 0.3, True, device="cpu",
            adjust=adjust, root=str(tmp_path))
    assert r["metrics"]["throwaway_steps"]["value"] >= 1
    for p, b in before.items():
        assert p.read_bytes() == b, p
