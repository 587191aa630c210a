"""BENCHMARK.json against the benchmark's contract: names, units and
lengths in the allowed characters, every configuration used by a cell,
every per-layer metric's ``moves`` reported in each of its cells, the
files it names present, and the readers' own metadata equal to the
manifest's."""
import json
import os
import re

import pytest

from harness import manifest as MF

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")
MAN = MF.load()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    with open(os.path.join(MF.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(MAN["command"]) <= 32
    assert all(_line(w) for w in MAN["command"])


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_text(section):
    entries = MAN[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for k in TEXT_KEYS:
            if k in e:
                assert _line(e[k]), (e["name"], k)


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["workloads"], m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_config_has_a_cell_and_its_file():
    used = {w["config"] for w in MAN["workloads"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        with open(os.path.join(MF.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in MAN["workloads"]) <= max(
        1, len(MAN["workloads"]) // 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    assert "setup_s" in {m["name"] for m in MAN["end_to_end"]}
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in MF.end_to_end(MAN, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert MF.per_layer(MAN, w["name"]), w["name"]
        MF.cell(MAN, w["name"])           # its files load


def test_moves_names_an_end_to_end_metric_of_each_of_its_cells():
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        for wl in m["workloads"]:
            assert wl in cells, (m["name"], wl)
            assert m["moves"] in {e["name"] for e in MF.end_to_end(MAN, wl)}
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_reader_metadata_matches_the_manifest(metric):
    m = MF.entry(MAN["per_layer"], metric)
    mod = MF.reader(metric)
    assert (mod.LAYER, mod.SOURCE, mod.UNIT, mod.MOVES) == (
        m["layer"], m["source"], m["unit"], m["moves"])
    assert callable(mod.read)


def test_shares_of_a_peak_are_percent():
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"] or \
                m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%" and m["better"] == "higher"
