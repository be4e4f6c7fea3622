"""The benchmark's files: every cell finds its files, and every name, unit
and field keeps to the benchmark's contract."""

import json
import re

import pytest

from perfbench.harness import Bench
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
BENCH = Bench(ROOT)
CELLS = [w["name"] for w in SPEC["workloads"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (SPEC["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("perfbench/") and c["file"] not in files
        files.add(c["file"])
        data = BENCH.config(c["name"])
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names)
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert _line(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for cell in CELLS:
        reported = [m["name"] for m in BENCH.metrics(cell, False)]
        assert "setup_s" in reported and len(reported) >= 2
        assert BENCH.metrics(cell, True)


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    w = BENCH.cell(cell)
    config = BENCH.config(w["config"])
    traffic = BENCH.data("workloads", w["traffic"])
    limits = BENCH.data("limits", cell)
    assert traffic["episode_steps"] % traffic["steps_per_interval"] == 0
    assert set(limits) == {"capacity", "operator", "field", "field_residual"}
    assert (BENCH.dir / "paths" / f"{config['path']}.py").is_file()
    assert (BENCH.dir / "reference" / f"{config['reference']}.py").is_file()
    for m in BENCH.metrics(cell, False) + BENCH.metrics(cell, True):
        assert callable(BENCH.reader(m["name"]).read)
