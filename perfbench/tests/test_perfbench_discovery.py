"""A configuration, a traffic mix, a cell and a metric added as files are
found by name, with no edit of the harness."""

import json
import time

import torch

from perfbench.harness import Bench, run_cell


def test_new_files_are_found(tiny_root):
    pb = tiny_root / "perfbench"
    config = json.loads((pb / "configs" / "heat2d_circle_f64.json")
                        .read_text())
    config.update(name="heat2d_square_f64", radius=0.75)
    (pb / "configs" / "heat2d_square_f64.json").write_text(
        json.dumps(config))
    traffic = json.loads((pb / "workloads" / "be-easy-dt0.25-it24.json")
                         .read_text())
    traffic.update(name="be-mid-dt4", dt_h2=4.0, cg_maxiter=64)
    (pb / "workloads" / "be-mid-dt4.json").write_text(json.dumps(traffic))
    (pb / "limits" / "heat2d-mid.json").write_text(
        (pb / "limits" / "heat2d-easy-f64.json").read_text())
    (pb / "metrics" / "answer_count.py").write_text(
        "def read(rec):\n    return float(len(rec['interval_ms']))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(
        name="heat2d_square_f64", source=config["source"],
        file="perfbench/configs/heat2d_square_f64.json", reduced=[],
        why="a smaller circle"))
    spec["workloads"].append(dict(
        name="heat2d-mid", config="heat2d_square_f64", traffic="be-mid-dt4",
        chips=1, why="a middle time step"))
    spec["per_layer"].append(dict(
        name="answer_count", unit="intervals", better="higher",
        source="host_clock", layer="harness", moves="step_ms",
        workloads=["heat2d-mid"]))
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    result, check = run_cell(Bench(tiny_root), "heat2d-mid", 99, 0.01, True,
                             torch.device("cpu"), time.perf_counter())
    assert result["correct"], check
    assert result["metrics"]["answer_count"]["value"] == result["attempted"]
