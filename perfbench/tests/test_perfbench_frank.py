"""The Frank-disk cell on the CPU at 32² with 32 markers in f64 over 1+1
steps: its files are found by name, the path's markers and temperature
agree with the reference's plain march, the check passes a sound run under
the cell's own limits and fails a float32 run and a run at 100 times the
GN tolerance, and the reference loads nothing of JAX or of the program."""

import json
import math
import subprocess
import sys
import time

import pytest
import torch

from perfbench import traffic as generator
from perfbench.harness import Bench, run_cell
from conftest import ROOT

BENCH = Bench(ROOT)
CELL = "frank-disk-256"
SEED = 2 ** 33 + 29
N, STEPS = 32, 2
LIMIT_KEYS = {"capacity", "operator", "field", "front_residual", "radius"}
NEW = ["gn_iters_per_step", "gn_iter_ms", "idle_slab_build_pct",
       "idle_slab_solve_pct", "idle_update_pct", "idle_gn_host_pct"]


def _small(config, traffic, **over):
    config = {**config, "cells": N, "grid": [N, N], "markers": N, **over}
    traffic = {**traffic, "steps_per_interval": STEPS,
               "episode_steps": STEPS}
    return config, traffic


def _cell():
    w = BENCH.cell(CELL)
    return (BENCH.config(w["config"]),
            BENCH.data("workloads", w["traffic"]))


def _check(**over):
    """One episode of the path at the small size and the check of it:
    (entry, the compared numbers)."""
    config, traffic = _small(*_cell(), **over)
    device = torch.device("cpu")
    inputs = generator.make_inputs(config, traffic, SEED, device)
    entry = BENCH.module("paths", "stefan_ft").Entry(config, traffic, inputs,
                                                     device)
    state, _ = entry.interval(entry.start())
    entry.end_episode(state)
    ref = BENCH.module("reference", "stefan_ft")
    exact = {**config, "dtype": "float64"}
    return entry, ref.compare(entry.answers(),
                              ref.reference(exact, traffic, inputs, device),
                              exact)


def test_the_cell_finds_its_files():
    w = BENCH.cell(CELL)
    config, traffic = _cell()
    assert config["path"] == "stefan_ft" and config["reference"] == "stefan_ft"
    assert traffic["episode_steps"] == 4 and traffic["steps_per_interval"] == 4
    # the traffic's GN tolerance is the one calibrate scales
    assert traffic["newton_params"][1] == config["cg_tol"]
    assert set(BENCH.data("limits", CELL)) == LIMIT_KEYS
    assert [m["name"] for m in BENCH.metrics(CELL, False)] == [
        "setup_s", "step_ms"]
    assert [m["name"] for m in BENCH.metrics(CELL, True)] == [
        "capacity_s", "kernels_per_step", "host_syncs_per_step",
        "device_idle_pct"] + NEW
    assert w["chips"] == 1
    for m in BENCH.metrics(CELL, True):
        assert callable(BENCH.reader(m["name"]).read)


def test_the_path_follows_the_plain_march():
    """The path's per-step markers and final temperature against the
    reference's march from the same start.  The march differentiates the
    exactly clipped cell volumes, the port uses the intercept Jacobian,
    which leaves out the cosine between a marker's normal and its
    segments' (0.5% at 32 markers): both GN iterations run to their cap of
    8 and stop on the same plateau of ‖F‖ (6.0e-3, 6.3e-3 at this size) at
    slightly different points.  Measured: markers 3.6e-5 apart (1.4e-4 of
    a cell), the fields 1e-5 of max |T| apart; the tolerances take a
    cell's thousandth and 1e-4 of max |T|."""
    config, traffic = _small(*_cell())
    device = torch.device("cpu")
    inputs = generator.make_inputs(config, traffic, SEED, device)
    entry = BENCH.module("paths", "stefan_ft").Entry(config, traffic, inputs,
                                                     device)
    state, _ = entry.interval(entry.start())
    ref = BENCH.module("reference", "stefan_ft")
    prob = ref.Problem(config, traffic, device)
    mk, T0 = prob.start()
    assert torch.equal(mk, entry.mk0)
    log, T, iters, norms = prob.march(mk, T0, STEPS, traffic,
                                      config["cg_tol"])
    program = entry.solver
    assert iters == program.iters_log.tolist()
    h = float(config["length"]) / N
    gap = (log - torch.as_tensor(program.marker_log)).abs().max()
    assert float(gap) <= 1e-3 * h, float(gap)
    scale = float(T.abs().max())
    assert float((state[1][0] - T).abs().max()) <= 1e-4 * scale
    assert norms == pytest.approx(program.residual_log.tolist(), rel=0.05)


def test_an_interval_fails_off_the_radius_or_non_finite():
    """The path's failure rule: an interval fails when its markers or GN
    residuals go non-finite or its end radius misses ``S·sqrt(t)`` by more
    than ``radius_gate``.  A sound interval passes although its GN ends
    every step at the cap above the tolerance, as at 256² (the
    configuration's ``gn_floor``)."""
    config, traffic = _small(*_cell())
    device = torch.device("cpu")
    inputs = generator.make_inputs(config, traffic, SEED, device)
    entry = BENCH.module("paths", "stefan_ft").Entry(config, traffic, inputs,
                                                     device)
    _, telemetry = entry.interval(entry.start())
    most, miss, finite = telemetry.tolist()
    gate = config["radius_gate"]
    assert most == traffic["newton_params"][0] and finite == 1.0
    assert (entry.solver.residual_log > config["cg_tol"]).all()
    assert miss < gate / 2, miss
    assert not entry.interval_failed(telemetry.tolist())
    for bad in ([most, 1.5 * gate, 1.0], [most, math.nan, 1.0],
                [most, miss, 0.0]):
        assert entry.interval_failed(bad), bad


def test_a_sound_run_passes_and_its_faults_fail():
    """Under the cell's own limits the sound run passes every number and
    the program in float32 fails its capacities (2.1e-5 against 1e-12).
    At 100 times the GN tolerance the GN stops after 2 iterations a step
    and its fronts leave a larger Stefan residual: 1.920 against 1.755
    here (2.77 against 2.20 at 256², where the cell's limit lies between
    the two).  The GN's plateau sits elsewhere against a step's volume
    change at 32² than at 256², so this size takes its own
    ``front_residual`` limit between its own two readings."""
    limits = BENCH.data("limits", CELL)
    small = {**limits, "front_residual": 1.835}
    _, sound = _check()
    assert set(sound) == LIMIT_KEYS
    assert all(sound[k] <= limits[k] for k in limits), sound
    assert all(sound[k] <= small[k] for k in small), sound
    _, f32 = _check(dtype="float32")
    assert f32["capacity"] > limits["capacity"], f32
    _, loose = _check(cg_tol=100 * _cell()[0]["cg_tol"])
    assert any(loose[k] > small[k] for k in small), loose
    assert loose["front_residual"] > 1.05 * sound["front_residual"]


def test_the_cell_runs_through_the_harness(tiny_root):
    """A traced run of the cell at the small size: the span counts and
    times are numbers (the idle shares need device events, which a CPU
    trace has none of), every interval is sound, the check passes."""
    pb = tiny_root / "perfbench"
    path = pb / "configs" / "frank_disk_f64.json"
    config, _ = _small(json.loads(path.read_text()), {})
    path.write_text(json.dumps(config))
    path = pb / "workloads" / "gn-be-dt0.02-ep4.json"
    _, traffic = _small({}, json.loads(path.read_text()))
    path.write_text(json.dumps(traffic))
    result, check = run_cell(Bench(tiny_root), CELL, SEED, 0.01, True,
                             torch.device("cpu"), time.perf_counter())
    assert result["correct"], check
    assert result["failed"] == 0 and result["attempted"] >= 1
    for name in NEW[:2]:
        assert isinstance(result["metrics"][name]["value"], float), name
    assert not set(NEW[2:]) & set(result["metrics"])
    assert result["metrics"]["gn_iters_per_step"]["value"] == 8.0


def test_the_reference_loads_no_jax_and_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r); "
            "import perfbench.reference.stefan_ft; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "penguin_tpu",
                         "penguin_tpu_torch"}
