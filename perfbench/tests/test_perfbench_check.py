"""The check that decides ``correct``, on the CPU at a tiny size: the port
agrees with the plain reference, the control in the precision below the
configuration's fails, and so does a run with the timed path broken
underneath or with the CG stopped short of the configuration's tolerance.
The port's capacities also hold the exact volume of the body."""

import copy
import math
import time

import pytest
import torch

import penguin_tpu_torch
from penguin_tpu_torch.solvers.heat_fast import FastHeatBE
from perfbench import traffic as generator
from perfbench.harness import Bench, run_cell
from conftest import ROOT

CELLS = ["heat2d-stiff-f64", "heat3d-easy-f64", "heat2d-easy-f64"]
SEED = 2 ** 31 + 4242
CPU = torch.device("cpu")


def _run(root, cell, seed=SEED):
    return run_cell(Bench(root), cell, seed, 0.01, False, CPU,
                    time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_port_agrees_with_reference(tiny_root, cell):
    result, check = _run(tiny_root, cell)
    assert result["correct"], check
    assert result["failed"] == 0 and result["attempted"] >= 2


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tiny_root, cell):
    bench = Bench(tiny_root)
    w = bench.cell(cell)
    config = bench.config(w["config"])
    traffic = bench.data("workloads", w["traffic"])
    ref = bench.module("reference", config["reference"])
    inputs = generator.make_inputs(config, traffic, SEED, CPU)
    exact = ref.reference(config, traffic, inputs, CPU)
    low = ref.reference(config, traffic, inputs, CPU,
                        precision=ref.CONTROL[getattr(torch,
                                                      config["dtype"])])
    low["fields"] = [low["field"]]
    numbers = ref.compare(low, exact, config)
    limits = bench.data("limits", cell)
    assert any(not math.isfinite(numbers[k]) or numbers[k] > v
               for k, v in limits.items()), numbers


def _stuck(self, Tw, x0=None):
    return Tw, torch.zeros((), dtype=torch.int64, device=Tw.device)


def _altered_matvec(matvec):
    def wrapped(coeffs, x):
        y = matvec(coeffs, x).clone()
        mid = tuple(s // 2 for s in y.shape)
        y[mid] = y[mid] * 1.01 + 1e-3 * y.abs().max()
        return y
    return staticmethod(wrapped)


def _altered_field(run):
    def wrapped(self, T0, n):
        T, last, most = run(self, T0, n)
        T = T.clone()
        T[tuple(s // 2 for s in T.shape)] += 1e-3
        return T, last, most
    return wrapped


def _altered_capacity(build):
    def wrapped(*args, **kwargs):
        cap = build(*args, **kwargs)
        V = cap.V.clone()
        V[tuple(s // 2 for s in V.shape)] *= 1.001
        cap.V = V
        return cap
    return wrapped


FAULTS = {
    "step returns its state unchanged":
        lambda mp: mp.setattr(FastHeatBE, "step", _stuck),
    "matvec answer altered where produced":
        lambda mp: mp.setattr(FastHeatBE, "_cg_matvec",
                              _altered_matvec(FastHeatBE._cg_matvec)),
    "field altered where produced":
        lambda mp: mp.setattr(FastHeatBE, "run_telemetry",
                              _altered_field(FastHeatBE.run_telemetry)),
    "capacity altered where produced":
        lambda mp: mp.setattr(penguin_tpu_torch, "compute_capacity",
                              _altered_capacity(
                                  penguin_tpu_torch.compute_capacity)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["heat2d-stiff-f64", "heat3d-easy-f64"])
def test_broken_path_is_not_correct(tiny_root, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    result, check = _run(tiny_root, cell)
    assert not result["correct"], check


def _loose_run(root, cell, factor):
    """A run with the program's CG tolerance ``factor`` times the
    configuration's, the guarantee weakened."""
    bench = Bench(root)
    config = bench.config(bench.cell(cell)["config"])
    path = bench.module("paths", config["path"])
    sound = path.Entry

    class Loose(sound):
        def __init__(self, config, *rest):
            super().__init__(dict(config, cg_tol=factor * config["cg_tol"]),
                             *rest)

    path.Entry = Loose
    try:
        return run_cell(bench, cell, SEED, 0.01, False, CPU,
                        time.perf_counter())
    finally:
        path.Entry = sound


@pytest.mark.parametrize("cell", CELLS)
def test_loose_cg_tolerance_is_seen(tiny_root, cell):
    """At 100 times its tolerance the program's field readings rise with
    it, far above a sound run's; at 10^4 times they fail the cell's limits.
    (At the cells' own sizes 10 and 100 times fail them: see calibrate.)"""
    _, sound = _run(tiny_root, cell)
    _, loose = _loose_run(tiny_root, cell, 100.0)
    for key in ("field", "field_residual"):
        assert loose[key]["value"] > 30 * sound[key]["value"], (sound, loose)
    result, check = _loose_run(tiny_root, cell, 1e4)
    assert not result["correct"], check


@pytest.mark.parametrize("ndim, cells, volume_gap", [(2, 32, 2e-3),
                                                     (3, 12, 1e-3)])
def test_port_capacity_holds_the_exact_volume(ndim, cells, volume_gap):
    """Independent of the frozen quadrature: the port's total volume is the
    disk's or the ball's to the method's truncation error at this size."""
    bench = Bench(ROOT)
    config = next(bench.config(c["name"]) for c in bench.spec["configs"]
                  if bench.config(c["name"])["ndim"] == ndim)
    config = dict(copy.deepcopy(config), cells=cells)
    traffic = bench.data("workloads", "be-easy-dt0.25-it24")
    inputs = generator.make_inputs(config, traffic, SEED, CPU)
    entry = bench.module("paths", config["path"]).Entry(config, traffic,
                                                        inputs, CPU)
    ref = bench.module("reference", config["reference"])
    assert ref.volume_gap(entry.capacity["V"], config) < volume_gap
