"""The DFG channel cell: its files are found by name, the heat cells report
what they did before it came, its four span readers read a synthetic trace
with overlaps computed by hand, and a tiny copy of the cell runs on the CPU,
where the check sees the fgmres tolerance loosened."""

import json
import time

import pytest
import torch

from perfbench.harness import Bench, run_cell
from conftest import ROOT

BENCH = Bench(ROOT)
CELL = "dfg2d2-picard"
MS = 1_000_000  # ns
SEED = 2 ** 33 + 17

# what the heat cells reported before the DFG cell was added
HEAT = {
    "heat2d-stiff-f64": (
        ["setup_s", "step_ms"],
        ["capacity_s", "kernels_per_step", "host_syncs_per_step",
         "stencil_launches_per_step", "stencil5_us", "device_idle_pct",
         "cg_chunk_ms", "idle_cg_pct", "idle_sync_pct", "cg_graph_share"]),
    "heat3d-easy-f64": (
        ["setup_s", "step_ms.3d"],
        ["capacity_s", "kernels_per_step.3d", "host_syncs_per_step.3d",
         "stencil_launches_per_step.3d", "stencil7_roofline",
         "device_idle_pct.3d", "idle_sync_pct.3d", "cg_graph_share.3d"]),
    "heat2d-easy-f64": (
        ["setup_s", "step_ms", "step_ms_p95"],
        ["capacity_s", "kernels_per_step", "host_syncs_per_step",
         "stencil_launches_per_step", "stencil5_us", "device_idle_pct",
         "cg_chunk_ms", "idle_cg_pct", "idle_sync_pct", "cg_graph_share"]),
}
NEW = ["gmres_iters_per_step", "gmres_iter_ms", "idle_precond_pct",
       "idle_host_read_pct"]


def read(name, rec):
    return BENCH.reader(name).read(rec)


def test_the_cell_finds_its_files():
    w = BENCH.cell(CELL)
    config = BENCH.config(w["config"])
    traffic = BENCH.data("workloads", w["traffic"])
    assert config["path"] == "ns_picard" and config["reference"] == "ns_picard"
    assert traffic["episode_steps"] == 10 and traffic["steps_per_interval"] == 5
    assert set(BENCH.data("limits", CELL)) == {
        "capacity", "operator", "field", "field_residual"}
    e2e = [m["name"] for m in BENCH.metrics(CELL, False)]
    assert e2e == ["setup_s", "step_ms"]
    layer = [m["name"] for m in BENCH.metrics(CELL, True)]
    assert layer == ["capacity_s", "kernels_per_step", "host_syncs_per_step",
                     "device_idle_pct"] + NEW
    assert w["chips"] == 1


@pytest.mark.parametrize("cell", sorted(HEAT))
def test_heat_cells_report_what_they_did(cell):
    e2e, layer = HEAT[cell]
    assert [m["name"] for m in BENCH.metrics(cell, False)] == e2e
    assert [m["name"] for m in BENCH.metrics(cell, True)] == layer


def _rec():
    """A 20 ms window over 2 steps; the device is busy over [1, 3], [5, 6],
    [7, 9] and [12, 13] ms (idle 14 ms, 70%)."""
    device = [("void fill", 1 * MS, 3 * MS, 7),
              ("void elementwise", 5 * MS, 6 * MS, 7),
              ("Memcpy DtoH (Device -> Pageable)", 7 * MS, 9 * MS, 7),
              ("void reduce", 12 * MS, 13 * MS, 7)]
    host = [
        ("navierstokes.step", 0.5 * MS, 15 * MS, 1),
        # iteration 1, 7 ms: M over [2, 5.5] (busy [2, 3], [5, 5.5]: 2 ms
        # idle), its host read over [6, 7.5] (busy [6, 6] none, [7, 7.5]:
        # 1 ms idle)
        ("linsolve.fgmres_iter", 1 * MS, 8 * MS, 1),
        ("stokes.precond", 2 * MS, 5.5 * MS, 1),
        ("linsolve.fgmres_host", 6 * MS, 7.5 * MS, 1),
        # iteration 2, 5 ms: M over [8, 11] (busy [8, 9]: 2 ms idle), its
        # host read over [11, 12.5] (busy [12, 12.5]: 1 ms idle)
        ("linsolve.fgmres_iter", 8 * MS, 13 * MS, 1),
        ("stokes.precond", 8 * MS, 11 * MS, 1),
        ("linsolve.fgmres_host", 11 * MS, 12.5 * MS, 1),
        # names that only resemble a span's are not read
        ("linsolve.fgmres_iters", 13 * MS, 20 * MS, 1),
        ("aten::stokes.precond", 13 * MS, 20 * MS, 1),
    ]
    return dict(trace=dict(span=(0, 20 * MS), host=host, device=device,
                           steps=2))


def test_readers_on_hand_computed_overlaps():
    rec = _rec()
    assert read("gmres_iters_per_step", rec) == pytest.approx(1.0)
    assert read("gmres_iter_ms", rec) == pytest.approx((7.0 + 5.0) / 2)
    assert read("idle_precond_pct", rec) == pytest.approx(100 * 4 / 20)
    assert read("idle_host_read_pct", rec) == pytest.approx(100 * 2 / 20)
    assert (read("idle_precond_pct", rec) + read("idle_host_read_pct", rec)
            <= read("device_idle_pct", rec))


def test_readers_find_nothing_in_a_program_without_the_spans():
    rec = _rec()
    rec["trace"]["host"] = [ev for ev in rec["trace"]["host"]
                            if not ev[0].startswith(("linsolve.", "stokes."))]
    for name in NEW:
        assert read(name, rec) is None
    assert all(read(name, dict(trace=None)) is None for name in NEW)


def _tiny(root, factor=1.0):
    """The cell on a 44 × 16 channel, fgmres at ``factor`` times its
    tolerance: (result, check)."""
    path = root / "perfbench" / "configs" / "dfg2d2_cylinder_f64.json"
    config = json.loads(path.read_text())
    config.update(grid=[44, 16], cells=44, cg_tol=factor * config["cg_tol"])
    path.write_text(json.dumps(config))
    return run_cell(Bench(root), CELL, SEED, 0.01, factor == 1.0,
                    torch.device("cpu"), time.perf_counter())


def test_tiny_cell_runs_and_sees_a_loose_tolerance(tiny_root):
    """A traced run reads the stepper's spans and the check's capacity and
    operator numbers at rounding; at 100 times its fgmres tolerance the
    momentum residual rises more than fivefold (1.4e-4 to 1.4e-3 at this
    size) and the field gap rises (0.022 to 0.050: the pressure's error,
    which no sweep's residual pins down, dominates it)."""
    result, sound = _tiny(tiny_root)
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["metrics"]["gmres_iters_per_step"]["value"] > 0
    assert sound["capacity"]["value"] <= 1e-13
    assert sound["operator"]["value"] <= 1e-13
    _, loose = _tiny(tiny_root, 100.0)
    assert loose["field_residual"]["value"] \
        > 5 * sound["field_residual"]["value"], (sound, loose)
    assert loose["field"]["value"] > sound["field"]["value"], (sound, loose)
