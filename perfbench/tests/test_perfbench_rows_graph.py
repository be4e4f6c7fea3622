"""The readers of ``rows_graph_share`` and ``idle_rows_pct`` on synthetic
traces (every apply of the Picard rows replayed, some, none, no trace;
idle time inside the applies computed by hand), and, on a card (marked
``cuda``), a tiny traced DFG cell whose applies are all replayed."""

import json
import time

import pytest
import torch

from perfbench.harness import Bench, run_cell
from conftest import ROOT

BENCH = Bench(ROOT)
CELL = "dfg2d2-picard"
MS = 1_000_000  # ns
SEED = 2 ** 31 + 3041


def read(name, rec):
    return BENCH.reader(name).read(rec)


def _rec(replayed):
    """A 40 ms window with four fgmres iterations of 10 ms, each applying
    the rows over [s + 6, s + 8] ms; apply ``i`` holds a graph span where
    ``replayed[i]``.  The device is busy over [s + 6.5, s + 7] ms of each
    iteration and over [2, 4] ms."""
    host = [("navierstokes.step", 0, 40 * MS, 1)]
    device = [("void elementwise", 2 * MS, 4 * MS, 7)]
    for i, graph in enumerate(replayed):
        s = 10 * i * MS
        host.append(("linsolve.fgmres_iter", s, s + 10 * MS, 1))
        host.append(("stokes.precond", s + MS, s + 5 * MS, 1))
        host.append(("navierstokes.picard_rows", s + 6 * MS, s + 8 * MS, 1))
        if graph:
            host.append(("navierstokes.picard_rows_graph", s + 6 * MS,
                         s + 7 * MS, 1))
        host.append(("linsolve.fgmres_host", s + 8 * MS, s + 9 * MS, 1))
        device.append(("void kernel", s + 6 * MS + MS // 2, s + 7 * MS, 7))
    return dict(trace=dict(span=(0, 40 * MS), host=host, device=device,
                           steps=1))


@pytest.mark.parametrize("replayed,share", [
    ((True,) * 4, 100.0),
    ((True, True, False, True), 75.0),
    ((False, False, True, False), 25.0),
], ids=["all", "mix3of4", "mix1of4"])
def test_share_of_applies_replayed(replayed, share):
    assert read("rows_graph_share", _rec(replayed)) == pytest.approx(share)


def test_none_replayed_reads_nothing():
    """Applies but no graph span: what an eager program (or one from before
    the graph) leaves, so nothing is read."""
    assert read("rows_graph_share", _rec((False,) * 4)) is None


def test_a_graph_span_outside_every_apply_is_not_counted():
    rec = _rec((False, True, False, False))
    rec["trace"]["host"].append(
        ("navierstokes.picard_rows_graph", 38 * MS, 39 * MS, 1))
    assert read("rows_graph_share", rec) == pytest.approx(25.0)


def test_idle_inside_the_applies():
    """Each 2 ms apply holds 0.5 ms of device work: 4 × 1.5 ms idle over a
    40 ms window, whether the applies replay or not."""
    for replayed in ((True,) * 4, (False,) * 4):
        assert read("idle_rows_pct", _rec(replayed)) == pytest.approx(15.0)


def test_an_apply_cut_by_the_window_counts_its_inside():
    rec = _rec((True,) * 4)
    rec["trace"]["span"] = (0, 37 * MS)
    # the last apply, [36, 38] ms, keeps [36, 36.5] idle and [36.5, 37] busy
    assert read("idle_rows_pct", rec) == pytest.approx(
        100.0 * 5.0 / 37.0)


@pytest.mark.parametrize("name", ["rows_graph_share", "idle_rows_pct"])
def test_nothing_to_read(name):
    assert read(name, dict(trace=None)) is None
    no_applies = _rec((True,) * 4)
    no_applies["trace"]["host"] = [
        ev for ev in no_applies["trace"]["host"]
        if ev[0] != "navierstokes.picard_rows"]
    assert read(name, no_applies) is None


@pytest.mark.cuda
def test_a_traced_tiny_cell_replays_every_apply(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    path = tiny_root / "perfbench" / "configs" / "dfg2d2_cylinder_f64.json"
    config = json.loads(path.read_text())
    config.update(grid=[44, 16], cells=44)
    path.write_text(json.dumps(config))
    # the check's limits are the full grid's: a 44 × 16 channel's state is
    # further from the reference's (``test_perfbench_dfg``), so only the
    # run's intervals are held here
    result, _ = run_cell(Bench(tiny_root), CELL, SEED, 0.01, True,
                         torch.device("cuda", 0), time.perf_counter())
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["metrics"]["rows_graph_share"]["value"] == 100.0
    assert 0.0 <= result["metrics"]["idle_rows_pct"]["value"] < 100.0
