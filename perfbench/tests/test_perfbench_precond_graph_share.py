"""The reader of ``precond_graph_share`` on synthetic traces (every apply of
M replayed, some, none, no trace), and, on a card (marked ``cuda``), a tiny
traced DFG cell whose applies are all replayed."""

import json
import time

import pytest
import torch

from perfbench.harness import Bench, run_cell
from conftest import ROOT

BENCH = Bench(ROOT)
CELL = "dfg2d2-picard"
NAME = "precond_graph_share"
MS = 1_000_000  # ns
SEED = 2 ** 31 + 2029


def read(rec):
    return BENCH.reader(NAME).read(rec)


def _rec(replayed):
    """A 40 ms window with four fgmres iterations of 10 ms, each applying M
    over 5 ms; apply ``i`` holds a graph span where ``replayed[i]``."""
    host = [("navierstokes.step", 0, 40 * MS, 1)]
    for i, graph in enumerate(replayed):
        s = 10 * i * MS
        host.append(("linsolve.fgmres_iter", s, s + 10 * MS, 1))
        host.append(("stokes.precond", s + MS, s + 6 * MS, 1))
        if graph:
            host.append(("stokes.precond_graph", s + 2 * MS, s + 3 * MS, 1))
        host.append(("linsolve.fgmres_host", s + 8 * MS, s + 9 * MS, 1))
    device = [("void elementwise", 2 * MS, 4 * MS, 7)]
    return dict(trace=dict(span=(0, 40 * MS), host=host, device=device,
                           steps=1))


@pytest.mark.parametrize("replayed,share", [
    ((True,) * 4, 100.0),
    ((True, True, False, True), 75.0),
    ((False, False, True, False), 25.0),
], ids=["all", "mix3of4", "mix1of4"])
def test_share_of_applies_replayed(replayed, share):
    assert read(_rec(replayed)) == pytest.approx(share)


def test_none_replayed_reads_nothing():
    """Applies but no graph span: what an eager program (or one from before
    the graph) leaves, so nothing is read."""
    assert read(_rec((False,) * 4)) is None


def test_a_graph_span_outside_every_apply_is_not_counted():
    rec = _rec((False, True, False, False))
    rec["trace"]["host"].append(("stokes.precond_graph", 37 * MS, 38 * MS, 1))
    assert read(rec) == pytest.approx(25.0)


def test_nothing_to_read():
    assert read(dict(trace=None)) is None
    no_applies = _rec((True,) * 4)
    no_applies["trace"]["host"] = [ev for ev in no_applies["trace"]["host"]
                                   if ev[0] != "stokes.precond"]
    assert read(no_applies) is None


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
    assert result["metrics"][NAME]["value"] == 100.0
