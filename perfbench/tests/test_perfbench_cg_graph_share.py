"""The reader of ``cg_graph_share`` on synthetic traces (every chunk
replayed, none, a mix, no trace), and, on a card (marked ``cuda``), a tiny
traced cell whose chunks are all replayed."""

import time

import pytest
import torch

from perfbench.harness import Bench, run_cell
from conftest import ROOT

BENCH = Bench(ROOT)
MS = 1_000_000  # ns
SEED = 2 ** 31 + 1913


def read(name, rec):
    return BENCH.reader(name).read(rec)


def _rec(replayed):
    """A 40 ms window with four chunks of 5 ms, each followed by its flag
    read; chunk ``i`` holds a graph span where ``replayed[i]``."""
    host = [("heat_fast.step", 0, 40 * MS, 1)]
    for i, graph in enumerate(replayed):
        s = (1 + 10 * i) * MS
        host.append(("heat_fast.cg_chunk", s, s + 5 * MS, 1))
        if graph:
            host.append(("heat_fast.cg_graph", s + MS // 10, s + 4 * MS, 1))
        host.append(("heat_fast.cg_flag", s + 5 * MS, s + 6 * MS, 1))
    device = [("void stencil5_kernel", 2 * MS, 3 * MS, 7)]
    return dict(trace=dict(span=(0, 40 * MS), host=host, device=device,
                           steps=1))


@pytest.mark.parametrize("replayed,share", [
    ((True,) * 4, 100.0),
    ((True, False, True, True), 75.0),
    ((False, True, False, False), 25.0),
], ids=["all", "mix3of4", "mix1of4"])
def test_share_of_chunks_replayed(replayed, share):
    rec = _rec(replayed)
    assert read("cg_graph_share", rec) == pytest.approx(share)
    assert read("cg_graph_share.3d", rec) == read("cg_graph_share", rec)


def test_none_replayed_reads_nothing():
    """Chunks but no graph span: what a program without the graphs (an
    eager run, or one from before them) leaves, so nothing is read."""
    assert read("cg_graph_share", _rec((False,) * 4)) is None


def test_a_graph_span_outside_every_chunk_is_not_counted():
    rec = _rec((True, False, False, False))
    rec["trace"]["host"].append(("heat_fast.cg_graph", 37 * MS, 38 * MS, 1))
    assert read("cg_graph_share", rec) == pytest.approx(25.0)


@pytest.mark.parametrize("name", ["cg_graph_share", "cg_graph_share.3d"])
def test_nothing_to_read(name):
    assert read(name, dict(trace=None)) is None
    no_chunks = _rec((True,) * 4)
    no_chunks["trace"]["host"] = [ev for ev in no_chunks["trace"]["host"]
                                  if ev[0] != "heat_fast.cg_chunk"]
    assert read(name, no_chunks) is None


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["heat2d-stiff-f64", "heat3d-easy-f64"])
def test_a_traced_cell_replays_every_chunk(tiny_root, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, check = run_cell(Bench(tiny_root), cell, SEED, 0.01, True,
                             torch.device("cuda", 0), time.perf_counter())
    assert result["correct"], check
    name = "cg_graph_share" + (".3d" if cell.startswith("heat3d") else "")
    assert result["metrics"][name]["value"] == 100.0
