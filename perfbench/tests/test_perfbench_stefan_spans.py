"""The six readers of the marker Stefan solver's spans on a synthetic trace
whose overlaps are computed by hand, and ``None`` from a program without
the spans or without a trace."""

import pytest

from perfbench.harness import Bench
from conftest import ROOT

BENCH = Bench(ROOT)
MS = 1_000_000  # ns
NEW = ["gn_iters_per_step", "gn_iter_ms", "idle_slab_build_pct",
       "idle_slab_solve_pct", "idle_update_pct", "idle_gn_host_pct"]


def read(name, rec):
    return BENCH.reader(name).read(rec)


def _rec():
    """A 20 ms window over 1 step of 2 GN iterations; the device is busy
    over [2, 4], [9, 10] and [13, 16] ms."""
    device = [("void quadrature", 2 * MS, 4 * MS, 7),
              ("Memcpy HtoD (Pageable -> Device)", 9 * MS, 10 * MS, 7),
              ("void cg", 13 * MS, 16 * MS, 7)]
    host = [
        ("stefan.step", 0.5 * MS, 19 * MS, 1),
        # iteration 1, [1, 9]: build [1, 5] (busy [2, 4]: 2 ms idle), solve
        # [5, 7] (2 idle), update [7, 8] (1 idle), host reads [8, 9] (1)
        ("stefan.gn_iter", 1 * MS, 9 * MS, 1),
        ("stefan.slab_build", 1 * MS, 5 * MS, 1),
        ("stefan.slab_solve", 5 * MS, 7 * MS, 1),
        ("stefan.update", 7 * MS, 8 * MS, 1),
        ("stefan.gn_host", 8 * MS, 9 * MS, 1),
        # iteration 2, [9, 19]: build [9, 12] (busy [9, 10]: 2 idle), solve
        # [12, 17] (busy [13, 16]: 2 idle), update [17, 18] (1), host
        # reads [18, 19] (1)
        ("stefan.gn_iter", 9 * MS, 19 * MS, 1),
        ("stefan.slab_build", 9 * MS, 12 * MS, 1),
        ("stefan.slab_solve", 12 * MS, 17 * MS, 1),
        ("stefan.update", 17 * MS, 18 * MS, 1),
        ("stefan.gn_host", 18 * MS, 19 * MS, 1),
        # names that only resemble a span's are not read
        ("stefan.gn_iters", 0, 20 * MS, 1),
        ("aten::stefan.update", 0, 20 * MS, 1),
    ]
    return dict(trace=dict(span=(0, 20 * MS), host=host, device=device,
                           steps=1))


def test_readers_on_hand_computed_overlaps():
    rec = _rec()
    assert read("gn_iters_per_step", rec) == pytest.approx(2.0)
    assert read("gn_iter_ms", rec) == pytest.approx((8.0 + 10.0) / 2)
    assert read("idle_slab_build_pct", rec) == pytest.approx(100 * 4 / 20)
    assert read("idle_slab_solve_pct", rec) == pytest.approx(100 * 4 / 20)
    assert read("idle_update_pct", rec) == pytest.approx(100 * 2 / 20)
    assert read("idle_gn_host_pct", rec) == pytest.approx(100 * 2 / 20)
    parts = sum(read(name, rec) for name in NEW[2:])
    assert parts <= read("device_idle_pct", rec) + 1e-9


def test_readers_find_nothing_in_a_program_without_the_spans():
    rec = _rec()
    rec["trace"]["host"] = [ev for ev in rec["trace"]["host"]
                            if not ev[0].startswith("stefan.")]
    for name in NEW:
        assert read(name, rec) is None
    assert all(read(name, dict(trace=None)) is None for name in NEW)


def test_the_readers_are_the_cells():
    spec = {m["name"]: m for m in BENCH.spec["per_layer"]}
    for name in NEW:
        m = spec[name]
        assert m["layer"] == "solvers.stefan2d" and m["moves"] == "step_ms"
        assert m["workloads"] == ["frank-disk-256"]
        assert m["source"] == "program_span"
