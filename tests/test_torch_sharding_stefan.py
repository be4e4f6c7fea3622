"""The port's decomposed Stefan front-tracking step
(``penguin_tpu_torch.parallel.sharding``'s Stefan dryrun) on the CPU, at
the JAX dryrun's size (32², 32 markers, f64, two marker steps), in a
4-rank (2 × 2) and a 3-rank (1 × 3) gloo world started once per module:

- sharded against the port's whole ``StefanMono2D.solve`` under the JAX
  dryrun's bounds (T 1e-6, markers 1e-8), with the same GN and BiCGStab
  counts, and the replicated markers bit-equal on every rank;
- the ledger: no grid-sized message but the normal equations, each of
  nm(nm+1)+1 elements, one a GN iteration;
- the port's dryrun against the JAX dryrun's own state on 4 virtual
  devices."""

import numpy as np
import pytest

from penguin_tpu.parallel import sharding as jsh
from penguin_tpu_torch.parallel import sharding as tsh
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

GRID = (32, 32)
NM = 32


@pytest.fixture(scope="module")
def worlds():
    """The worlds started so far, by rank count."""
    return {}


def _world(worlds, n_ranks):
    if n_ranks not in worlds:
        worlds[n_ranks] = tsh._dryruns(n_ranks, "cpu", timeout_s=600,
                                       stefan=dict(grid=GRID, nm=NM))
    return worlds[n_ranks]


@pytest.fixture(scope="module", params=[4, 3], ids=["2x2", "1x3"])
def world(request, worlds):
    return request.param, _world(worlds, request.param)


def test_stefan_sharded_equals_whole(world):
    n_ranks, out = world
    run = out["stefan"]
    whole = run["whole"]
    assert len(run["ranks"]) == n_ranks
    for got, want in zip(run["T"], whole["T"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-6
    for rep in run["ranks"]:
        assert rep["err_T"] < 1e-6
        assert rep["err_mk"] < 1e-8
        assert np.abs(rep["markers"] - whole["markers"]).max() < 1e-8
        assert rep["gn_iters"] == whole["gn_iters"]
        assert rep["krylov_iters"] == whole["krylov_iters"]
        assert len(rep["gn_iters"]) == 2        # K + 1 marker steps


def test_markers_bit_equal_on_every_rank(world):
    """Each rank takes its LM step from the same summed normal equations:
    the replicated markers agree to the bit."""
    _, out = world
    ranks = out["stefan"]["ranks"]
    for rep in ranks[1:]:
        np.testing.assert_array_equal(rep["markers"], ranks[0]["markers"])


def test_stefan_ledger(world):
    """No message reaches the grid's cell count but the normal equations
    (JᵀJ, JᵀF and ‖F‖²: nm(nm+1)+1 elements, one reduction a GN iteration),
    which have a kind of their own: at JAX's size they would pass an
    unnamed grid gate by luck (32² = 1024 against 34² cells)."""
    _, out = world
    run = out["stefan"]
    cells = int(np.prod(run["T"][0].shape))
    for rep in run["ranks"]:
        led = rep["ledger"]
        assert set(led) == {"halo", "all_reduce", "normal_equations"}
        ne = led["normal_equations"]
        assert ne["calls"] == ne["messages"] == sum(rep["gn_iters"])
        assert ne["elements"] == ne["messages"] * (NM * (NM + 1) + 1)
        assert rep["grid_messages"] == 0
        assert rep["largest"] == NM * (NM + 1) + 1 < cells


@pytest.fixture(scope="module")
def jax_state():
    T, mk = jsh.dryrun_stefan_multichip(4, GRID, NM, check_hlo=False)
    return [np.asarray(a) for a in T], np.asarray(mk)


def test_stefan_dryrun_matches_jax(worlds, jax_state):
    """The port's decomposed step against the JAX dryrun's sharded one, on
    the same 2 × 2 padded mesh, under the JAX dryrun's own bounds."""
    run = _world(worlds, 4)["stefan"]
    T, mk = jax_state
    for got, want in zip(run["T"], T):
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-6
    assert np.abs(run["ranks"][0]["markers"] - mk).max() < 1e-8
