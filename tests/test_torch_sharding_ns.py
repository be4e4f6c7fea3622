"""The port's decomposed flow paths (``penguin_tpu_torch.parallel``: the
CN/AB2 pgmres dryrun and the implicit-Picard fgmres dryrun with the DCT-CG
block-Schur M) on the CPU, at the JAX dryruns' grid (48 × 24, f64), in a
4-rank (2 × 2) and a 3-rank (1 × 3) gloo world started once per module:

- sharded against the port's whole run under the JAX dryruns' own gates
  (NS: 1e-6 of scale with equal pgmres counts on every rank; Picard: M on
  the key state to 1e-9 of scale, a finite state with relres < 1e-6);
- the rank-aware M (Chebyshev and DCT-CG Schur solves) against the whole
  M, the distributed DCT pair against the whole one;
- the windowed convection, Picard and unsteady applies at the halo that
  the impulse comb finds;
- the ledger: no grid-sized message, the DCT's messages one block each;
- the port's dryrun states against the JAX dryruns' own on 4 virtual
  devices.

Every world message is a host round trip of about a millisecond on a
CPU host, and a pgmres iteration is some 60 of them, so the worlds run
one or two steps of each dryrun (the JAX defaults are 3 and 2; the
``dryrun_*`` entry points keep them)."""

import numpy as np
import pytest
import torch

from penguin_tpu.parallel import sharding as jsh
from penguin_tpu_torch.parallel import sharding as tsh
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

GRID = (48, 24)
# NS steps by rank count: the 1 × 3 world's second step is the first with
# AB2 convection (the convection of the step before carried on the blocks)
NS_STEPS = {4: 1, 3: 2}
DT = 0.01


@pytest.fixture(scope="module")
def worlds():
    """The worlds started so far, by rank count."""
    return {}


def _world(worlds, n_ranks):
    if n_ranks not in worlds:
        worlds[n_ranks] = tsh._dryruns(
            n_ranks, "cpu", timeout_s=600, flow_parts=dict(grid=GRID),
            ns=dict(grid=GRID, steps=NS_STEPS[n_ranks]),
            picard=dict(grid=GRID, steps=1))
    return worlds[n_ranks]


@pytest.fixture(scope="module", params=[4, 3], ids=["2x2", "1x3"])
def world(request, worlds):
    return request.param, _world(worlds, request.param)


def _scale(fields):
    return max(max(float(np.abs(f).max()) for f in fields), 1.0)


def _err(got, want):
    return max(float(np.abs(g - w).max()) for g, w in zip(got, want))


def test_ns_sharded_equals_whole(world):
    """The JAX dryrun's gate: the decomposed end state equals the whole
    run's to 1e-6 of its scale; every rank took the same pgmres counts (a
    gate of ``_dryruns``), and the whole run's."""
    n_ranks, out = world
    run = out["ns"]
    whole = run["whole"]
    bound = 1e-6 * _scale(whole["x"])
    assert len(run["ranks"]) == n_ranks
    assert _err(run["x"], whole["x"]) < bound
    for rep in run["ranks"]:
        assert rep["err"] < bound
        assert rep["iters"] == whole["iters"]
        assert len(rep["iters"]) == NS_STEPS[n_ranks]


def test_picard_preconditioner_and_scan(world):
    """The JAX dryrun's two gates: M with the DCT-CG Schur solve on the key
    state to 1e-9 of scale, and the fgmres scan's state finite with every
    relres under 1e-6; no grid-sized message (JAX allows its DCT 4)."""
    _, out = world
    run = out["picard"]
    for rep in run["ranks"]:
        assert rep["err_M"] < 1e-9 * max(rep["scale_M"], 1.0)
        assert max(rep["relres"]) < 1e-6
        assert rep["grid_messages"] == 0
        assert rep["iters"] == run["ranks"][0]["iters"]
    assert all(np.isfinite(a).all() for a in run["x"])


def _spread(n_ranks, schur, eps=1e-16, seeds=(1, 2)):
    """How far the whole M moves on the key state perturbed by ``eps``
    (relative, normal noise): its own round-off spread."""
    solver = tsh._flow_setup(tsh.make_grid_mesh(n_ranks), GRID, "cpu")
    key = tsh._flow_key(tuple(solver.fluid.capacity_p.V.shape), "cpu")
    M = solver.make_block_preconditioner(dt=DT, theta=0.5, schur=schur,
                                         schur_cg_iters=8)
    y = M(key)
    out = 0.0
    for seed in seeds:
        g = torch.Generator().manual_seed(seed)
        yp = M(tuple(k * (1 + eps * torch.randn(k.shape, generator=g,
                                                dtype=k.dtype))
                     for k in key))
        out = max(out, max(float((a - b).abs().max())
                           for a, b in zip(y, yp)))
    return out


@pytest.mark.parametrize("schur", ["cheb", "dct_cg"])
def test_rank_aware_preconditioner_matches_whole(world, schur):
    """M of each rank (its sums over the ranks, global indices in the
    power iteration's start vector and the DCT's modes, a renewed halo
    before each stencil) against the whole M on the key state: 1e-12 of
    scale.  The DCT-CG M's eight inner CG steps on the rim slivers'
    Schur complement carry round-off further: there the bound is the whole
    M's own spread under a 1e-16 perturbation of its input, measured here
    (2.6e-11 of scale on the 2 × 2 padded mesh, 6.1e-10 on the 1 × 3 one;
    the sharded M reads 4.4e-12 on 2 × 2), which the JAX dryrun's 1e-9
    also covers."""
    n_ranks, out = world
    run = out["flow_parts"]
    got, want = run["out"][schur], run["whole"][schur]
    scale = _scale(want)
    bound = 1e-12 * scale if schur == "cheb" else max(
        1e-12 * scale, _spread(n_ranks, schur))
    assert _err(got, want) <= bound
    assert _err(got, want) < 1e-9 * scale


def test_distributed_dct_matches_whole(world):
    """The DCT-II/III pair reduce-scattered along the rank grid, one block
    a message, against the whole grid's matmuls."""
    n_ranks, out = world
    run = out["flow_parts"]
    for name in ("dct", "idct"):
        want = run["whole"][name]
        got = run["out"][name]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
    axes = tsh._factor2(n_ranks)
    block = np.prod([s // a for s, a in zip(out["ns"]["x"][0].shape, axes)])
    for rep in run["ranks"]:
        dct = rep["ledger"]["dct"]
        # two transforms, each along both axes: one message to each other
        # rank on the axis, of at most one block
        assert dct["calls"] == 4
        assert dct["messages"] == 2 * sum(a - 1 for a in axes)
        assert 0 < rep["largest"] <= block


@pytest.mark.parametrize("name", ["ns", "picard"])
def test_no_grid_sized_message(world, name):
    """The port's form of the JAX HLO gate: every message of the decomposed
    scan is smaller than the grid; the Picard scan's DCT messages are
    there, each one block."""
    n_ranks, out = world
    run = out[name]
    cells = int(np.prod(run["x"][0].shape))
    for rep in run["ranks"]:
        assert 0 < rep["largest"] < cells
        assert rep["grid_messages"] == 0
        kinds = set(rep["ledger"])
        assert kinds == ({"halo", "all_reduce", "dct"} if name == "picard"
                         else {"halo", "all_reduce"})


# ---------------------------------------------------------------------------
# windowed operators (one process: the window of a whole field is what the
# halo exchange delivers)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def channel():
    solver = tsh._flow_setup(tsh.make_grid_mesh(4), GRID, "cpu")
    shape = tuple(solver.fluid.capacity_p.V.shape)
    key = tsh._flow_key(shape, "cpu")
    return solver, key, tsh._halo_width(solver._picard_rows(key, DT, 0.5),
                                        key)


@pytest.mark.parametrize("op", ["conv_vectors", "picard_rows", "apply",
                                "rhs"])
def test_windowed_flow_operators_are_exact_at_the_halo(channel, op):
    """Every rank's windowed view, on its window of the key state, gives
    the whole operator on its block to 1e-12 of scale: the nonlinear
    convection as well as the linear Picard rows the halo was found on."""
    from penguin_tpu_torch.solvers.navierstokes import NavierStokesMono
    solver, key, R = channel
    shape = tuple(key[0].shape)
    ops = {"conv_vectors": lambda s: s.conv_vectors,
           "picard_rows": lambda s: (lambda x: s._picard_rows(x, DT, 0.5)(
               x)),
           "apply": lambda s: s.make_unsteady_apply(DT, 0.5),
           "rhs": lambda s: (lambda x: s.make_unsteady_rhs(DT, 0.5)(
               x, 0.0, DT))}
    whole = ops[op](solver)(key)
    scale = _scale([w.numpy() for w in whole])
    for rank in range(4):
        s = tsh.grid_sharding(tsh.GridMesh(list(range(4)), rank))
        window = s.window(shape, R)
        view = tsh.windowed_stokes(solver, window)
        assert isinstance(view, NavierStokesMono)
        out = ops[op](view)(tuple(f[window] for f in key))
        for o, w in zip(out, whole):
            got = tsh._crop(o, s, R, shape)
            assert float((got - w[s.block(shape)]).abs().max()) \
                <= 1e-12 * scale


# ---------------------------------------------------------------------------
# against the JAX dryruns' own states on 4 virtual devices (2 × 2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_states():
    ns = jsh.dryrun_ns_multichip(4, GRID, n_steps=NS_STEPS[4],
                                 check_hlo=False)
    picard, _ = jsh.dryrun_ns_picard_multichip(4, GRID, n_steps=1,
                                               check_hlo=False)
    return {"ns": [np.asarray(a) for a in ns],
            "picard": [np.asarray(a) for a in picard]}


@pytest.fixture(scope="module")
def world_2x2(worlds):
    return _world(worlds, 4)


@pytest.mark.parametrize("name", ["ns", "picard"])
def test_dryrun_matches_jax(world_2x2, jax_states, name):
    """The Krylov paths' form of parity: the port's decomposed step solved
    its own system (Picard: fgmres to relres <= 1e-8 in the true residual;
    NS: pgmres to its iteration cap, as JAX's whole and sharded runs do)
    and lands within 1e-6 of JAX's sharded state."""
    run = world_2x2[name]
    want = jax_states[name]
    for rep in run["ranks"]:
        if name == "picard":
            assert max(rep["relres"]) <= 1e-8
    assert _err(run["x"], want) <= 1e-6 * _scale(want)
