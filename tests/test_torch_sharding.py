"""The port's domain decomposition (``penguin_tpu_torch.parallel``) on the
CPU: the rank grid and the padded mesh against the JAX package's, the halo
exchange against the whole grid's windows, each dryrun sharded against
whole in a 4-rank (2 × 2) and a 3-rank (1 × 3) gloo world, and against the
unsharded computation that the JAX dryrun holds itself to.  Each world is
started once per module; its ranks run one thread each."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu.parallel import sharding as jsh
import penguin_tpu_torch as tpt
from penguin_tpu_torch.parallel import sharding as tsh
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

# the JAX dryruns' own bounds, sharded against whole
BOUNDS = {"heat": 1e-5, "stokes": 1e-5, "moving": 1e-8}
GRIDS = {"heat": (31, 31), "stokes": (31, 31), "moving": (30, 30)}
HALO_SHAPE = (8, 12)


@pytest.fixture(scope="module")
def worlds():
    """The worlds started so far, by rank count."""
    return {}


def _world(worlds, n_ranks):
    if n_ranks not in worlds:
        worlds[n_ranks] = tsh._dryruns(
            n_ranks, "cpu", halo=dict(shape=HALO_SHAPE, widths=(1, 2)),
            **{k: dict(grid=g) for k, g in GRIDS.items()})
    return worlds[n_ranks]


@pytest.fixture(scope="module", params=[4, 3], ids=["2x2", "1x3"])
def world(request, worlds):
    return request.param, _world(worlds, request.param)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_grid_mesh_matches_jax(n):
    mesh = tsh.make_grid_mesh(n)
    assert mesh.devices.shape == jsh.make_grid_mesh(n).devices.shape
    assert mesh.axis_names == ("x", "y")
    assert mesh.coords == (0, 0)


@pytest.mark.parametrize("n_ranks", [4, 3, 8])
@pytest.mark.parametrize("n", [30, 31, 63])
def test_padded_mesh_matches_jax(n, n_ranks):
    t = tsh.padded_mesh(tsh.make_grid_mesh(n_ranks), (n, n), (4.0, 4.0))
    j = jsh.padded_mesh(jsh.make_grid_mesh(n_ranks), (n, n), (4.0, 4.0))
    assert t.pad == j.pad and t.np_shape == j.np_shape
    assert all(s % a == 0 for s, a in zip(t.np_shape,
                                          tsh._factor2(n_ranks)))


def test_shard_pytree_takes_each_ranks_block():
    """Every leaf of rank >= 2 is cut to the rank's block (trailing axes
    whole), lower-rank leaves stay whole, containers keep their kind; a
    grid that does not divide is refused."""
    g = torch.Generator().manual_seed(0)
    tree = {"T": torch.randn(8, 12, generator=g, dtype=torch.float64),
            "C": (torch.randn(8, 12, 2, generator=g, dtype=torch.float64),
                  torch.randn(5, generator=g, dtype=torch.float64))}
    seen = np.zeros((8, 12), bool)
    for rank in range(4):
        s = tsh.grid_sharding(tsh.GridMesh(list(range(4)), rank))
        out = tsh.shard_pytree(tree, s)
        i0, i1 = s.block((8, 12))
        assert (i0.stop - i0.start, i1.stop - i1.start) == (4, 6)
        assert torch.equal(out["T"], tree["T"][i0, i1])
        assert isinstance(out["C"], tuple)
        assert torch.equal(out["C"][0], tree["C"][0][i0, i1])
        assert out["C"][1] is tree["C"][1]
        seen[i0, i1] = True
    assert seen.all()
    with pytest.raises(ValueError, match="padded_mesh"):
        tsh.shard_pytree(torch.zeros(7, 12), s)


def test_a_failing_rank_raises_in_the_caller():
    """No rank is left behind: an exception on the ranks (here a halo wider
    than the blocks) raises in the caller, with the rank's traceback."""
    with pytest.raises(RuntimeError, match="(?s)rank [0-2] failed.*halo width"):
        tsh._dryruns(3, "cpu", halo=dict(shape=(6, 6), widths=(5,)),
                     timeout_s=60)


def test_backend_follows_the_device():
    from penguin_tpu_torch.parallel import _comm
    assert _comm.backend_for(torch.device("cpu"), 4) == "gloo"
    with pytest.raises(ValueError, match="no transport"):
        _comm.backend_for(torch.device("meta"), 2)


def _padded_heat(pkg, pad, zeros):
    from penguin_tpu.solvers.heat_fast import FastHeatBE as JaxFastHeatBE
    from penguin_tpu_torch.solvers import FastHeatBE
    mesh = pkg.Mesh((30, 30), (4.0, 4.0), (0.0, 0.0), pad=pad)
    kw = {} if pkg is jpt else dict(device="cpu")
    cap = pkg.compute_capacity(pkg.geometry.circle((2.0, 2.0), 1.0), mesh,
                               p=4, s=1, **kw)
    bc_b = pkg.BorderConditions({k: pkg.Dirichlet(0.0) for k in
                                 ("left", "right", "top", "bottom")})
    fast = (JaxFastHeatBE if pkg is jpt else FastHeatBE)(
        cap, pkg.make_diffusion_ops(cap), 1.0, lambda x, y, z, t: 0.0,
        pkg.Dirichlet(1.0), bc_b, 0.01, cg_tol=1e-10, cg_maxiter=200)
    return np.asarray(fast.run(zeros(mesh.np_shape), 5))[:30, :30]


def test_padded_mesh_physics_unchanged():
    """The JAX suite's check in the port: extra inert padding leaves the
    heat solution on the real cells as it is, and it is JAX's."""
    zeros = lambda shape: torch.zeros(shape, dtype=torch.float64)
    T1 = _padded_heat(tpt, (1, 1), zeros)
    T2 = _padded_heat(tpt, (3, 2), zeros)
    assert np.abs(T1 - T2).max() < 1e-10
    TJ = _padded_heat(jpt, (3, 2), jnp.zeros)
    assert np.abs(T2 - TJ).max() < 1e-10


def test_halo_exchange_gives_the_whole_grids_window(world):
    n_ranks, out = world
    whole = out["halo"]["whole"]["grid"]
    grown_whole = {w: np.pad(whole, w) for w in (1, 2)}
    for rep in out["halo"]["ranks"]:
        (i0, i1) = rep["index"]
        for w, grown, ledger in zip((1, 2), rep["grown"], rep["ledgers"]):
            # corners included, zeros past the grid's edge
            want = grown_whole[w][i0.start:i0.stop + 2 * w,
                                  i1.start:i1.stop + 2 * w]
            np.testing.assert_array_equal(grown, want)
            bx, by = i0.stop - i0.start, i1.stop - i1.start
            mesh = tsh.GridMesh(list(range(n_ranks)),
                                int(np.ravel_multi_index(
                                    rep["coords"], tsh._factor2(n_ranks))))
            n0 = sum(mesh.neighbour(0, s) is not None for s in (-1, 1))
            n1 = sum(mesh.neighbour(1, s) is not None for s in (-1, 1))
            assert ledger["halo"]["calls"] == 1
            assert ledger["halo"]["messages"] == n0 + n1
            assert ledger["halo"]["elements"] == w * (n0 * by
                                                      + n1 * (bx + 2 * w))
            assert ledger["halo"]["bytes"] == 8 * ledger["halo"]["elements"]


@pytest.mark.parametrize("name", ["heat", "stokes", "moving"])
def test_dryrun_sharded_equals_whole(world, name):
    n_ranks, out = world
    run = out[name]
    whole = run["whole"]
    if name == "heat":
        pairs = [(run["T"], whole["states"][0])]
        for rep in run["ranks"]:
            assert rep["counts"] == whole["counts"]
    elif name == "stokes":
        pairs = list(zip(run["out"], whole["out"]))
    else:
        pairs = list(zip(run["x"], whole["x"]))
    assert len(run["ranks"]) == n_ranks
    for got, want in pairs:
        assert got.shape == want.shape
        assert np.abs(got - want).max() < BOUNDS[name]
    cells = int(np.prod(pairs[0][1].shape))
    for rep in run["ranks"]:
        assert rep["err"] < BOUNDS[name]
        # no grid-sized message: the port's form of the JAX HLO gate
        assert 0 < rep["largest"] < cells


# ---------------------------------------------------------------------------
# against JAX's unsharded computations, on the 2 × 2 world's padded meshes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_heat():
    from penguin_tpu.solvers.heat_fast import FastHeatBE
    mesh = jsh.padded_mesh(jsh.make_grid_mesh(4), GRIDS["heat"], (4.0, 4.0),
                           (0.0, 0.0))
    cap = jpt.compute_capacity(jpt.geometry.circle((2.0, 2.0), 1.0), mesh,
                               p=4, s=1, dtype=jnp.float32)
    bc_b = jpt.BorderConditions({k: jpt.Dirichlet(0.0) for k in
                                 ("left", "right", "top", "bottom")})
    fast = FastHeatBE(cap, jpt.make_diffusion_ops(cap), 1.0,
                      lambda x, y, z, t: 0.0, jpt.Dirichlet(1.0), bc_b,
                      0.25 * (4.0 / GRIDS["heat"][0]) ** 2, cg_tol=1e-5,
                      cg_maxiter=16, dtype=jnp.float32)
    T1, _ = fast.step(jnp.zeros(mesh.np_shape, jnp.float32))
    return np.asarray(T1)


@pytest.fixture(scope="module")
def jax_stokes():
    from penguin_tpu.solvers.stokes import PinPressureGauge, StokesMono
    nx, ny = GRIDS["stokes"]
    dev = jsh.make_grid_mesh(4)
    d = 1.0 / nx
    meshes = [jsh.padded_mesh(dev, (nx, ny), (1.0, 1.0), x0)
              for x0 in ((-0.5 * d, 0.0), (0.0, -0.5 * d), (0.0, 0.0))]
    caps = [jpt.compute_capacity(jpt.geometry.full_domain(2), m, p=4, s=1,
                                 dtype=jnp.float32) for m in meshes]
    fluid = jpt.Fluid(
        mesh_u=(meshes[0], meshes[1]), mesh_p=meshes[2],
        capacity_u=(caps[0], caps[1]),
        operator_u=(jpt.make_diffusion_ops(caps[0]),
                    jpt.make_diffusion_ops(caps[1])),
        capacity_p=caps[2], operator_p=jpt.make_diffusion_ops(caps[2]),
        mu=1.0, rho=1.0, f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0)
    noslip, lid = jpt.Dirichlet(0.0), jpt.Dirichlet(1.0)
    solver = StokesMono(
        fluid, (jpt.BorderConditions({"left": noslip, "right": noslip,
                                      "bottom": noslip, "top": lid}),
                jpt.BorderConditions({k: noslip for k in
                                      ("left", "right", "bottom", "top")})),
        PinPressureGauge(), jpt.Dirichlet(0.0))
    shape = meshes[2].np_shape
    fields = tuple(jnp.sin(jnp.arange(float(np.prod(shape))).reshape(shape)
                           * (0.01 * (i + 1))).astype(jnp.float32)
                   for i in range(5))
    return [np.asarray(o) for o in solver.apply_steady(fields)]


@pytest.fixture(scope="module")
def jax_moving():
    from penguin_tpu.solvers.moving_diffusion import solve_moving_mono_step
    mesh = jsh.padded_mesh(jsh.make_grid_mesh(4), GRIDS["moving"],
                           (4.0, 4.0), (0.0, 0.0))

    def body_st(x, y, t):
        return jnp.sqrt((x - (2.0 + 0.5 * t)) ** 2 + (y - 2.0) ** 2) - 1.0

    bc0 = jpt.Dirichlet(0.0)
    border = jpt.assembly.border_info(mesh, jpt.BorderConditions(
        {k: bc0 for k in ("left", "right", "top", "bottom")}))
    x0 = (jnp.zeros(mesh.np_shape), jnp.zeros(mesh.np_shape))
    cap = jpt.capacity.compute_capacity_spacetime(body_st, mesh, 0.0, 0.1,
                                                  p=4, s=1)
    x, _, _ = solve_moving_mono_step(cap, 1.0, lambda *a: 0.0,
                                     jpt.Dirichlet(1.0), border, x0, 0.0,
                                     0.1, "BE", tol=1e-10)
    return [np.asarray(v) for v in x]


@pytest.fixture(scope="module")
def world_2x2(worlds):
    return _world(worlds, 4)


# Tolerances against JAX.  Heat runs in f32 in both packages, but under the
# suite's x64 mode parts of a JAX "f32" run are f64 (ROADMAP, x64 quirks):
# two CG solves, each stopped at relres 1e-5 of a system of condition
# number about 2 (dt = h²/4), differ by up to 2·2·1e-5 of the O(1) field
# (measured 1.1e-5).  The Stokes apply (one pass of f32 arithmetic,
# measured 3.1e-7) and the moving step (f64 CG to relres 1e-10, measured
# 1.2e-15) are held to the JAX dryruns' own bounds.
JAX_TOL = {"heat": 4e-5, "stokes": 1e-5, "moving": 1e-8}


def test_heat_dryrun_matches_jax(world_2x2, jax_heat):
    got = world_2x2["heat"]["T"]
    assert got.shape == jax_heat.shape
    assert np.abs(got - jax_heat).max() < JAX_TOL["heat"]


def test_stokes_dryrun_matches_jax(world_2x2, jax_stokes):
    for got, want in zip(world_2x2["stokes"]["out"], jax_stokes):
        assert got.shape == want.shape
        assert np.abs(got - want).max() < JAX_TOL["stokes"]


def test_moving_dryrun_matches_jax(world_2x2, jax_moving):
    for got, want in zip(world_2x2["moving"]["x"], jax_moving):
        assert got.shape == want.shape
        assert np.abs(got - want).max() < JAX_TOL["moving"]


# ---------------------------------------------------------------------------
# windowed views (one process: the window of a whole field is what the
# halo exchange delivers)
# ---------------------------------------------------------------------------

def _windowed_errors(solver, fields, width, n_ranks=4):
    shape = tuple(fields[0].shape)
    whole = solver.apply_steady(fields)
    errs = []
    for rank in range(n_ranks):
        s = tsh.grid_sharding(tsh.GridMesh(list(range(n_ranks)), rank))
        window = s.window(shape, width)
        out = tsh.windowed_stokes(solver, window).apply_steady(
            tuple(f[window] for f in fields))
        errs.append(max(float((tsh._crop(o, s, width, shape)
                               - w[s.block(shape)]).abs().max())
                        for o, w in zip(out, whole)))
    return errs


def test_windowed_apply_is_exact_at_its_halo():
    """At the halo the impulse test finds, every rank's windowed apply is
    the whole apply; one cell less and some rank's is not, so the halo is
    not overstated."""
    solver, fields = tsh._stokes_setup(tsh.make_grid_mesh(4), (15, 15),
                                       "cpu")
    R = tsh._halo_width(solver.apply_steady, fields)
    assert R == 2
    assert max(_windowed_errors(solver, fields, R)) == 0.0
    assert max(_windowed_errors(solver, fields, R - 1)) > 1e-3


def test_windowed_view_refuses_ghost_cut_rows():
    from penguin_tpu_torch.solvers.stokes import PinPressureGauge, StokesMono
    n = 12
    d = 1.0 / n
    meshes = [tpt.Mesh((n, n), (1.0, 1.0), x0)
              for x0 in ((-0.5 * d, 0.0), (0.0, -0.5 * d), (0.0, 0.0))]
    body = tpt.geometry.circle((0.5, 0.5), 0.3)
    caps = [tpt.compute_capacity(body, m, p=4, s=1, device="cpu")
            for m in meshes]
    ops = [tpt.make_diffusion_ops(c) for c in caps]
    fluid = tpt.Fluid(mesh_u=(meshes[0], meshes[1]), mesh_p=meshes[2],
                      capacity_u=(caps[0], caps[1]),
                      operator_u=(ops[0], ops[1]), capacity_p=caps[2],
                      operator_p=ops[2], mu=1.0, rho=1.0,
                      f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0)
    bc = tpt.BorderConditions({k: tpt.Dirichlet(0.0) for k in
                               ("left", "right", "bottom", "top")})
    solver = StokesMono(fluid, (bc, bc), PinPressureGauge(),
                        tpt.Dirichlet(0.0), cut_row="ghost")
    assert any(g is not None for g in solver._ghost)
    window = (slice(0, 9), slice(0, 9))
    with pytest.raises(ValueError, match="item 17"):
        tsh.windowed_stokes(solver, window)
