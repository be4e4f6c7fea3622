"""The port's periphery: the periphery-only tests of the JAX suite's
``tests/test_periphery.py`` inside the port (plots, VTK, the Krylov
preconditioner hook, the Stefan telemetry plots), VTK files and
``interface_spectrum``/``convergence_rates`` against JAX's, the CUDA sync
of ``timed`` and the ``torch.profiler`` trace (f64, CPU)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu import diagnostics as jdg, viz as jviz, vtk as jvtk
from penguin_tpu.front_tracking import markers_crystal as jcrystal
from penguin_tpu.solvers import diffusion as jd
import penguin_tpu_torch as tpt
from penguin_tpu_torch import diagnostics as tdg, viz, vtk
from penguin_tpu_torch.convert import capacity_from_numpy
from penguin_tpu_torch.front_tracking import markers_circle, markers_crystal
from penguin_tpu_torch.solvers import diffusion as td

from test_torch_diffusion import _fields
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

CPU = "cpu"
KEYS = ("left", "right", "top", "bottom")
F64 = dict(dtype=torch.float64, device=CPU)


def _steady(pkg, mod, cap, g_border=1.0, source=4.0):
    bc_b = pkg.BorderConditions({k: pkg.Dirichlet(g_border) for k in KEYS})
    phase = pkg.Phase(cap, pkg.make_diffusion_ops(cap),
                      lambda x, y, z: source, 1.0)
    s = mod.DiffusionSteadyMono(phase, bc_b, pkg.Dirichlet(0.0))
    s.solve(method="direct")
    return s


# ---------------------------------------------------------------------------
# tests/test_periphery.py's periphery tests inside the port
# ---------------------------------------------------------------------------

def test_viz_and_vtk(tmp_path):
    mesh = tpt.Mesh((16, 16), (4.0, 4.0), (0.0, 0.0))
    body = tpt.geometry.circle((2.0, 2.0), 1.0)
    cap = tpt.compute_capacity(body, mesh, device=CPU)
    solver = _steady(tpt, td, cap)
    png = viz.plot_solution(solver, mesh, body, cap,
                            filename=str(tmp_path / "sol.png"))
    assert os.path.exists(png) and os.path.getsize(png) > 0
    f = vtk.write_vtk(str(tmp_path / "sol"), mesh, solver)
    assert os.path.exists(f) and os.path.getsize(f) > 1000
    pvd = vtk.write_vtk_series(str(tmp_path / "series"), mesh,
                               [solver.x, solver.x], times=[0.0, 1.0])
    assert os.path.exists(pvd)
    assert os.path.exists(str(tmp_path / "series_0001.vtk"))
    amp = viz.interface_spectrum(markers_circle((2, 2), 1.0, 64, **F64),
                                 (2, 2))
    assert amp.shape[0] == 33 and amp[1:].max() < 1e-10


def test_isotherms_and_spectrum(tmp_path):
    """plot_isotherms renders; interface_spectrum of a 6-lobe crystal
    peaks at wavenumber 6."""
    mesh = tpt.Mesh((16, 16), (2.0, 2.0), (0.0, 0.0))
    body = tpt.geometry.circle((1.0, 1.0), 0.6)
    cap = tpt.compute_capacity(body, mesh, device=CPU)
    s = _steady(tpt, td, cap, g_border=0.0, source=1.0)
    out = tmp_path / "iso.png"
    viz.plot_isotherms(s, mesh, body=body, filename=str(out))
    assert out.exists() and out.stat().st_size > 0

    mk = markers_crystal((0.0, 0.0), 1.0, n=96, n_lobes=6, amplitude=0.1,
                         **F64)
    amp = viz.interface_spectrum(mk, (0.0, 0.0))
    assert int(np.argmax(amp[1:])) + 1 == 6


def test_preconditioner_hook_improves_fixed_budget_residual():
    """With a fixed 5-iteration budget on an ill-scaled SPD system,
    Jacobi-preconditioned CG reaches a far smaller residual.  The port's
    KrylovHistory sees every application (the JAX one sees only traces):
    the r0 apply and one per iteration of the 8-iteration chunk."""
    from penguin_tpu_torch.linsolve import CHUNK, KrylovSolver

    d = torch.as_tensor(np.logspace(0, 4, 100))
    b = torch.ones(100, dtype=torch.float64)

    def res(x):
        return float(torch.linalg.norm(d * x - b))

    plain = tdg.KrylovHistory(lambda v: d * v)
    x_plain = KrylovSolver(plain, method="cg", tol=0.0, maxiter=5).solve(b)
    x_prec = KrylovSolver(lambda v: d * v, method="cg", tol=0.0, maxiter=5,
                          M=lambda v: v / d).solve(b)
    assert res(x_prec) < 1e-6
    assert res(x_prec) < 1e-3 * res(x_plain)
    assert plain.n_matvec == 1 + CHUNK
    assert plain.record_final(b, x_plain) == pytest.approx(
        res(x_plain) / 10.0, rel=1e-12)


def test_stefan_newton_telemetry_and_plots(tmp_path):
    """The port's StefanMono2D records per-iteration GN residual curves
    and (opt-in) residual grids; plot_newton_rates and
    plot_residual_fields render them."""
    from penguin_tpu_torch.solvers import stefan2d as ts
    from torch_stefan_cases import mono_solver

    s, front, ic = mono_solver(tpt, ts, tpt.Dirichlet(0.0))
    s.solve(front, 0.0, 0.05, ic, newton_params=(6, 1e-5, 1e-6, 1.0),
            interior_fluid=False, method="bicgstab", p=4, s=1,
            jac="intercept", capture_residual_field=True)
    H = s.residual_hist
    assert H.ndim == 2 and H.shape[1] == 6
    assert np.isfinite(H[:, 0]).all() and (H[:, 0] > 0).all()
    rates = tdg.convergence_rates(H)
    assert rates.shape == (H.shape[0],)
    assert (rates <= 0.0).any()
    F = s.residual_fields
    assert F is not None and F.shape[0] == H.shape[0]
    assert np.isfinite(F).all()
    p1 = viz.plot_newton_rates(H, filename=str(tmp_path / "rates.png"))
    p2 = viz.plot_residual_fields(F, filename=str(tmp_path / "fields.png"))
    p3 = viz.plot_interface_evolution(s.marker_log,
                                      filename=str(tmp_path / "front.png"))
    for p in (p1, p2, p3):
        assert os.path.exists(p) and os.path.getsize(p) > 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_convergence_rates_matches_jax():
    """One NaN-padded history (a one-iteration step, a step without
    convergence, a zero entry) gives JAX's rates to 1e-12."""
    rng = np.random.default_rng(11)
    H = 10.0 ** -np.cumsum(rng.uniform(0.2, 2.0, (6, 7)), axis=1)
    H[0, 1:] = np.nan
    H[2, 4:] = np.nan
    H[3, 2] = 0.0
    H[5, 5:] = np.nan
    got = tdg.convergence_rates(torch.as_tensor(H))
    want = jdg.convergence_rates(jnp.asarray(H))
    assert got[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_interface_spectrum_matches_jax():
    """The same markers give JAX's amplitudes to 1e-12; the 6-lobe crystal
    peaks at 6."""
    mk = np.array(jcrystal((0.3, -0.2), 1.0, n=96, n_lobes=6,
                           amplitude=0.1))
    got = viz.interface_spectrum(torch.as_tensor(mk), (0.3, -0.2))
    want = jviz.interface_spectrum(jnp.asarray(mk), (0.3, -0.2))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-12)
    assert int(np.argmax(got[1:])) + 1 == 6


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_vtk_bytes_match_jax(tmp_path, ndim):
    """One numpy field (and a two-field series) written through both
    packages gives identical files; the port takes the field as a tensor
    as well."""
    rng = np.random.default_rng(ndim)
    n = (6, 5, 4)[:ndim]
    args = (n, (1.0, 2.0, 0.5)[:ndim], (0.1, -0.3, 0.0)[:ndim])
    jmesh, tmesh = jpt.Mesh(*args), tpt.Mesh(*args)
    a, b = rng.standard_normal((2,) + jmesh.np_shape)

    class Holder:
        pass

    def write(mod, mesh, field, tag):
        s = Holder()
        s.x = field
        f = mod.write_vtk(str(tmp_path / f"{tag}"), mesh, s,
                          extra_fields={"q": field[1]})
        series = mod.write_vtk_series(str(tmp_path / f"{tag}_s"), mesh,
                                      [field, field[0]], times=[0.0, 0.5])
        return [open(p, "rb").read() for p in
                (f, series, str(tmp_path / f"{tag}_s_0000.vtk"),
                 str(tmp_path / f"{tag}_s_0001.vtk"))]

    want = write(jvtk, jmesh, (a, b), "jax")
    got = write(vtk, tmesh, (a, b), "port")
    got_t = write(vtk, tmesh, (torch.as_tensor(a), torch.as_tensor(b)),
                  "port_t")
    assert want[0].startswith(b"# vtk DataFile Version 3.0\npenguin_tpu")
    # the collection names its own files: compare it with the tag swapped
    assert got[1] == want[1].replace(b"jax_s", b"port_s")
    for w, g, gt in zip(want[:1] + want[2:], got[:1] + got[2:],
                        got_t[:1] + got_t[2:]):
        assert w == g == gt


def _read_vtk(path):
    """name -> values of a legacy ASCII VTK file's scalar fields."""
    out, name, vals = {}, None, []
    with open(path) as f:
        for line in f:
            if line.startswith("SCALARS"):
                if name:
                    out[name] = np.array(vals)
                name, vals = line.split()[1], []
            elif name and not line.startswith("LOOKUP_TABLE"):
                vals.append(float(line))
    out[name] = np.array(vals)
    return out


def test_solver_vtk_matches_jax(tmp_path):
    """The steady mono solve of test_viz_and_vtk in each package (the
    port on JAX's capacity), each written and parsed back: the fields
    agree to 1e-9 of scale, the solver-class tolerance."""
    n = 16
    args = ((n, n), (4.0, 4.0), (0.0, 0.0))
    jmesh, tmesh = jpt.Mesh(*args), tpt.Mesh(*args)
    jcap = jpt.compute_capacity(jpt.geometry.circle((2.0, 2.0), 1.0), jmesh)
    tcap = capacity_from_numpy(_fields(jcap), tmesh, device=CPU)
    js, ts = _steady(jpt, jd, jcap), _steady(tpt, td, tcap)
    want = _read_vtk(jvtk.write_vtk(str(tmp_path / "jax"), jmesh, js))
    got = _read_vtk(vtk.write_vtk(str(tmp_path / "port"), tmesh, ts))
    assert list(got) == list(want) == ["T_omega", "T_gamma"]
    for name in want:
        scale = max(np.abs(want[name]).max(), 1.0)
        assert np.abs(got[name] - want[name]).max() <= 1e-9 * scale, name
    np.testing.assert_allclose(got["T_omega"],
                               ts.x[0].numpy().ravel(order="F"), rtol=1e-9)


# ---------------------------------------------------------------------------
# timers and traces
# ---------------------------------------------------------------------------

def test_timed_syncs_only_cuda_leaves(monkeypatch):
    """``timed`` synchronises the device of each CUDA tensor in ``sync``
    (once per device), whether given as an argument or through the box,
    and nothing for CPU tensors."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: calls.append(device))

    class FakeCuda(torch.Tensor):
        """A CPU tensor that reports itself on the second CUDA device."""
        is_cuda = True
        device = torch.device("cuda", 1)

    def card():
        return torch.ones(1).as_subclass(FakeCuda)

    tdg.reset()
    with tdg.timed("cpu", sync=(torch.ones(3), [torch.zeros(2)])):
        pass
    assert calls == []
    with tdg.timed("card", sync={"a": (card(), card()),
                                 "b": torch.ones(2), "c": 1.0}):
        pass
    assert calls == [torch.device("cuda", 1)]
    with tdg.timed("card") as box:
        box["sync"] = [card()]
    assert len(calls) == 2
    table = tdg.report(print_fn=lambda *_: None)
    assert table["card"]["n"] == 2 and table["cpu"]["n"] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` profiles the block under its name and leaves a Chrome
    trace in the directory it yields; the block's ops are in it."""
    x = torch.ones(64, 64, dtype=torch.float64)
    with tdg.trace("heat_block", str(tmp_path)) as d:
        y = (x @ x).sum()
    assert d == str(tmp_path) and float(y) == 64.0 ** 3
    path = tmp_path / "heat_block.pt.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "heat_block" in names
    assert any(str(name).startswith("aten::mm") for name in names)
