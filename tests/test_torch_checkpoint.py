"""The port's checkpoint/resume and diagnostics: the JAX suite's
``tests/test_checkpoint.py`` inside the port, checkpoints written by either
package loaded by the other, a JAX solver checkpointed mid-run resumed by
the port's, and ``KrylovHistory`` against JAX's (f64, CPU)."""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import penguin_tpu as jpt
from penguin_tpu import checkpoint as jck, diagnostics as jdg
from penguin_tpu.solvers import diffusion as jd
import penguin_tpu_torch as tpt
from penguin_tpu_torch import checkpoint as tck, diagnostics as tdg
from penguin_tpu_torch.convert import capacity_from_numpy
from penguin_tpu_torch.linsolve import CHUNK, pcg
from penguin_tpu_torch.solvers import diffusion as td

from test_torch_diffusion import _fields
from torch_stefan_cases import one_thread  # noqa: F401  (autouse fixture)

CPU = "cpu"
KEYS = ("left", "right", "top", "bottom")
F64 = dict(dtype=torch.float64, device=CPU)


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py inside the port
# ---------------------------------------------------------------------------

def test_pytree_roundtrip(tmp_path):
    state = {
        "T": (torch.arange(6.0).reshape(2, 3), torch.zeros(4)),
        "markers": torch.ones((5, 2)),
        "nested": [torch.tensor(1.5), {"a": torch.tensor([1, 2, 3])}],
    }
    p = tmp_path / "ck.npz"
    tck.save_checkpoint(p, state, meta={"t": 0.25, "step": 7})
    loaded, meta = tck.load_checkpoint(p, device=CPU)
    assert meta == {"t": 0.25, "step": 7}
    assert np.allclose(loaded["T"][0].numpy(), np.arange(6).reshape(2, 3))
    assert isinstance(loaded["T"], tuple)
    assert isinstance(loaded["nested"], list)
    assert np.allclose(loaded["nested"][1]["a"].numpy(), [1, 2, 3])
    assert loaded["nested"][1]["a"].dtype == torch.int64
    assert loaded["T"][0].dtype == torch.float32


def _resume_case(pkg, mod, cap, mesh, nx, lx):
    """The JAX test's case: (make_solver, dt) of a BE diffusion run with
    an interface Dirichlet of 1 on ``cap``."""
    ops = pkg.make_diffusion_ops(cap)
    bc_b = pkg.BorderConditions({k: pkg.Dirichlet(0.0) for k in KEYS})
    phase = pkg.Phase(cap, ops, lambda x, y, z, t: 0.0, 1.0)
    z = (jnp.zeros(mesh.np_shape) if pkg is jpt
         else torch.zeros(mesh.np_shape, **F64))
    dt = 0.25 * (lx / nx) ** 2

    def make():
        return mod.DiffusionUnsteadyMono(phase, bc_b, pkg.Dirichlet(1.0), dt,
                                         (z, z), "BE")
    return make, dt


def test_solver_resume_matches_uninterrupted(tmp_path):
    """Run 8 BE steps straight vs 4 + checkpoint + restore + 4: identical."""
    nx, lx = 32, 4.0
    mesh = tpt.Mesh((nx, nx), (lx, lx), (0.0, 0.0))
    cap = tpt.compute_capacity(tpt.geometry.circle((2.01, 2.01), 1.0), mesh,
                               device=CPU)
    make, dt = _resume_case(tpt, td, cap, mesh, nx, lx)

    ref = make()
    ref.solve(8 * dt - dt / 2, method="direct")
    first = make()
    first.solve(4 * dt - dt / 2, method="direct")
    p = tmp_path / "mid.npz"
    tck.checkpoint_solver(p, first, t=4 * dt)

    second = make()
    meta = tck.restore_solver(p, second)
    assert meta["t"] == 4 * dt and meta["solver"] == "DiffusionUnsteadyMono"
    assert all(a.device.type == "cpu" for a in second.x)
    second.u0 = second.x  # resume from the checkpointed field
    second.solve(4 * dt - dt / 2, t_start=meta["t"], initial_solve=False,
                 method="direct")
    err = (ref.x_omega - second.x_omega).abs().max().item()
    assert err < 1e-12, err


def test_diagnostics_timers_and_history():
    tdg.reset()
    with tdg.timed("block"):
        x = torch.ones(100).sum()
    with tdg.timed("block", sync=x):
        pass
    table = tdg.report(print_fn=lambda *_: None)
    assert table["block"]["n"] == 2

    A = torch.diag(torch.arange(1.0, 5.0, dtype=torch.float64))
    hist = tdg.KrylovHistory(lambda v: A @ v)
    b = torch.ones(4, dtype=torch.float64)
    x, _, _ = pcg(hist, b, torch.zeros_like(b), tol=1e-5)
    assert hist.n_matvec > 0
    res = hist.record_final(b, x)
    assert res < 1e-6


def test_checkpoint_front_tracking_state(tmp_path):
    """Moving-interface solvers snapshot markers/xf plus their logs; the
    markers come back as a tensor, ``xf`` as a float and the logs as
    numpy, as the port's solvers hold them."""
    from penguin_tpu_torch.front_tracking import FrontTracker

    class FakeStefan:
        pass

    s1 = FakeStefan()
    s1.x = (torch.ones((5, 5), **F64), torch.zeros((5, 5), **F64))
    s1.markers = FrontTracker(**F64).create_circle((0.0, 0.0), 1.0,
                                                   n=16).markers
    s1.xf = 0.75
    s1.residual_log = np.array([1e-3, 1e-5])
    s1.iters_log = np.array([3, 2])
    p = tmp_path / "front.npz"
    tck.checkpoint_solver(p, s1, t=0.5, extra={"note": "mid-run"})

    s2 = FakeStefan()
    meta = tck.restore_solver(p, s2, device=CPU)
    assert meta["note"] == "mid-run" and meta["t"] == 0.5
    assert isinstance(s2.markers, torch.Tensor)
    assert torch.equal(s2.markers, s1.markers)
    assert isinstance(s2.xf, float) and s2.xf == 0.75
    assert isinstance(s2.residual_log, np.ndarray)
    np.testing.assert_array_equal(s2.residual_log, [1e-3, 1e-5])
    np.testing.assert_array_equal(s2.iters_log, [3, 2])
    assert isinstance(s2.x, tuple) and torch.equal(s2.x[0], s1.x[0])


def test_restore_follows_the_solver_device(tmp_path, monkeypatch):
    """Without a device, ``restore_solver`` puts the tensors on the device
    of the solver's ``x`` (else of its capacity), never asking for the
    default device."""
    from penguin_tpu_torch import _device

    def no_default():
        raise AssertionError("restore asked for the default device")

    class Holder:
        pass

    s1 = Holder()
    s1.x = (torch.ones(3, **F64),)
    p = tmp_path / "x.npz"
    tck.checkpoint_solver(p, s1, t=0.0)
    monkeypatch.setattr(_device, "default_device", no_default)
    s2 = Holder()
    s2.x = (torch.zeros(3, **F64),)
    tck.restore_solver(p, s2)
    assert s2.x[0].device.type == "cpu" and torch.equal(s2.x[0], s1.x[0])
    s3 = Holder()
    s3.capacity = tpt.compute_capacity(tpt.geometry.full_domain(1),
                                       tpt.Mesh((4,), (1.0,)), device=CPU)
    tck.restore_solver(p, s3)
    assert s3.x[0].device.type == "cpu"


def test_unsupported_nodes_raise_as_in_jax(tmp_path):
    """A None node raises the JAX package's TypeError; so does any object
    that is not a container, a tensor, an array or a scalar."""
    with pytest.raises(TypeError) as tj:
        jck.save_checkpoint(tmp_path / "j.npz", {"a": None})
    with pytest.raises(TypeError) as tt:
        tck.save_checkpoint(tmp_path / "t.npz", {"a": None})
    assert str(tt.value) == str(tj.value)
    with pytest.raises(TypeError, match="unsupported pytree node"):
        tck.save_checkpoint(tmp_path / "t.npz", {"a": object()})


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------

Pair = collections.namedtuple("Pair", "first second")


def _mixed_state():
    """Tuples, lists and dicts with unsorted keys; f32, f64, int and bool
    arrays, a 0-d array and a namedtuple (numpy, from a seed)."""
    rng = np.random.default_rng(7)
    return {
        "zeta": (rng.standard_normal((3, 4)),
                 [rng.standard_normal(5).astype(np.float32),
                  rng.integers(-9, 9, (2, 2)).astype(np.int64)]),
        "alpha": Pair(np.array(rng.standard_normal()),
                      rng.standard_normal((2, 3)) > 0),
        "mid": {"y": rng.integers(0, 5, 4).astype(np.int32),
                "b": [np.float32(rng.standard_normal())],
                "a": rng.standard_normal((2, 1, 3))},
    }


def _as_numpy_tree(tree):
    """A loaded state as (container kind, dict keys, children), with numpy
    leaves."""
    if isinstance(tree, dict):
        return ("dict", list(tree), [_as_numpy_tree(v) for v in tree.values()])
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, None, [_as_numpy_tree(v) for v in tree])
    return (tree.numpy() if isinstance(tree, torch.Tensor)
            else np.asarray(tree))


def _assert_same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)
        return
    assert a[:2] == b[:2] and len(a[2]) == len(b[2]), (a[:2], b[:2])
    for x, y in zip(a[2], b[2]):
        _assert_same(x, y)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """A state written by one package loads in the other with equal values
    (bit for bit), dtypes, container types, key order and meta, and as it
    loads in the writer itself."""
    state = _mixed_state()
    meta = {"t": 0.125, "step": 3, "note": "mid-run", "dt": None}
    p = tmp_path / "ck.npz"
    if writer == "jax":
        jck.save_checkpoint(p, jax.tree_util.tree_map(jnp.asarray, state),
                            meta)
    else:
        tstate = {
            "zeta": (torch.from_numpy(state["zeta"][0]),
                     [torch.from_numpy(a) for a in state["zeta"][1]]),
            "alpha": Pair(*(torch.from_numpy(np.asarray(a))
                            for a in state["alpha"])),
            "mid": {"y": torch.from_numpy(state["mid"]["y"]),
                    "b": [state["mid"]["b"][0]],
                    "a": torch.from_numpy(state["mid"]["a"])},
        }
        tck.save_checkpoint(p, tstate, meta)
    jstate, jmeta = jck.load_checkpoint(p)
    tstate, tmeta = tck.load_checkpoint(p, device=CPU)
    assert jmeta == tmeta == meta
    jtree = _as_numpy_tree(jax.tree_util.tree_map(np.asarray, jstate))
    ttree = _as_numpy_tree(tstate)
    _assert_same(jtree, ttree)
    assert list(tstate) == sorted(state)       # JAX sorts the keys
    assert isinstance(tstate["alpha"], tuple)  # a namedtuple loads as one
    assert tstate["zeta"][1][0].dtype == torch.float32
    assert tstate["mid"]["y"].dtype == torch.int32
    assert tstate["alpha"][1].dtype == torch.bool
    assert tstate["alpha"][0].shape == ()
    np.testing.assert_array_equal(tstate["zeta"][0].numpy(),
                                  state["zeta"][0])


def test_jax_solver_resumes_in_the_port(tmp_path):
    """JAX's DiffusionUnsteadyMono runs 4 BE steps and is checkpointed by
    JAX; the port's solver on the same (carried) capacity restores the file
    and runs 4 more: it matches JAX's uninterrupted 8 steps to 1e-9 of
    scale, the solver-class tolerance of test_torch_diffusion.py."""
    nx, lx = 20, 4.0
    jmesh = jpt.Mesh((nx, nx), (lx, lx), (0.0, 0.0))
    jcap = jpt.compute_capacity(jpt.geometry.circle((2.01, 2.01), 1.0), jmesh)
    tmesh = tpt.Mesh((nx, nx), (lx, lx), (0.0, 0.0))
    tcap = capacity_from_numpy(_fields(jcap), tmesh, device=CPU)
    jmake, dt = _resume_case(jpt, jd, jcap, jmesh, nx, lx)
    tmake, _ = _resume_case(tpt, td, tcap, tmesh, nx, lx)

    ref = jmake()
    ref.solve(8 * dt - dt / 2, method="direct")
    first = jmake()
    first.solve(4 * dt - dt / 2, method="direct")
    p = tmp_path / "jax_mid.npz"
    jck.checkpoint_solver(p, first, t=4 * dt)

    second = tmake()
    meta = tck.restore_solver(p, second)
    assert meta["t"] == 4 * dt and meta["solver"] == "DiffusionUnsteadyMono"
    second.u0 = second.x
    second.solve(4 * dt - dt / 2, t_start=meta["t"], initial_solve=False,
                 method="direct")
    for a, b in zip(ref.x, second.x):
        a = np.asarray(a)
        err = np.abs(b.numpy() - a).max() / max(np.abs(a).max(), 1.0)
        assert err <= 1e-9, err


def test_krylov_history_matches_jax():
    """tests/test_checkpoint.py:63-83's diagonal system: both histories
    record a final relative residual at round-off, within 1e-12 of each
    other.  JAX's ``cg`` calls the Python matvec while it traces (its count
    is of traces); the port's ``pcg`` calls it for every application: once
    for r0 and once per iteration of each chunk of CHUNK, so
    1 + CHUNK·ceil(4 / CHUNK) for the 4 iterations of 4 distinct
    eigenvalues."""
    from jax.scipy.sparse.linalg import cg

    A = jnp.diag(jnp.arange(1.0, 5.0))
    jh = jdg.KrylovHistory(lambda v: A @ v)
    b = jnp.ones(4)
    x, _ = cg(jh, b)
    jres = jh.record_final(b, x)

    At = torch.diag(torch.arange(1.0, 5.0, dtype=torch.float64))
    th = tdg.KrylovHistory(lambda v: At @ v)
    bt = torch.ones(4, dtype=torch.float64)
    xt, iters, _ = pcg(th, bt, torch.zeros_like(bt), tol=1e-5)
    tres = th.record_final(bt, xt)
    assert jh.n_matvec > 0 and th.n_matvec > 0
    assert iters == 4
    assert th.n_matvec == 1 + CHUNK * -(-iters // CHUNK)
    assert jres < 1e-12 and tres < 1e-12 and abs(jres - tres) < 1e-12
    np.testing.assert_allclose(xt.numpy(), np.asarray(x), rtol=0,
                               atol=1e-12)
    # a tuple state flattens as JAX's ravel_pytree does
    jt = jdg.KrylovHistory(lambda v: (A @ v[0], 2.0 * v[1]))
    tt = tdg.KrylovHistory(lambda v: (At @ v[0], 2.0 * v[1]))
    rng = np.random.default_rng(3)
    bs, xs = rng.standard_normal((2, 2, 4))
    jr = jt.record_final(tuple(map(jnp.asarray, bs)),
                         tuple(map(jnp.asarray, xs)))
    tr = tt.record_final(tuple(map(torch.from_numpy, bs)),
                         tuple(map(torch.from_numpy, xs)))
    assert abs(jr - tr) <= 1e-12 * jr
