"""The port's stencil matvecs.

On the CPU: the plain versions (``stencil5/7_matvec_ref``, and the wrappers,
which take them for CPU tensors) against the JAX package's XLA composite
``_apply_stencil("xla", ...)``.  The Pallas kernels themselves run only on
a TPU (tests/test_pallas_stencil.py skips them here), so the composite is
the JAX reference.

Marked ``cuda``: each CUDA kernel against its plain version on the card,
and the wrapper's input checks.  They skip without a CUDA device.  On a GPU
host, which need not have JAX, run them without the suite's JAX conftest:
``python -m pytest --noconftest -m cuda tests/test_torch_stencil.py``.
"""

import numpy as np
import pytest
import torch

from penguin_tpu_torch.kernels import stencil as ks

SHAPES_2D = [(1025, 1025), (1024, 1024), (257, 131), (13, 33), (1, 7)]
SHAPES_3D = [(13, 33, 17), (8, 8, 128), (2, 3, 1)]


def _inputs(shape, n_coeffs, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype)
            for _ in range(n_coeffs + 1)]


@pytest.mark.parametrize("shape", SHAPES_2D + SHAPES_3D,
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_composite(shape):
    """f64: the same products summed in the same order; 1e-13 relative
    covers any re-association by XLA's fusion."""
    # JAX is imported here, not at the top, so that the CUDA tests of this
    # file also run on a GPU host without JAX (see the module docstring)
    import jax.numpy as jnp
    from penguin_tpu.solvers.heat_fast import _apply_stencil as jax_apply_stencil

    arrays = _inputs(shape, 2 * len(shape) + 1)
    want = np.asarray(jax_apply_stencil(
        "xla", (), tuple(jnp.asarray(a) for a in arrays[:-1]),
        jnp.asarray(arrays[-1])))
    tens = [torch.as_tensor(a) for a in arrays]
    ref = (ks.stencil5_matvec_ref if len(shape) == 2
           else ks.stencil7_matvec_ref)(*tens)
    wrap = (ks.stencil5_matvec if len(shape) == 2
            else ks.stencil7_matvec)(*tens)
    tol = 1e-13 * np.abs(want).max()
    np.testing.assert_allclose(ref.numpy(), want, rtol=0, atol=tol)
    # on CPU tensors the wrapper is the plain version, bit for bit
    assert torch.equal(wrap, ref)


def test_cpu_wrapper_does_not_count_launches():
    before = ks.stencil5_matvec.launches
    ks.stencil5_matvec(*[torch.as_tensor(a) for a in _inputs((5, 6), 5)])
    assert ks.stencil5_matvec.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "ndim"])
def test_wrapper_rejects_bad_inputs_cpu(bad):
    arrays = [torch.as_tensor(a) for a in _inputs((6, 8), 5)]
    if bad == "dtype":
        arrays[2] = arrays[2].to(torch.float32)
    elif bad == "shape":
        arrays[1] = arrays[1][:, :7].contiguous()
    elif bad == "contiguous":
        arrays[-1] = torch.as_tensor(_inputs((8, 6), 0)[0]).T
    else:
        arrays = [a[None] for a in arrays]
    with pytest.raises((TypeError, ValueError)):
        ks.stencil5_matvec(*arrays)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


# Tolerances against the plain version, relative to max|y|: the kernel may
# contract products into FMAs and sums the 2N+1 terms in one expression, so
# results differ by a few ulps of the largest term.
TOL = {torch.float64: 1e-13, torch.float32: 1e-5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES_2D + SHAPES_3D,
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_on_card(cuda, shape, dtype):
    arrays = [torch.as_tensor(a, device=cuda).to(dtype)
              for a in _inputs(shape, 2 * len(shape) + 1)]
    if len(shape) == 2:
        kernel, plain = ks.stencil5_matvec, ks.stencil5_matvec_ref
    else:
        kernel, plain = ks.stencil7_matvec, ks.stencil7_matvec_ref
    before = kernel.launches
    got = kernel(*arrays)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = plain(*arrays)
    err = (got - want).abs().max().item()
    assert err <= TOL[dtype] * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "half", "contiguous", "device"])
def test_wrapper_rejects_bad_inputs_on_card(cuda, bad):
    arrays = [torch.as_tensor(a, device=cuda) for a in _inputs((6, 8), 5)]
    if bad == "dtype":
        arrays[3] = arrays[3].to(torch.float32)
    elif bad == "half":
        arrays = [a.half() for a in arrays]
    elif bad == "contiguous":
        arrays[0] = torch.as_tensor(_inputs((8, 6), 0)[0], device=cuda).T
    else:
        arrays[-1] = arrays[-1].cpu()
    before = ks.stencil5_matvec.launches
    with pytest.raises((TypeError, ValueError)):
        ks.stencil5_matvec(*arrays)
    assert ks.stencil5_matvec.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("ndim", [2, 3])
def test_fast_heat_on_card_matches_cpu(cuda, ndim):
    """FastHeatBE through the kernels on the card against the port's CPU
    path, f64: the same arithmetic up to summation order and FMA, so the
    fields agree to 1e-10 with equal CG counts per step."""
    import penguin_tpu_torch as tpt
    from penguin_tpu_torch.solvers import FastHeatBE

    n = (48, 40) if ndim == 2 else (20, 18, 22)
    body = (tpt.geometry.circle((2.0, 2.0), 1.0) if ndim == 2
            else tpt.geometry.sphere((2.0, 2.0, 2.0), 1.3))
    keys = ("left", "right", "top", "bottom", "backward", "forward")
    runs = []
    for dev in (cuda, torch.device("cpu")):
        mesh = tpt.Mesh(n, (4.0,) * ndim)
        cap = tpt.compute_capacity(body, mesh, p=4, s=1, device=dev)
        fast = FastHeatBE(cap, tpt.make_diffusion_ops(cap), 1.0, 0.0,
                          tpt.Dirichlet(1.0), tpt.BorderConditions(
                              {k: tpt.Dirichlet(0.0) for k in keys[:2 * ndim]}),
                          10.0 * (4.0 / n[0]) ** 2, cg_tol=1e-10,
                          cg_maxiter=200)
        T = T1 = T2 = torch.zeros(mesh.np_shape, dtype=torch.float64,
                                  device=dev)
        its = []
        for _ in range(6):
            Tn, k = fast.step(T, 3.0 * T - 3.0 * T1 + T2)
            T, T1, T2 = Tn, T, T1
            its.append(int(k))
        runs.append((T.cpu(), its))
    (Tg, itg), (Tc, itc) = runs
    assert itg == itc
    assert (Tg - Tc).abs().max().item() <= 1e-10
