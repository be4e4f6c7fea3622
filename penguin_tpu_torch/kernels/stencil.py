"""Variable-coefficient 5-point (2D) and 7-point (3D) stencil matvecs: the
matvec inside the FastHeatBE CG (``solvers/heat_fast.py`` collapses
``V + dt·Id·GᵀWꜝG`` to this form).

    y[i,j] = cc[i,j] x[i,j] + cxm[i,j] x[i-1,j] + cxp[i,j] x[i+1,j]
           + cym[i,j] x[i,j-1] + cyp[i,j] x[i,j+1]

and in 3D additionally ``czm x[i,j,k-1] + czp x[i,j,k+1]``; neighbours
outside the array read 0 (no wrap).

Source note.  ``stencil5_matvec`` and ``stencil7_matvec`` replace the Pallas
TPU kernels of ``penguin_tpu/pallas_kernels/stencil.py`` (``stencil5_matvec``
with body ``_kernel``, ``stencil7_matvec`` with body ``_kernel3``) by
hand-written CUDA C++ for Hopper in ``csrc/stencil.cu``, built by
``_build.py`` and bound with ``ctypes``.  On the H100 the operator is bound
by memory traffic: 2N+2 arrays read and one written per call (at 1025² f32,
29.4 MB), against 2N+1 multiply-adds per element.  The kernel runs one
thread per element with the contiguous axis on ``threadIdx.x``, so every
load and the store coalesce, and masks the neighbour loads at the edges, so
it takes any shape: the TPU's tile alignment, and FastHeatBE's padding for
it, are gone.

Dispatch: a CPU tensor goes to the plain PyTorch version
(``stencil5_matvec_ref`` / ``stencil7_matvec_ref``); a CUDA tensor goes to
the kernel, or the wrapper raises.  Each wrapper counts its kernel launches
in its ``launches`` attribute.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..operators import _shift_m, _shift_p
from ._build import load_library

__all__ = ["stencil5_matvec", "stencil7_matvec", "stencil5_matvec_ref",
           "stencil7_matvec_ref"]

_DTYPES = (torch.float32, torch.float64)


def _stencil_ref(coeffs, x):
    acc = coeffs[0] * x
    for d in range((len(coeffs) - 1) // 2):
        acc = (acc + coeffs[1 + 2 * d] * _shift_m(x, d)
               + coeffs[2 + 2 * d] * _shift_p(x, d))
    return acc


def stencil5_matvec_ref(cc, cxm, cxp, cym, cyp, x):
    """Plain PyTorch 5-point apply: the shift composite."""
    return _stencil_ref((cc, cxm, cxp, cym, cyp), x)


def stencil7_matvec_ref(cc, cxm, cxp, cym, cyp, czm, czp, x):
    """Plain PyTorch 7-point apply: the shift composite."""
    return _stencil_ref((cc, cxm, cxp, cym, cyp, czm, czp), x)


def _check(name, ndim, arrays):
    x = arrays[-1]
    if x.dim() != ndim:
        raise ValueError(f"{name} takes {ndim}-D arrays, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or float64, got {x.dtype}")
    for a in arrays:
        if a.device != x.device or a.dtype != x.dtype or a.shape != x.shape:
            raise ValueError(
                f"{name}: every array must match x ({x.dtype}, "
                f"{tuple(x.shape)}, {x.device}); got {a.dtype}, "
                f"{tuple(a.shape)}, {a.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous arrays")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, got {x.device}")
    if x.device.type == "cuda" and x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: arrays on {x.device}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


@functools.cache
def _entry(name, n_arrays, n_extents):
    fn = getattr(load_library("stencil"), name)
    fn.argtypes = ([ctypes.c_void_p] * n_arrays + [ctypes.c_int64] * n_extents
                   + [ctypes.c_int64, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name, arrays):
    """Run ``name`` from ``csrc/stencil.cu`` on ``arrays`` (coefficients then
    x), on the current stream; returns y."""
    x = arrays[-1]
    fn = _entry(name, len(arrays) + 1, x.dim())
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(*[a.data_ptr() for a in arrays], y.data_ptr(), *x.shape,
             x.element_size(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return y


def stencil5_matvec(cc, cxm, cxp, cym, cyp, x):
    """5-point variable-coefficient stencil apply (2D): the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    arrays = (cc, cxm, cxp, cym, cyp, x)
    _check("stencil5_matvec", 2, arrays)
    if x.device.type == "cpu":
        return stencil5_matvec_ref(*arrays)
    y = _launch("stencil5_matvec", arrays)
    stencil5_matvec.launches += 1
    return y


def stencil7_matvec(cc, cxm, cxp, cym, cyp, czm, czp, x):
    """7-point variable-coefficient stencil apply (3D): the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    arrays = (cc, cxm, cxp, cym, cyp, czm, czp, x)
    _check("stencil7_matvec", 3, arrays)
    if x.device.type == "cpu":
        return stencil7_matvec_ref(*arrays)
    y = _launch("stencil7_matvec", arrays)
    stencil7_matvec.launches += 1
    return y


stencil5_matvec.launches = 0
stencil7_matvec.launches = 0
# the wrappers that count their launches; ``_graph`` keeps these counters
# true for the kernels a CUDA graph replays
_COUNTED = (stencil5_matvec, stencil7_matvec)
