"""Peaks of the cards the benchmark knows, and the operations and bytes of
the kernels it reads a roofline share for.

Peaks are the published dense rates of the SXM part at its full power
limit (NVIDIA H100 data sheet): 3.35 TB/s of HBM3, 67 TFLOP/s in float32
and 34 TFLOP/s in float64 outside the tensor cores.
"""

from __future__ import annotations

PEAKS = {
    "H100": dict(bytes_s=3.35e12, flops_s={4: 67e12, 8: 34e12}),
}


def peaks(kind):
    """The peak table of the card named ``kind``, or None."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None


def stencil_work(ndim, numel, itemsize):
    """(flops, bytes) of one (2N+1)-point variable-coefficient matvec on an
    array of ``numel`` elements: 2N+1 coefficients and x read once, y
    written once; 2N+1 multiplies and 2N adds an element."""
    return (4 * ndim + 1) * numel, (2 * ndim + 3) * numel * itemsize


def least_seconds(kind, ndim, numel, itemsize):
    """The least time the card could take for one such matvec: the larger
    of its bytes over the bandwidth and its flops over the peak rate."""
    p = peaks(kind)
    if p is None or itemsize not in p["flops_s"]:
        return None
    flops, nbytes = stencil_work(ndim, numel, itemsize)
    return max(nbytes / p["bytes_s"], flops / p["flops_s"][itemsize])
