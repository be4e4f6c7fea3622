"""Hand-written CUDA kernels of the PyTorch port, with their plain PyTorch
versions (built from ``csrc/`` at first use, never at import)."""

from .stencil import (
    stencil5_matvec,
    stencil5_matvec_ref,
    stencil7_matvec,
    stencil7_matvec_ref,
)

__all__ = ["stencil5_matvec", "stencil5_matvec_ref", "stencil7_matvec",
           "stencil7_matvec_ref"]
