"""The device the port's entry points use when the caller names none.

The port runs on the card: a constructor that makes tensors without being
given a device or a capacity to follow puts them on CUDA.  Without a CUDA
device such a call raises instead of carrying on on the CPU; pass
``device="cpu"`` to run there.
"""

from __future__ import annotations

import torch

__all__ = ["default_device", "resolve_device"]


def default_device():
    """``torch.device("cuda")``; raises when no CUDA device is available."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "penguin_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(device):
    """``device`` as a ``torch.device``, or the default device for None."""
    return default_device() if device is None else torch.device(device)
