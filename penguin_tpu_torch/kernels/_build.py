"""Build the CUDA sources under ``penguin_tpu_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``.  The
library goes to ``penguin_tpu_torch/_build/lib<name>-<hash>.so``, keyed by a
hash of the source and the flags, so an edited source is rebuilt.  The
build writes a temporary file in the same directory and renames it into
place, so concurrent processes (e.g. pytest-xdist workers on a GPU host)
never load a half-written library.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")


def find_nvcc():
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels of penguin_tpu_torch are "
        "built from source at first use and need the CUDA toolkit")


def library_path(name):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library(name):
    """Build ``csrc/<name>.cu`` if its library is missing, and load it."""
    target = library_path(name)
    if not target.exists():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-",
                                   suffix=".so")
        os.close(fd)
        try:
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
                capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build csrc/{name}.cu "
                    f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(str(target))
