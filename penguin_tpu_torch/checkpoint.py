"""Checkpoint / resume for long simulations (torch).

Counterpart of ``penguin_tpu.checkpoint``, with the same file layout, so
that either package reads a checkpoint the other wrote: one compressed
``.npz`` holding the leaves as ``leaf_{i}``, a JSON ``__header__``
(``treedef``, ``n_leaves``, ``meta``, ``dtypes``) and a JSON
``__skeleton__`` of the containers (``__t__`` tuples, ``__l__`` lists,
``__d__`` dicts, leaf indices), both stored as uint8.

- ``save_checkpoint(path, state, meta=...)`` — flattens a state built from
  tuples, lists and dicts of tensors, arrays and Python scalars in JAX's
  leaf order (dict keys sorted; a namedtuple is saved as a tuple); a tensor
  keeps its dtype.
- ``load_checkpoint(path, device=None)`` — returns ``(state, meta)`` with
  tensors on ``device`` (the CUDA device by default).
- ``checkpoint_solver`` / ``restore_solver`` — snapshot a solver's public
  state (``x``, plus moving-solver attributes ``markers``/``xf``/
  ``marker_log``/``xf_log`` and the Newton logs when present).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ._device import resolve_device

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "checkpoint_solver",
    "restore_solver",
]

_SOLVER_ATTRS = ("x", "markers", "xf", "marker_log", "xf_log",
                 "residual_log", "iters_log", "newton_errs", "newton_iters")
# the attributes the port's solvers hold as numpy (the per-step logs, read
# once after the loop); ``x`` and ``markers`` are tensors, ``xf`` a float
_NUMPY_ATTRS = ("marker_log", "xf_log", "residual_log", "iters_log",
                "newton_errs", "newton_iters")
_LEAF_TYPES = (torch.Tensor, np.ndarray, np.generic, bool, int, float)


def _flatten(obj, leaves):
    """The skeleton of ``obj`` (leaf indices in place of leaves), appending
    the leaves to ``leaves`` in JAX's order."""
    if isinstance(obj, _LEAF_TYPES):
        leaves.append(obj)
        return len(leaves) - 1
    if isinstance(obj, tuple):
        return tuple(_flatten(o, leaves) for o in obj)
    if isinstance(obj, list):
        return [_flatten(o, leaves) for o in obj]
    if isinstance(obj, dict):
        return {k: _flatten(obj[k], leaves) for k in sorted(obj)}
    raise TypeError(
        "save_checkpoint supports states built from tuples/lists/dicts of "
        f"arrays; got an unsupported pytree node of type {type(obj).__name__}"
        " — convert custom nodes (dataclasses, namedtuples) to plain "
        "containers first, e.g. via jax.tree_util.tree_flatten.")


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path, state, meta=None):
    """Write ``state`` (tuples/lists/dicts of tensors, arrays or scalars) +
    ``meta`` (JSON-able dict) to ``path`` (an ``.npz`` file)."""
    leaves = []
    skeleton = _flatten(state, leaves)
    arrays = {f"leaf_{i}": _to_numpy(a) for i, a in enumerate(leaves)}
    header = {
        # JAX writes str(treedef) here; neither loader reads it
        "treedef": repr(skeleton),
        "n_leaves": len(leaves),
        "meta": meta or {},
        "dtypes": [str(arrays[f"leaf_{i}"].dtype) for i in range(len(leaves))],
    }
    arrays["__header__"] = np.frombuffer(json.dumps(header).encode(),
                                         dtype=np.uint8)
    arrays["__skeleton__"] = np.frombuffer(
        json.dumps(_encode_skeleton(skeleton)).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def _encode_skeleton(obj):
    if isinstance(obj, tuple):
        return {"__t__": [_encode_skeleton(o) for o in obj]}
    if isinstance(obj, list):
        return {"__l__": [_encode_skeleton(o) for o in obj]}
    if isinstance(obj, dict):
        return {"__d__": {k: _encode_skeleton(v) for k, v in obj.items()}}
    return obj


def _decode_skeleton(obj, leaves):
    if isinstance(obj, dict):
        if "__t__" in obj:
            return tuple(_decode_skeleton(o, leaves) for o in obj["__t__"])
        if "__l__" in obj:
            return [_decode_skeleton(o, leaves) for o in obj["__l__"]]
        if "__d__" in obj:
            return {k: _decode_skeleton(v, leaves)
                    for k, v in obj["__d__"].items()}
    return leaves[int(obj)]


def load_checkpoint(path, device=None):
    """Returns ``(state, meta)``: the state with tensors on ``device`` (the
    CUDA device by default) + metadata."""
    device = resolve_device(device)
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        skeleton = json.loads(bytes(z["__skeleton__"]).decode())
        leaves = [torch.from_numpy(z[f"leaf_{i}"]).to(device)
                  for i in range(header["n_leaves"])]
    return _decode_skeleton(skeleton, leaves), header["meta"]


def checkpoint_solver(path, solver, t=None, dt=None, extra=None):
    """Snapshot the solver's resumable state (solution + any
    moving-interface attributes and logs present) + time metadata."""
    state = {attr: getattr(solver, attr) for attr in _SOLVER_ATTRS
             if getattr(solver, attr, None) is not None}
    meta = {"t": t, "dt": dt if dt is not None else getattr(solver, "dt", None),
            "solver": type(solver).__name__}
    if extra:
        meta.update(extra)
    return save_checkpoint(path, state, meta)


def _solver_device(solver):
    """The device of the solver's ``x`` or capacity, or None."""
    x = getattr(solver, "x", None)
    while isinstance(x, (tuple, list)) and x:
        x = x[0]
    if isinstance(x, torch.Tensor):
        return x.device
    cap = getattr(solver, "capacity", None)
    return None if cap is None else cap.V.device


def restore_solver(path, solver, device=None):
    """Load a checkpoint into ``solver`` (sets the snapshotted attributes
    in place) and return the metadata dict.  Tensors go to ``device``, else
    to the device of the solver's ``x`` or capacity, else to the default
    device; the logs come back as numpy and ``xf`` as a float."""
    state, meta = load_checkpoint(
        path, device if device is not None else _solver_device(solver))
    for attr, val in state.items():
        if attr == "xf":
            val = float(val)
        elif attr in _NUMPY_ATTRS:
            val = val.cpu().numpy()
        setattr(solver, attr, val)
    return meta
