"""Structured diagnostics: timers, optional step logging, profiler traces
(torch).

Counterpart of ``penguin_tpu.diagnostics``:

- ``span(name)`` — context manager leaving one host event named ``name`` in
  a running ``torch.profiler`` trace, on the clock of the trace's device
  events, and nothing on the device timeline; with no profiler running it
  costs the call alone (port only: JAX has no counterpart).
- ``timed(name)`` — context manager timing a block inside ``span(name)``;
  before the clock stops it waits for the device of every CUDA tensor in an
  optional ``sync`` result, so device work is included; records into a
  global registry (``report()`` prints a table).
- ``trace(name, dir)`` — context manager wrapping ``torch.profiler`` (the
  CPU, and the CUDA device when there is one); on exit it writes a Chrome
  trace, ``<name>.pt.trace.json``, into ``dir``.
- ``log_every(k)`` — throttled logger for time loops driven from Python.
- ``KrylovHistory`` — wraps a matvec to count its applications and records
  the true relative residual of an iterative solve (the reference's
  ``Solver.ch``, solver.jl:136-139,176-180).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast

__all__ = ["span", "timed", "report", "reset", "trace", "log_every",
           "KrylovHistory", "convergence_rates"]

_REGISTRY: dict = {}


def _tensors(tree):
    """The tensors of a nested tuple/list/dict; anything else is skipped."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def span(name):
    """A context manager that leaves one host event named ``name``, around
    its block, in a running ``torch.profiler`` trace.

    The event is a ``cpu_op``, as an aten op is, on the profiler's clock,
    which is the clock of the trace's kernels.  ``record_function`` would
    make a ``user_annotation`` instead, which the profiler also mirrors onto
    the device timeline, where it would read as device work.  With no
    profiler running nothing is recorded and the block costs this call
    alone (under a microsecond): no sync, no CUDA event, no registry
    entry."""
    return _RecordFunctionFast(name)


@contextlib.contextmanager
def timed(name, sync=None):
    """Time a block, inside ``span(name)``; the devices of the CUDA tensors
    in ``sync`` (a tensor or a tuple/list/dict of them, or ``box["sync"]``
    set inside the block) are synchronised before the clock stops, so their
    work is included."""
    t0 = time.perf_counter()
    box = {}
    with span(name):
        try:
            yield box
        finally:
            target = box.get("sync", sync)
            for device in {t.device for t in _tensors(target) if t.is_cuda}:
                torch.cuda.synchronize(device)
            el = time.perf_counter() - t0
            rec = _REGISTRY.setdefault(name,
                                       {"n": 0, "total": 0.0, "max": 0.0})
            rec["n"] += 1
            rec["total"] += el
            rec["max"] = max(rec["max"], el)


def report(print_fn=print):
    """Print the timing table and return it as a dict."""
    out = {}
    for name, rec in sorted(_REGISTRY.items()):
        mean = rec["total"] / max(rec["n"], 1)
        out[name] = {"n": rec["n"], "total_s": rec["total"],
                     "mean_s": mean, "max_s": rec["max"]}
        print_fn(f"{name:40s} n={rec['n']:6d} total={rec['total']:9.3f}s "
                 f"mean={mean * 1e3:9.3f}ms max={rec['max'] * 1e3:9.3f}ms")
    return out


def reset():
    _REGISTRY.clear()


@contextlib.contextmanager
def trace(name="penguin", log_dir=None):
    """``torch.profiler`` trace around a block, inside
    ``record_function(name)``; yields ``log_dir`` (default:
    ``penguin_trace`` in the temporary directory) and writes the Chrome
    trace ``<log_dir>/<name>.pt.trace.json`` on exit (chrome://tracing,
    Perfetto or TensorBoard's PyTorch profiler plugin read it)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "penguin_trace")
    os.makedirs(log_dir, exist_ok=True)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                           else [])
    with profile(activities=activities) as prof:
        with record_function(name):
            yield log_dir
        if cuda:
            # the block's kernels end inside the trace
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"{name}.pt.trace.json"))


def log_every(k, print_fn=print):
    """Returns ``maybe_log(step, msg_fn)`` printing every k-th call."""
    def maybe_log(step, msg_fn):
        if step % k == 0:
            print_fn(msg_fn())
    return maybe_log


class KrylovHistory:
    """Counts matvec applications and records residual norms around an
    iterative solve — the reference's ``Solver.ch`` (log=true) analogue.

    Usage::

        hist = KrylovHistory(apply_fn)
        x, iters, relres = pcg(hist, b, x0)
        hist.record_final(b, x)        # appends ||b - Ax|| / ||b||
    """

    def __init__(self, apply_fn):
        self._apply = apply_fn
        self.n_matvec = 0
        self.residuals = []

    def __call__(self, x):
        self.n_matvec += 1
        return self._apply(x)

    def record_final(self, b, x):
        """Append and return ``||b - Ax|| / ||b||`` over every tensor of
        the state (a tensor or a tuple/list of them), in f64, read in one
        host copy."""
        bs = list(_tensors(b))
        ax = list(_tensors(self._apply(x)))
        rr = sum(((p.double() - q.double()) ** 2).sum() for p, q in zip(bs, ax))
        bb = sum((p.double() ** 2).sum() for p in bs)
        rn, bn = torch.stack([rr, bb]).sqrt().tolist()
        self.residuals.append(rn / max(bn, 1e-300))
        return self.residuals[-1]


def convergence_rates(residual_hist):
    """Per-timestep log-reduction rate of an inner Newton/GN iteration.

    ``residual_hist``: (n_steps, max_iter) with NaN past convergence (the
    layout ``StefanMono2D.solve`` records).  Returns an (n_steps,) array:
    the least-squares slope of log10(residual) per iteration (negative =
    converging; ~ -1 means 10x reduction per iteration).  Steps that
    converged within one iteration return 0.0.
    """
    H = np.asarray(residual_hist, float)
    out = np.zeros(H.shape[0])
    for k in range(H.shape[0]):
        row = H[k]
        row = row[np.isfinite(row) & (row > 0)]
        if row.size >= 2:
            x = np.arange(row.size)
            out[k] = np.polyfit(x, np.log10(row), 1)[0]
    return out
