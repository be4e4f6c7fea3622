"""CUDA graphs of the port's fixed chains of kernels.

A solver whose hot loop issues the same kernels on the same buffers every
time (FastHeatBE's CG chunks, the Picard stepper's kept block-Schur M)
captures the chain once and replays it: one launch from the host in place
of hundreds, the eager chain's kernels on the same data in the same order.
Where ``may_replay`` refuses, and on the CPU, the chain runs eagerly.
"""

from __future__ import annotations

import gc

import torch

from .diagnostics import span
from .kernels.stencil import _COUNTED


def may_replay(fields, like):
    """Whether a graph captured over tensors like ``like`` (one per field,
    all on one device) may run on ``fields``: CUDA tensors of the current
    device, of the captured shapes and dtypes, outside another capture."""
    device = like[0].device
    return (device.type == "cuda"
            and device.index == torch.cuda.current_device()
            and not torch.cuda.is_current_stream_capturing()
            and len(fields) == len(like)
            and all(f.device == device and f.dtype == t.dtype
                    and f.shape == t.shape for f, t in zip(fields, like)))


def _launches():
    return [fn.launches for fn in _COUNTED]


def _add_launches(counts, sign=1):
    for fn, n in zip(_COUNTED, counts):
        fn.launches += sign * n


def capture(fns, device, name, warm_up=None):
    """Each of ``fns`` (calls without arguments, in the order they will
    replay) captured in one new private pool, after an eager warm-up on a
    side stream (cuBLAS's handle for the stream): the calls ``warm_up``, by
    default ``fns``.  Returns a replay per call, which replays inside the
    host-only span ``name``, and what each call returned while captured.
    The stencil launches that the warm-up and the captures record come off
    the wrappers' counters; each replay adds those its graph holds."""
    replays, outputs, pool, start = [], [], None, _launches()
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for fn in warm_up or fns:
                fn()
        torch.cuda.current_stream().wait_stream(side)
        # no collection while capturing: a graph that the collector frees
        # then (a dead solver's, held in a reference cycle) ends the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            for fn in fns:
                graph, before = torch.cuda.CUDAGraph(), _launches()
                with torch.cuda.graph(graph, pool=pool):
                    outputs.append(fn())
                pool = graph.pool()
                counts = [n - m for n, m in zip(_launches(), before)]

                def replay(graph=graph, counts=counts):
                    with span(name):
                        graph.replay()
                    _add_launches(counts)
                replays.append(replay)
        finally:
            if collecting:
                gc.enable()
    _add_launches([n - m for n, m in zip(_launches(), start)], -1)
    return replays, outputs


class StaticCall:
    """``fn(leaves)``, a fixed chain of kernels from a tuple of tensors to a
    tuple, over static inputs made like ``like``: the first call that
    ``may_replay`` captures it, later ones replay it, the others run it
    eagerly.  A replay returns clones of the static outputs, which later
    calls leave alone, and a leaf ``fn`` passes through as the caller's.
    A leaf that is its own static input (from :meth:`fill`) is not copied
    again."""

    def __init__(self, fn, like, name):
        self.fn, self.name = fn, name
        self.inputs = tuple(torch.zeros_like(t) for t in like)
        self.replay = None

    def __call__(self, leaves):
        if not may_replay(leaves, self.inputs):
            return self.fn(leaves)
        if self.replay is None:
            (self.replay,), (self.outputs,) = capture(
                (lambda: self.fn(self.inputs),), self.inputs[0].device,
                self.name)
            self.passed = [next((i for i, b in enumerate(self.inputs)
                                 if out is b), None) for out in self.outputs]
        for buf, leaf in zip(self.inputs, leaves):
            if leaf is not buf:
                buf.copy_(leaf)
        self.replay()
        return tuple(out.clone() if i is None else leaves[i]
                     for out, i in zip(self.outputs, self.passed))

    def fill(self, leaves, start):
        """The static inputs from ``start`` on holding ``leaves``' values,
        for calls that pass the same leaves many times, where ``may_replay``
        allows; else ``leaves``.  Either gives ``fn`` the same values."""
        inputs = self.inputs[start:start + len(leaves)]
        if not may_replay(leaves, inputs):
            return tuple(leaves)
        for buf, leaf in zip(inputs, leaves):
            buf.copy_(leaf)
        return inputs
