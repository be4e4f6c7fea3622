"""A world of ranks for domain decomposition, and its transport.

PyTorch has no partitioner for the port's shifted-array operators, so the
decomposition is written out: each rank is a process holding one block of
every grid field, a halo exchange sends the strips its neighbours read by
point-to-point messages, and a dot product sums the ranks' partial sums
with ``all_reduce``.

``run_world`` starts the ranks with the ``spawn`` method and joins them in
a ``torch.distributed`` process group through a file store in a temporary
directory: no network is needed.

Transport.  ``nccl`` where every rank has a card of its own, ``gloo``
otherwise: NCCL refuses two ranks on one card, so ranks that share it talk
over gloo.  gloo's point-to-point takes no CUDA tensors (its sender fails
on a device pointer), so there every strip of a CUDA block, and likewise
every partial sum, goes through a host buffer (the host-staged
transport).

Ledger.  Every message is recorded in ``LEDGER``: its kind, its element
count, its bytes, its grid extent (the product of its first two axes: the
strips of fields stacked on a trailing axis count once) and the host-clock
seconds of the call that sent it.  A rank is one process, so ``LEDGER`` is
that rank's own.  It stands in for the JAX package's scan of the compiled
HLO: a dryrun resets it before the sharded step and reads it after.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["run_world", "RankContext", "halo_exchange", "all_reduce_sum",
           "exchange", "LEDGER", "Ledger", "backend_for"]


class Ledger:
    """The messages this rank sent since the last :meth:`reset`."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.messages = []     # (kind, elements, bytes, grid extent)
        self.calls = []        # (kind, seconds)
        self.seconds = {}      # kind: seconds of its calls so far

    def record(self, kind, tensor):
        extent = (tensor.shape[0] * tensor.shape[1] if tensor.dim() >= 2
                  else tensor.numel())
        self.messages.append((kind, tensor.numel(),
                              tensor.numel() * tensor.element_size(),
                              extent))

    def call(self, kind, seconds):
        """One call that sent ``kind``'s messages took ``seconds``."""
        self.calls.append((kind, seconds))
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds

    def totals(self):
        """{kind: {"calls", "messages", "elements", "bytes", "seconds"}}."""
        out = {}
        for kind, seconds in self.calls:
            row = out.setdefault(kind, dict(calls=0, messages=0, elements=0,
                                            bytes=0, seconds=0.0))
            row["calls"] += 1
            row["seconds"] += seconds
        for kind, elements, nbytes, _ in self.messages:
            row = out[kind]
            row["messages"] += 1
            row["elements"] += elements
            row["bytes"] += nbytes
        return out

    def largest(self, exclude=()):
        """Grid extent of the largest message (0 if none), leaving out the
        kinds in ``exclude``."""
        return max((m[3] for m in self.messages if m[0] not in exclude),
                   default=0)


LEDGER = Ledger()


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What ``run_world`` hands each rank's function."""
    rank: int
    world: int
    device: torch.device


def backend_for(device, n_ranks):
    """``"nccl"`` where every rank has its own card, ``"gloo"`` where the
    ranks run on the CPU or share a card; raises on any other device."""
    if device.type == "cpu":
        return "gloo"
    if device.type == "cuda":
        return "nccl" if torch.cuda.device_count() >= n_ranks else "gloo"
    raise ValueError(f"no transport for ranks on {device}")


def _host_staged(t):
    return t.is_cuda and dist.get_backend() == "gloo"


def _sync_if_staged(t):
    # a host-staged exchange waits for the card at its first copy anyway:
    # waiting first keeps the queued compute out of its seconds
    if _host_staged(t):
        torch.cuda.synchronize(t.device)


def _exchange_axis(x, grid, axis, width):
    n = x.shape[axis]
    if width > n:
        raise ValueError(f"halo width {width} exceeds the block's {n} cells "
                         f"along axis {axis}")
    staged = _host_staged(x)
    strip_shape = list(x.shape)
    strip_shape[axis] = width
    ops, received = [], {}
    for side, start in ((-1, 0), (1, n - width)):
        peer = grid.neighbour(axis, side)
        if peer is None:
            continue
        strip = x.narrow(axis, start, width).contiguous()
        if staged:
            strip = strip.cpu()
        buf = torch.empty(strip_shape, dtype=x.dtype, device=strip.device)
        ops += [dist.P2POp(dist.isend, strip, peer),
                dist.P2POp(dist.irecv, buf, peer)]
        received[side] = buf
        LEDGER.record("halo", strip)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    parts = []
    for side in (-1, 1):
        buf = received.get(side)
        parts.append(torch.zeros(strip_shape, dtype=x.dtype, device=x.device)
                     if buf is None else buf.to(x.device))
    return torch.cat([parts[0], x, parts[1]], dim=axis)


def halo_exchange(block, grid, width):
    """``block`` grown by ``width`` cells on each side of axes 0 and 1, the
    new cells holding the neighbouring ranks' values.

    ``grid`` is the rank grid (``sharding.GridMesh``).  Axis 0 is exchanged
    first, then axis 1 on the grown array, so the corner cells arrive with
    the second phase and no diagonal message is needed.  Where a side has
    no neighbour the new cells are zero: what the whole-grid ``_shift_m``
    and ``_shift_p`` read past the grid's edge.  Each phase is one
    ``batch_isend_irecv``; under gloo a CUDA block's strips go through host
    buffers."""
    _sync_if_staged(block)
    t0 = time.perf_counter()
    out = block
    for axis in (0, 1):
        out = _exchange_axis(out, grid, axis, width)
    LEDGER.call("halo", time.perf_counter() - t0)
    return out


def all_reduce_sum(t, kind="all_reduce"):
    """The sum of ``t`` over the ranks, as a new tensor on ``t``'s device
    (through a host buffer under gloo), recorded under ``kind``."""
    _sync_if_staged(t)
    t0 = time.perf_counter()
    buf = t.detach().to("cpu" if _host_staged(t) else t.device, copy=True)
    dist.all_reduce(buf)
    LEDGER.record(kind, buf)
    out = buf.to(t.device)
    LEDGER.call(kind, time.perf_counter() - t0)
    return out


def exchange(sends, shape, dtype, device, kind):
    """Point-to-point messages: ``sends`` maps a peer rank to the tensor it
    gets from this one, and each of those peers sends one tensor of
    ``shape`` back.  Returns {peer: received tensor on ``device``}, in one
    ``batch_isend_irecv`` recorded under ``kind`` (host-staged under gloo,
    as the halo strips are)."""
    t0 = time.perf_counter()
    staged = device.type == "cuda" and dist.get_backend() == "gloo"
    if staged:
        torch.cuda.synchronize(device)
    ops, received = [], {}
    for peer, t in sends.items():
        t = t.contiguous()
        if staged:
            t = t.cpu()
        buf = torch.empty(shape, dtype=dtype, device=t.device)
        ops += [dist.P2POp(dist.isend, t, peer),
                dist.P2POp(dist.irecv, buf, peer)]
        received[peer] = buf
        LEDGER.record(kind, t)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = {peer: buf.to(device) for peer, buf in received.items()}
    LEDGER.call(kind, time.perf_counter() - t0)
    return out


def _rank_main(fn, rank, n_ranks, device, backend, init, timeout_s, args,
               results, later):
    """One rank: join the group, take the rest of its arguments from
    ``later`` (if not None), run ``fn``, report to the parent."""
    try:
        device = torch.device(device)
        if device.type == "cuda":
            if backend == "nccl":
                device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=n_ranks,
            timeout=datetime.timedelta(seconds=timeout_s))
        if later is not None:
            args = args + later.get(timeout=timeout_s)
        out = fn(RankContext(rank, n_ranks, device), *args)
        msg = (rank, None, out if rank == 0 else None)
    except Exception:  # reported to the parent, which raises it
        msg = (rank, traceback.format_exc(), None)
    results.put(msg)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_world(fn, n_ranks, device, *args, timeout_s=120, later=None):
    """Run ``fn(RankContext, *args)`` on ``n_ranks`` ranks, each a process,
    and return rank 0's result.

    ``later``: a callable run here once the ranks are started; the tuple it
    returns is appended to ``args``.  The ranks start, import and join the
    group meanwhile, and wait for it before ``fn`` runs.

    ``fn`` and ``args`` go to ``spawn`` children, so ``fn`` must be
    importable from the package, and what it returns must pickle (numpy,
    not CUDA tensors).  Ranks on the CPU run one thread each.  On CUDA each
    rank takes its own card under NCCL, or the given card under gloo.  An
    exception on any rank, a rank that dies, or a run longer than
    ``timeout_s`` (which also bounds every collective) raises here, after
    every rank is stopped."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    backend = backend_for(device, n_ranks)
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory(prefix="penguin-world-") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        rest = None if later is None else ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, rank, n_ranks, str(device), backend,
                                   init, timeout_s, args, results, rest))
                 for rank in range(n_ranks)]
        for p in procs:
            p.start()
        try:
            if later is not None:
                extra = later()
                for _ in procs:
                    rest.put(extra)
            out = _collect(results, procs, deadline)
            for p in procs:     # reported; only the group's teardown is left
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            if rest is not None:
                # what a killed rank left unread must not hold this process
                rest.cancel_join_thread()
    return out


def _collect(results, procs, deadline):
    """Rank 0's result once every rank reported success; raises on the
    first failure, on a rank that died without reporting, or at the
    deadline."""
    pending = set(range(len(procs)))
    out = None
    while pending:
        if time.monotonic() > deadline:
            raise TimeoutError(f"ranks {sorted(pending)} did not finish "
                               "within the world's deadline")
        try:
            rank, error, value = results.get(timeout=1.0)
        except queue.Empty:
            dead = [r for r in pending
                    if not procs[r].is_alive() and procs[r].exitcode != 0]
            if dead:
                raise RuntimeError(
                    f"rank {dead[0]} died (exit code "
                    f"{procs[dead[0]].exitcode}) without reporting")
            continue
        if error is not None:
            raise RuntimeError(f"rank {rank} failed:\n{error}")
        pending.discard(rank)
        if rank == 0:
            out = value
    return out
