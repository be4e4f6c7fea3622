"""Multi-rank domain decomposition (torch counterpart of
``penguin_tpu.parallel.sharding``).

The JAX module places the padded DOF arrays on an ('x','y') device mesh and
lets GSPMD turn each ±1 shift into a halo exchange and each Krylov dot into
a ``psum``.  PyTorch has no partitioner for shifted-array code: a DTensor
sharded along the axis that ``_shift_m``/``_shift_p`` pad and narrow is
redistributed to a replicated tensor, the grid-sized all-gather that the
JAX gates forbid, and the stencil kernel takes raw pointers, not DTensors.
So the decomposition is written out, over the transport of ``_comm``:

- the rank grid (``make_grid_mesh``) has the shape ``_factor2(world)``
  with dims ('x', 'y'); ``grid_sharding`` splits grid axis 0 over 'x' and
  axis 1 over 'y', one block per rank, and ``padded_mesh`` grows the inert
  padding until the DOF grid divides;
- an operator of reach R runs on a rank's *window*, its block grown by R
  cells and clipped at the grid's edges.  The fields are grown by a halo
  exchange; the static data are cut from the whole grid's once (a
  *windowed view*), or rebuilt on a window ``Mesh``.  The window's own
  interior edges read zeros where the whole grid reads neighbours, and the
  cells that reach them are cropped; at the grid's edges the window edge
  *is* the grid edge, so ``_zlast`` and the shifts act as on the whole
  grid;
- a Krylov dot is the block's dot summed over the ranks (``_comm``'s
  ``all_reduce_sum``), so every rank takes the same branch at every host
  read.

Six dryruns run a solver this way and hold it to the unsharded run, as
the JAX module's do: the heat step (the CG matvec is the CUDA stencil
kernel on each rank's halo-extended block), the Stokes apply, the
moving-geometry step, the Navier-Stokes CN/AB2 pgmres steps and the
implicit-Picard fgmres steps with the block-Schur M (its sums over the
ranks, its DCT reduce-scattered along the rank grid: ``_RankGrid``), and
the Stefan front-tracking step (markers replicated, the slab capacity
rebuilt on each window, the normal equations summed over the ranks).  In
place of JAX's scan of the compiled HLO they read ``_comm.LEDGER``: no
message may carry a grid-sized array (the Stefan normal equations, of
nm(nm+1)+1 elements, have a kind and a bound of their own).

A rank grid is a world of processes (``_comm.run_world``): on the CPU over
gloo; on one card, every rank on that card over gloo; on one card per rank,
over NCCL.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import geometry, linsolve
from .._device import resolve_device
from ..assembly import border_info
from ..boundary import (
    BorderConditions,
    Dirichlet,
    FluxJump,
    InterfaceConditions,
    Outflow,
    ScalarJump,
)
from ..capacity import compute_capacity, compute_capacity_spacetime
from ..front_tracking import FrontTracker
from ..kernels.stencil import stencil5_matvec, stencil7_matvec
from ..mesh import Mesh
from ..operators import make_diffusion_ops
from ..phase import Fluid, Phase
from ..solvers import stefan2d
from ..solvers.heat_fast import CG_CHUNK, FastHeatBE
from ..solvers.moving_diffusion import (
    _num_slabs,
    _reduced_slab,
    build_moving_mono_system,
    moving_mono_diag,
    solve_moving_mono_step,
)
from ..solvers.navierstokes import NavierStokesMono
from ..solvers.stokes import (
    PinPressureGauge,
    StokesMono,
    _along,
    _dct2_matrix,
)
from ._comm import LEDGER, all_reduce_sum, exchange, halo_exchange, run_world

# the JAX module's names; ``dryrun_multichip`` stands for
# ``__graft_entry__.dryrun_multichip``
__all__ = ["make_grid_mesh", "grid_sharding", "shard_pytree", "padded_mesh",
           "dryrun_heat_multichip", "dryrun_stokes_multichip",
           "dryrun_moving_multichip", "dryrun_stefan_multichip",
           "dryrun_ns_multichip", "dryrun_ns_picard_multichip"]


def _factor2(n):
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return max(a, 1), n // max(a, 1)


class GridMesh:
    """A 2D grid of ranks with axes ('x', 'y'): ``devices`` is the (a, b)
    array of ranks, ``rank`` this process's rank and ``coords`` its place
    in the grid (None if it is not in the grid).

    The port's own class: ``torch.distributed.DeviceMesh`` needs a live
    process group, where the grid's shape is also wanted without one (to
    pad a mesh), and it carries nothing that the halo exchange uses."""

    axis_names = ("x", "y")

    def __init__(self, devices, rank=0):
        self.devices = np.asarray(devices).reshape(_factor2(len(devices)))
        self.rank = int(rank)
        hit = np.argwhere(self.devices == self.rank)
        self.coords = tuple(int(v) for v in hit[0]) if len(hit) else None

    @property
    def shape(self):
        return self.devices.shape

    def neighbour(self, axis, step):
        """The rank ``step`` places along ``axis`` from this one, or None
        past the grid's edge."""
        c = list(self.coords)
        c[axis] += step
        if not 0 <= c[axis] < self.devices.shape[axis]:
            return None
        return int(self.devices[tuple(c)])


def make_grid_mesh(n_devices=None, devices=None):
    """The rank grid with axes ('x', 'y') for domain decomposition: the
    ranks of the running world (or ``devices``), the first ``n_devices`` of
    them if given.  Without a world, ``n_devices`` ranks with this process
    as rank 0 (enough to size a padded mesh)."""
    live = dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = list(range(dist.get_world_size() if live
                             else (n_devices or 1)))
    if n_devices is not None:
        devices = list(devices)[:n_devices]
    return GridMesh(devices, dist.get_rank() if live else 0)


@dataclasses.dataclass(frozen=True)
class GridSharding:
    """Grid axis 0 split over the rank grid's 'x', axis 1 over 'y'; higher
    axes whole.  ``block(shape)`` is this rank's part of a grid of
    ``shape``, ``window(shape, width)`` that block grown by ``width`` cells
    and clipped at the grid's edges."""
    mesh: GridMesh
    ndim: int = 2

    def block(self, shape):
        out = []
        for axis in range(min(self.ndim, 2)):
            parts = self.mesh.shape[axis]
            if shape[axis] % parts:
                raise ValueError(
                    f"grid axis {axis} of {shape[axis]} slots does not "
                    f"divide over {parts} ranks: build the mesh with "
                    "padded_mesh")
            size = shape[axis] // parts
            lo = self.mesh.coords[axis] * size
            out.append(slice(lo, lo + size))
        return tuple(out)

    def window(self, shape, width):
        return tuple(slice(max(0, s.start - width),
                           min(shape[a], s.stop + width))
                     for a, s in enumerate(self.block(shape)))


def grid_sharding(mesh, ndim=2):
    """Grid axis 0 over 'x' and axis 1 over 'y'; higher axes whole."""
    return GridSharding(mesh, ndim)


def padded_mesh(dev_mesh, n, domain_size, x0=None):
    """A ``penguin_tpu_torch.Mesh`` whose DOF shape divides by the rank
    grid: the per-axis inert padding (normally 1 slot) grows to the next
    multiple of the rank-grid axis.  The extra slots carry zero capacities
    and become identity rows, so the physics on the ``n`` real cells is
    unchanged."""
    dev_shape = dev_mesh.devices.shape
    pad = []
    for d in range(len(n)):
        ax = dev_shape[d] if d < len(dev_shape) else 1
        p = 1
        while (n[d] + p) % ax:
            p += 1
        pad.append(p)
    return Mesh(n, domain_size, x0, pad=tuple(pad))


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def shard_pytree(tree, sharding):
    """This rank's block of every tensor leaf of rank >= 2 of a tree
    (tensors in tuples, lists, dicts and dataclasses); lower-rank leaves
    are kept whole, as the JAX version replicates them."""
    return _tree_map(lambda t: t[sharding.block(t.shape)].contiguous()
                     if t.dim() >= 2 else t, tree)


def _unshard(block, sharding, shape):
    """The whole grid on rank 0 (numpy; None on the others), gathered from
    every rank's block.  For the checks only: it runs outside the ledger's
    window of a step."""
    mine = (sharding.block(shape), block.detach().cpu().numpy())
    parts = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(mine, parts, dst=0)
    if parts is None:
        return None
    out = np.zeros(tuple(shape) + mine[1].shape[2:], mine[1].dtype)
    for index, values in parts:
        out[index] = values
    return out


# ---------------------------------------------------------------------------
# windows
# ---------------------------------------------------------------------------

def _windowed(obj, index, shape, memo=None):
    """``obj`` with every tensor whose two leading axes have the grid's
    ``shape`` cut to ``index``, through tuples, lists, dicts and the port's
    own objects (copied, never changed); anything else is shared."""
    memo = {} if memo is None else memo
    if id(obj) in memo:
        return memo[id(obj)]
    if isinstance(obj, torch.Tensor):
        out = obj[index] if tuple(obj.shape[:2]) == tuple(shape) else obj
    elif isinstance(obj, (tuple, list)):
        out = type(obj)(_windowed(v, index, shape, memo) for v in obj)
    elif isinstance(obj, dict):
        out = {k: _windowed(v, index, shape, memo) for k, v in obj.items()}
    elif (type(obj).__module__.startswith("penguin_tpu_torch.")
          and hasattr(obj, "__dict__")):
        out = copy.copy(obj)
        for k, v in vars(obj).items():
            object.__setattr__(out, k, _windowed(v, index, shape, memo))
    else:
        out = obj
    memo[id(obj)] = out
    return out


def windowed_stokes(solver, index):
    """A view of a whole-grid ``StokesMono`` or ``NavierStokesMono`` on the
    window ``index``: every grid-shaped tensor it reads cut to the window
    (the border, pin, outflow-plane and convection-outlet masks with the
    rest).  An operator of the view, on the window of each field, equals
    the whole one on the cells at least its reach inside the window's
    interior edges.

    The pin gauge's mask is cut like any other, so it stays with the rank
    whose window holds the pinned cell.  Pieces that index the whole grid
    are refused: ghost cut rows (flat global positions), the mean gauge (a
    sum over the grid) and periodic axes (a wrap across it)."""
    if any(g is not None for g in solver._ghost):
        raise ValueError(
            "a windowed view of StokesMono with ghost cut rows "
            "(cut_row='ghost') is not ported: its rows index flat global "
            "positions, and no JAX dryrun exercises them (ROADMAP Queue 1 "
            "item 17)")
    if solver.mean_w is not None:
        raise ValueError("a windowed view needs the pin or outflow gauge: "
                         "the mean gauge sums over the whole grid")
    per = solver.fluid.operator_p.periodic
    if per is not None and any(per):
        raise ValueError("a windowed view cannot wrap a periodic axis")
    return _windowed(solver, index, tuple(solver.fluid.capacity_p.V.shape))


def _halo_width(apply, fields, period=8):
    """The halo a window needs for a linear ``apply``: its reach (the
    widest support, in cells, of its response to unit impulses in its input
    fields) plus one.  The impulses form a comb of ``period`` cells on every
    offset, in every field at once (weighted apart, so that no two fields'
    responses cancel), so each cell, cut or not, is probed, and a response
    is told to the nearest impulse while the reach stays under half the
    period.  The one is the window's edge slot: ``_zlast`` reads a window's
    last slot as the grid's inert padding, and a rebuilt capacity's first
    slot sees no cell below it, so that slot is wrong before the operator
    carries it ``reach`` cells in."""
    shape = fields[0].shape[:2]
    device = fields[0].device
    reach = 0
    for a in range(period):
        for b in range(period):
            comb = torch.zeros(shape, dtype=torch.bool, device=device)
            comb[a::period, b::period] = True
            x = tuple(comb.to(f.dtype) / (i + 1.2345)
                      for i, f in enumerate(fields))
            for y in apply(x):
                hit = torch.nonzero(y != 0)[:, :2].cpu()
                if not len(hit):
                    continue
                d = (hit - torch.tensor([a, b])) % period
                d = torch.minimum(d, period - d)
                reach = max(reach, int(d.max()))
    if 2 * reach >= period:
        return _halo_width(apply, fields, 2 * period)
    return reach + 1


def _extend(block, sharding, width, shape):
    """``block`` grown to its window of ``width``: the halo exchange, with
    the strips past the grid's edges cut off."""
    x = halo_exchange(block, sharding.mesh, width)
    for axis, (b, w) in enumerate(zip(sharding.block(shape),
                                      sharding.window(shape, width))):
        x = x.narrow(axis, width - (b.start - w.start), w.stop - w.start)
    return x


def _crop(x, sharding, width, shape):
    """The block's part of a window-shaped ``x``."""
    for axis, (b, w) in enumerate(zip(sharding.block(shape),
                                      sharding.window(shape, width))):
        x = x.narrow(axis, b.start - w.start, b.stop - b.start)
    return x.contiguous()


def _with_margin(t, sharding, width):
    """``t``'s block grown by ``width`` cells of the whole ``t``, zeros past
    the grid's edges: static data a halo would bring, cut once."""
    pad = [0, 0] * (t.dim() - 2) + [width, width, width, width]
    grown = F.pad(t, pad)
    index = tuple(slice(s.start, s.stop + 2 * width)
                  for s in sharding.block(t.shape))
    return grown[index].contiguous()


def _grow(x, sharding, width, shape):
    """A block, or a tuple of blocks of one shape, grown to the window of
    ``width``: one halo exchange (a tuple is stacked on a trailing axis,
    which the exchange keeps)."""
    if isinstance(x, torch.Tensor):
        return _extend(x, sharding, width, shape)
    return tuple(_extend(torch.stack(tuple(x), -1), sharding, width, shape)
                 .unbind(-1))


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _grid_messages(shape, exempt=()):
    """Messages of the ledger (outside ``exempt``) whose grid extent
    reaches the grid's cell count: the port's count of JAX's grid-sized
    all-gathers."""
    cells = math.prod(shape)
    return sum(1 for kind, _, _, extent in LEDGER.messages
               if kind not in exempt and extent >= cells)


def _check_no_grid_message(label, shape, bounds=None):
    """No message of the ledger reaches the grid's cell count; ``bounds``
    ({kind: elements}) holds a kind's messages to a bound of their own
    instead."""
    bounds = bounds or {}
    big = LEDGER.largest(exclude=tuple(bounds))
    _check(_grid_messages(shape, tuple(bounds)) == 0,
           f"{label}: a message of grid extent {big}, not under the grid's "
           f"{math.prod(shape)} cells")
    for kind, bound in bounds.items():
        big = max((n for k, n, _, _ in LEDGER.messages if k == kind),
                  default=0)
        _check(big <= bound, f"{label}: a {kind} message of {big} elements, "
               f"over its bound {bound}")


class _RankGrid:
    """One rank's global operations for a decomposed solve: the private
    ``_rank`` of ``StokesMono.make_block_preconditioner`` (the counterpart
    of ``stokes._WholeGrid``), and the grow/crop of the flow and Stefan
    dryruns.  Its fields are the rank's window of ``width``: ``grow`` brings
    a block's halo, ``fresh`` renews it before a stencil; a sum runs over
    the block and then over the ranks (one reduction for any number of
    sums); the DCT is reduce-scattered along the rank grid."""

    def __init__(self, sharding, shape, width):
        self.sharding = sharding
        self.shape = tuple(shape)
        self.width = width
        # a reach-1 stencil leaves the window's far slot and one cell more
        # per sweep wrong: the block stays exact for width - 1 sweeps
        self.depth = width - 1
        self._block = sharding.block(self.shape)
        self._window = sharding.window(self.shape, width)

    def grow(self, x):
        return _grow(x, self.sharding, self.width, self.shape)

    def crop(self, x):
        if isinstance(x, torch.Tensor):
            return _crop(x, self.sharding, self.width, self.shape)
        return tuple(self.crop(t) for t in x)

    def fresh(self, x):
        return self.grow(self.crop(x))

    def _in_window(self, d, n):
        start = self._block[d].start - self._window[d].start
        return slice(start, start + n)

    def pad(self, t):
        """A block in its window, zeros in the halo."""
        shape = tuple(w.stop - w.start for w in self._window) + t.shape[2:]
        out = t.new_zeros(shape)
        out[self._in_window(0, t.shape[0]), self._in_window(1, t.shape[1])] = t
        return out

    def sum(self, *ts):
        local = torch.stack([torch.sum(self.crop(t)) for t in ts])
        return tuple(all_reduce_sum(local).unbind())

    def dot_norm(self, a, w):
        aw, ww = self.sum(a * w, w * w)
        return aw, torch.sqrt(ww)

    def index(self, d, **like):
        w = self._window[d]
        return torch.arange(w.start, w.stop, **like)

    def _core_range(self, d, coord, n):
        size = self.shape[d] // self.sharding.mesh.shape[d]
        return range(min(coord * size, n), min((coord + 1) * size, n))

    def core_index(self, d, n, **like):
        r = self._core_range(d, self.sharding.mesh.coords[d], n)
        return torch.arange(r.start, r.stop, **like)

    def core(self, ncell):
        return tuple(self._in_window(d, len(self._core_range(
            d, self.sharding.mesh.coords[d], n))) for d, n in enumerate(ncell))

    def pad_core(self, sc, shape):
        return self.pad(sc)      # ``shape`` is the window's

    def along(self, M, x, d):
        """``M`` (the whole transform) along axis d of the whole core, of
        which ``x`` is this rank's part: each rank forms its columns'
        product for every rank along axis d and sends it there, one block a
        message (kind ``"dct"``), and sums what it gets in rank order."""
        grid = self.sharding.mesh
        me = grid.coords[d]
        n = M.shape[0]
        mine = self._core_range(d, me, n)
        own, sends, peers = None, {}, {}
        for c in range(grid.shape[d]):
            rows = self._core_range(d, c, n)
            part = _along(M[rows.start:rows.stop, mine.start:mine.stop], x, d)
            if c == me:
                own = part
            elif len(rows) and len(mine) and x.numel():
                peers[c] = grid.neighbour(d, c - me)
                sends[peers[c]] = part
        got = exchange(sends, own.shape, x.dtype, x.device, "dct")
        total = None
        for c in range(grid.shape[d]):
            part = own if c == me else got.get(peers.get(c))
            if part is not None:
                total = part if total is None else total + part
        return total


class _Spans:
    """Host seconds spent inside wrapped calls, the device synchronised at
    both ends, and the ledger's seconds by kind inside them."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.seconds, self.calls, self.ledger = {}, {}, {}

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def wrap(self, key, fn):
        def run(*args, **kw):
            self._sync()
            t0, l0 = time.perf_counter(), _ledger_seconds()
            out = fn(*args, **kw)
            self._sync()
            self.seconds[key] = (self.seconds.get(key, 0.0)
                                 + time.perf_counter() - t0)
            self.calls[key] = self.calls.get(key, 0) + 1
            led = self.ledger.setdefault(key, {})
            for kind, sec in _ledger_seconds().items():
                led[kind] = led.get(kind, 0.0) + sec - l0.get(kind, 0.0)
            return out
        return run


def _launches(since=None):
    """The stencil kernels' launch counts, less ``since``'s."""
    now = {"stencil5_matvec": stencil5_matvec.launches,
           "stencil7_matvec": stencil7_matvec.launches}
    return now if since is None else {k: v - since[k] for k, v in now.items()}


def _ledger_seconds():
    return dict(LEDGER.seconds)


class _Clock:
    """Milliseconds of the work between ``start`` and ``stop``: CUDA events
    on a card, the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def start(self):
        if self.cuda:
            self._a = torch.cuda.Event(enable_timing=True)
            self._b = torch.cuda.Event(enable_timing=True)
            self._a.record()
        else:
            self._t = time.perf_counter()

    def stop(self):
        if self.cuda:
            self._b.record()
            self._b.synchronize()
            return self._a.elapsed_time(self._b)
        return (time.perf_counter() - self._t) * 1e3


# ---------------------------------------------------------------------------
# the heat step
# ---------------------------------------------------------------------------

def _heat_setup(dev_mesh, grid, device, maxiter):
    """The JAX dryrun's problem: the flagship circle, BE at dt = 0.25 h²,
    f32, on the padded mesh."""
    nx, ny = grid
    mesh = padded_mesh(dev_mesh, (nx, ny), (4.0, 4.0), (0.0, 0.0))
    cap = compute_capacity(geometry.circle((2.0, 2.0), 1.0), mesh, p=4, s=1,
                           dtype=torch.float32, device=device)
    bc0 = Dirichlet(0.0)
    bc_b = BorderConditions({k: bc0 for k in ("left", "right", "top",
                                              "bottom")})
    return FastHeatBE(cap, make_diffusion_ops(cap), 1.0,
                      lambda x, y, z, t: 0.0, Dirichlet(1.0), bc_b,
                      0.25 * (4.0 / nx) ** 2, cg_tol=1e-5,
                      cg_maxiter=maxiter, dtype=torch.float32)


def _heat_block(fast, sharding):
    """One rank's copy of a ``FastHeatBE``: its arrays cut to the rank's
    block, the CG's matvec a one-cell halo exchange and the 5-point stencil
    (the CUDA kernel on a card) on the grown block, its dots summed over the
    ranks.  The coefficients are static: their one-cell halo is cut from
    the whole grid's once."""
    index = sharding.block(fast._Va.shape)
    grid = sharding.mesh
    blk = copy.copy(fast)
    blk._coeffs = tuple(_with_margin(c, sharding, 1) for c in fast._coeffs)
    blk._dinv, blk._Va, blk._rhs, blk.Tg, blk.active = (
        a[index].contiguous() for a in (fast._dinv, fast._Va, fast._rhs,
                                        fast.Tg, fast.active))

    def matvec(coeffs, x):
        y = stencil5_matvec(*coeffs, halo_exchange(x, grid, 1))
        return y[1:-1, 1:-1].contiguous()

    blk._cg_matvec = matvec
    blk._cg_dot = lambda a, b: all_reduce_sum(linsolve._tdot(a, b))
    return blk


def _cg_loops(k):
    """CG loop iterations ``_cg`` runs for ``k`` active ones: whole chunks,
    at least one."""
    return CG_CHUNK * max(1, math.ceil(k / CG_CHUNK))


def _halo_elements(grid, block_shape, width):
    """Elements this rank sends in one halo exchange of a block."""
    bx, by = block_shape
    n0 = sum(grid.neighbour(0, s) is not None for s in (-1, 1))
    n1 = sum(grid.neighbour(1, s) is not None for s in (-1, 1))
    return width * (n0 * by + n1 * (bx + 2 * width))


def _heat_whole(dev_mesh, device, grid, steps=1, maxiter=16, timed=False):
    fast = _heat_setup(dev_mesh, grid, device, maxiter)
    T0 = torch.zeros(fast._Va.shape, dtype=torch.float32, device=device)
    states, counts = [], []
    for T, k in fast._steps(T0, steps):
        states.append(T.cpu().numpy())
        counts.append(int(k))
    ref = dict(states=states, counts=counts)
    if timed:
        clock = _Clock(device)
        fast.step(T0)
        clock.start()
        fast.step(T0)
        ref["ms_per_iteration"] = clock.stop() / (1 + _cg_loops(counts[0]))
    return ref


def _heat_rank(ctx, sharding, spec, ref):
    fast = _heat_setup(sharding.mesh, spec["grid"], ctx.device,
                       spec.get("maxiter", 16))
    shape = tuple(fast._Va.shape)
    index = sharding.block(shape)
    blk = _heat_block(fast, sharding)
    del fast
    T0 = torch.zeros_like(blk._Va)
    launched = stencil5_matvec.launches
    LEDGER.reset()
    states, counts = [], []
    for T, k in blk._steps(T0, spec.get("steps", 1)):
        states.append(T)
        counts.append(int(k))
    launched = stencil5_matvec.launches - launched
    totals = LEDGER.totals()
    _check_no_grid_message("heat", shape)
    _check(counts == ref["counts"],
           f"heat: CG counts {counts} on rank {ctx.rank}, the whole run's "
           f"{ref['counts']}")
    err = max(float(np.abs(T.cpu().numpy() - R[index]).max())
              for T, R in zip(states, ref["states"]))
    _check(err < 1e-5, f"heat: sharded vs whole mismatch {err} on rank "
           f"{ctx.rank}")
    # the traffic the decomposition implies: one halo exchange of the
    # block's perimeter per matvec, one scalar all-reduce per dot (three
    # before the loop, three per loop iteration)
    loops = sum(_cg_loops(k) for k in counts)
    halo, red = totals["halo"], totals["all_reduce"]
    per_call = _halo_elements(sharding.mesh, blk._Va.shape, 1)
    _check(halo["calls"] == len(counts) + loops
           and halo["elements"] == halo["calls"] * per_call,
           f"heat: {halo} halo traffic, not {len(counts) + loops} exchanges "
           f"of {per_call} elements")
    _check(red["calls"] == 3 * (len(counts) + loops)
           and red["elements"] == red["calls"],
           f"heat: {red} all-reduces, not one scalar per dot")
    report = dict(err=err, counts=counts, launches=launched, ledger=totals,
                  largest=LEDGER.largest(),
                  halo_elements_per_exchange=per_call,
                  T=_unshard(states[0], sharding, shape))
    if spec.get("timed"):
        clock = _Clock(ctx.device)
        blk.step(T0)                      # warm
        LEDGER.reset()
        clock.start()
        _, k = blk.step(T0)
        ms = clock.stop()
        iters = 1 + _cg_loops(int(k))
        t = LEDGER.totals()
        report["timing"] = dict(
            ms_per_iteration=ms / iters,
            halo_ms_per_iteration=t["halo"]["seconds"] * 1e3 / iters,
            all_reduce_ms_per_iteration=(t["all_reduce"]["seconds"] * 1e3
                                         / iters),
            bytes_per_iteration=(t["halo"]["bytes"]
                                 + t["all_reduce"]["bytes"]) / iters)
    return report


# ---------------------------------------------------------------------------
# the Stokes apply
# ---------------------------------------------------------------------------

def _stokes_setup(dev_mesh, grid, device):
    """The JAX dryrun's lid cavity on ``full_domain`` (f32), and its five
    key fields."""
    nx, ny = grid
    L = 1.0
    d = L / nx
    meshes = [padded_mesh(dev_mesh, (nx, ny), (L, L), x0)
              for x0 in ((-0.5 * d, 0.0), (0.0, -0.5 * d), (0.0, 0.0))]
    body = geometry.full_domain(2)
    caps = [compute_capacity(body, m, p=4, s=1, dtype=torch.float32,
                             device=device) for m in meshes]
    ops = [make_diffusion_ops(c) for c in caps]
    fluid = Fluid(mesh_u=(meshes[0], meshes[1]), mesh_p=meshes[2],
                  capacity_u=(caps[0], caps[1]), operator_u=(ops[0], ops[1]),
                  capacity_p=caps[2], operator_p=ops[2], mu=1.0, rho=1.0,
                  f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0)
    noslip, lid = Dirichlet(0.0), Dirichlet(1.0)
    bc_ux = BorderConditions({"left": noslip, "right": noslip,
                              "bottom": noslip, "top": lid})
    bc_uy = BorderConditions({k: noslip for k in ("left", "right", "bottom",
                                                  "top")})
    solver = StokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                        Dirichlet(0.0))
    shape = meshes[2].np_shape
    ramp = torch.arange(float(math.prod(shape)), dtype=torch.float64,
                        device=device).reshape(shape)
    fields = tuple(torch.sin(ramp * (0.01 * (i + 1))).to(torch.float32)
                   for i in range(5))
    return solver, fields


def _stokes_whole(dev_mesh, device, grid):
    solver, fields = _stokes_setup(dev_mesh, grid, device)
    out = solver.apply_steady(fields)
    return dict(out=[o.cpu().numpy() for o in out],
                halo=_halo_width(solver.apply_steady, fields))


def _stokes_rank(ctx, sharding, spec, ref):
    solver, fields = _stokes_setup(sharding.mesh, spec["grid"], ctx.device)
    shape = tuple(fields[0].shape)
    R = ref["halo"]
    index = sharding.block(shape)
    view = windowed_stokes(solver, sharding.window(shape, R))
    blocks = [f[index].contiguous() for f in fields]
    del solver, fields
    LEDGER.reset()
    out = view.apply_steady(tuple(_extend(b, sharding, R, shape)
                                  for b in blocks))
    out = [_crop(o, sharding, R, shape) for o in out]
    totals = LEDGER.totals()
    _check_no_grid_message("stokes", shape)
    err = max(float(np.abs(o.cpu().numpy() - r[index]).max())
              for o, r in zip(out, ref["out"]))
    _check(err < 1e-5, f"stokes: sharded vs whole apply mismatch {err} on "
           f"rank {ctx.rank}")
    return dict(err=err, halo=R, ledger=totals, largest=LEDGER.largest(),
                out=[_unshard(o, sharding, shape) for o in out])


# ---------------------------------------------------------------------------
# the moving-geometry step
# ---------------------------------------------------------------------------

def _moving_body(x, y, t):
    return torch.sqrt((x - (2.0 + 0.5 * t)) ** 2 + (y - 2.0) ** 2) - 1.0


_MOVING_DT = 0.1
_MOVING_TOL = 1e-10


def _moving_setup(dev_mesh, grid, device):
    """The JAX dryrun's padded mesh and its Dirichlet-0 borders (f64)."""
    mesh = padded_mesh(dev_mesh, tuple(grid), (4.0, 4.0), (0.0, 0.0))
    bc0 = Dirichlet(0.0)
    border = border_info(mesh, BorderConditions(
        {k: bc0 for k in ("left", "right", "top", "bottom")}), device=device)
    return mesh, border


def _moving_capacity(mesh, device):
    return compute_capacity_spacetime(_moving_body, mesh, 0.0, _MOVING_DT,
                                      p=4, s=1, device=device)


def _zero_source(*args):
    return 0.0


def _moving_whole(dev_mesh, device, grid):
    mesh, border = _moving_setup(dev_mesh, grid, device)
    cap = _moving_capacity(mesh, device)
    x0 = tuple(torch.zeros(mesh.np_shape, dtype=torch.float64, device=device)
               for _ in range(2))
    x, iters, _ = solve_moving_mono_step(
        cap, 1.0, _zero_source, Dirichlet(1.0), border, x0, 0.0, _MOVING_DT,
        "BE", tol=_MOVING_TOL)
    apply = _reduced_slab(cap, 1.0, _zero_source, Dirichlet(1.0), border, x0,
                          0.0, _MOVING_DT)[0]
    return dict(x=[v.cpu().numpy() for v in x], iters=iters,
                halo=_halo_width(lambda x: (apply(x[0]),), x0[:1]))


def _window_mesh(mesh, index):
    """The ``Mesh`` of the cells of the window ``index`` (same ``h``, its
    origin moved), and the slots of its DOF grid that are the window's.
    A window that ends inside the grid gets one inert slot more, dropped
    after the build; one that reaches the padding keeps the grid's."""
    n, h, x0 = [], [], []
    pad, keep = [], []
    for d, s in enumerate(index):
        real = min(s.stop, mesh.n[d]) - s.start
        if real < 1:
            raise ValueError("a window made only of inert padding")
        n.append(real)
        pad.append(max(1, s.stop - mesh.n[d]))
        h.append(real * mesh.h[d])
        x0.append(mesh.x0[d] + s.start * mesh.h[d])
        keep.append(slice(0, s.stop - s.start))
    return Mesh(n, h, x0, pad=tuple(pad)), tuple(keep)


def _moving_rank(ctx, sharding, spec, ref):
    mesh, border = _moving_setup(sharding.mesh, spec["grid"], ctx.device)
    shape = tuple(mesh.np_shape)
    R = ref["halo"]
    index, window = sharding.block(shape), sharding.window(shape, R)
    wmesh, keep = _window_mesh(mesh, window)
    LEDGER.reset()
    # the space-time capacity is rebuilt on the window, as JAX builds it
    # inside the sharded step
    cap = _windowed(_moving_capacity(wmesh, ctx.device), keep, wmesh.np_shape)
    border = _windowed(border, window, shape)
    # the step starts from rest, as JAX's does: a state to continue from
    # would come to the window by a halo exchange
    wshape = tuple(s.stop - s.start for s in window)
    x0 = tuple(torch.zeros(wshape, dtype=torch.float64, device=ctx.device)
               for _ in range(2))
    apply, b, minv, xinit, Tg = _reduced_slab(
        cap, 1.0, _zero_source, Dirichlet(1.0), border, x0, 0.0, _MOVING_DT)

    def apply_block(x):
        return _crop(apply(_extend(x, sharding, R, shape)), sharding, R,
                     shape)

    def crop(t):
        return _crop(t, sharding, R, shape)

    TW, iters, relres = linsolve.pcg(apply_block, crop(b), crop(xinit),
                                     Minv=crop(minv), tol=_MOVING_TOL,
                                     maxiter=500, _reduce=all_reduce_sum)
    out = (TW, crop(Tg))
    totals = LEDGER.totals()
    _check_no_grid_message("moving", shape)
    _check(iters == ref["iters"],
           f"moving: {iters} CG iterations on rank {ctx.rank}, the whole "
           f"step's {ref['iters']}")
    err = max(float(np.abs(o.cpu().numpy() - r[index]).max())
              for o, r in zip(out, ref["x"]))
    _check(err < 1e-8, f"moving: sharded vs whole step mismatch {err} on "
           f"rank {ctx.rank}")
    return dict(err=err, iters=iters, whole_iters=ref["iters"], halo=R,
                relres=float(relres), ledger=totals, largest=LEDGER.largest(),
                x=[_unshard(o, sharding, shape) for o in out])


# ---------------------------------------------------------------------------
# the Navier-Stokes steps (CN/AB2 pgmres, implicit-Picard fgmres)
# ---------------------------------------------------------------------------

_FLOW_DT = 0.01
_FLOW_L = (2.2, 0.41)
_NS_KW = dict(scheme="CN", method="pgmres", tol=1e-8, maxiter=80)
_PICARD_KW = dict(scheme="CN", picard_iters=2, method="fgmres", tol=1e-8,
                  maxiter=80)
_PICARD_M = dict(dt=_FLOW_DT, theta=0.5, schur="dct_cg", schur_cg_iters=8)


def _no_force(x, y, z):
    return 0.0


def _inflow(x, y, z=0.0, t=None):
    xi = y / _FLOW_L[1]
    return 0.3 * 4.0 * xi * (1.0 - xi)


def _flow_setup(dev_mesh, grid, device):
    """The JAX dryruns' channel: the DFG layout shrunk to ``grid`` cells
    (2.2 × 0.41, the complement of a circle of radius 0.05 at (0.2, 0.2)),
    a parabolic inlet of peak 0.3, Outflow on the right, no-slip walls, the
    pin gauge, μ = 1e-3, f64 on the padded staggered meshes."""
    nx, ny = grid
    Lx, Ly = _FLOW_L
    meshes = [padded_mesh(dev_mesh, (nx, ny), (Lx, Ly), x0)
              for x0 in ((-0.5 * Lx / nx, 0.0), (0.0, -0.5 * Ly / ny),
                         (0.0, 0.0))]
    body = geometry.complement(geometry.circle((0.2, 0.2), 0.05))
    caps = [compute_capacity(body, m, p=4, s=1, device=device)
            for m in meshes]
    ops = [make_diffusion_ops(c) for c in caps]
    fluid = Fluid(mesh_u=(meshes[0], meshes[1]), mesh_p=meshes[2],
                  capacity_u=(caps[0], caps[1]), operator_u=(ops[0], ops[1]),
                  capacity_p=caps[2], operator_p=ops[2], mu=1e-3, rho=1.0,
                  f_u=_no_force, f_p=_no_force)
    noslip = Dirichlet(0.0)
    bc_ux = BorderConditions({"left": Dirichlet(_inflow), "right": Outflow(),
                              "bottom": noslip, "top": noslip})
    bc_uy = BorderConditions({k: noslip for k in ("left", "right", "bottom",
                                                  "top")})
    return NavierStokesMono(fluid, (bc_ux, bc_uy), PinPressureGauge(),
                            Dirichlet(0.0))


def _flow_key(shape, device):
    """The Picard dryrun's key state: ``sin(arange · 0.013 (i+1))``."""
    ramp = torch.arange(float(math.prod(shape)), dtype=torch.float64,
                        device=device).reshape(shape)
    return tuple(torch.sin(ramp * (0.013 * (i + 1))) for i in range(5))


class _RankFlow(NavierStokesMono):
    """One rank's ``NavierStokesMono`` in a decomposed solve.  Its state is
    the rank's block of each field.  Every operator is the windowed view's,
    built from the view (a closure of the whole solver would hold whole
    tensors), applied to the fields grown by one halo exchange and cropped
    back; M is the view's rank-aware M; the Krylov dots are summed over the
    ranks.  The steppers are the class's own."""

    def __init__(self, view, grid):
        vars(self).update(vars(view))
        self._view, self._grid = view, grid

    @staticmethod
    def _krylov_reduce(t):
        return all_reduce_sum(t)

    def zero_state(self):
        return self._grid.crop(self._view.zero_state())

    def conv_vectors(self, x):
        return self._grid.crop(self._view.conv_vectors(self._grid.grow(x)))

    def _blocked(self, apply):
        g = self._grid
        return lambda x: g.crop(apply(g.grow(x)))

    def make_unsteady_apply(self, dt, theta):
        return self._blocked(self._view.make_unsteady_apply(dt, theta))

    def _picard_rows(self, x_k, dt=None, theta=1.0):
        return self._blocked(self._view._picard_rows(self._grid.grow(x_k), dt,
                                                     theta))

    def make_unsteady_rhs(self, dt, theta):
        rhs, g = self._view.make_unsteady_rhs(dt, theta), self._grid

        def block_rhs(x_prev, t_prev, t_next, extra_mom=None):
            extra = (None if extra_mom is None
                     else tuple(g.pad(e) for e in extra_mom))
            return g.crop(rhs(g.grow(x_prev), t_prev, t_next,
                              extra_mom=extra))

        return block_rhs

    def make_block_preconditioner(self, **kw):
        return self._view.make_block_preconditioner(**kw, _rank=self._grid)


def _rank_flow(solver, sharding, width):
    shape = tuple(solver.fluid.capacity_p.V.shape)
    view = windowed_stokes(solver, sharding.window(shape, width))
    return _RankFlow(view, _RankGrid(sharding, shape, width))


def _instrument(solver, spans):
    """Time the solver's applies and its M (its instance attributes wrap
    the class's methods)."""
    def timed(make, key):
        return lambda *a, **kw: spans.wrap(key, make(*a, **kw))
    solver.make_unsteady_apply = timed(solver.make_unsteady_apply, "apply")
    solver._picard_rows = timed(solver._picard_rows, "apply")
    solver.make_block_preconditioner = timed(
        solver.make_block_preconditioner, "M")
    solver.conv_vectors = spans.wrap("conv", solver.conv_vectors)


def _krylov_timing(spans, seconds, iters):
    """ms per Krylov iteration, split into the applies, M, the Gram-Schmidt
    reductions and the halo exchanges (one Krylov iteration is one apply,
    one M and its Gram-Schmidt sums; a restart adds an apply).  ``iters``:
    the iterations of every solve (an fgmres iteration is one M call)."""
    led = _ledger_seconds()
    inside = {k: sum(spans.ledger.get(s, {}).get(k, 0.0)
                     for s in ("apply", "M", "conv")) for k in led}
    iters = max(int(iters), 1)
    out = dict(iterations=iters, ms_per_iteration=seconds * 1e3 / iters,
               apply_ms_per_call=(spans.seconds.get("apply", 0.0) * 1e3
                                  / max(spans.calls.get("apply", 0), 1)),
               M_ms_per_call=(spans.seconds.get("M", 0.0) * 1e3
                              / max(spans.calls.get("M", 0), 1)),
               apply_calls=spans.calls.get("apply", 0),
               M_calls=spans.calls.get("M", 0))
    if led:
        out.update(
            gram_schmidt_all_reduce_ms_per_iteration=(
                (led.get("all_reduce", 0.0) - inside.get("all_reduce", 0.0))
                * 1e3 / iters),
            halo_ms_per_iteration=led.get("halo", 0.0) * 1e3 / iters,
            dct_ms_per_iteration=led.get("dct", 0.0) * 1e3 / iters,
            M_reduce_ms_per_iteration=(spans.ledger.get("M", {}).get(
                "all_reduce", 0.0) * 1e3 / iters))
    return out


def _run_flow(solver, device, steps, picard):
    """The dryrun's ``steps`` steps by the solver's own stepper, timed:
    (state, Krylov iterations and relres per step, the timing split)."""
    spans = _Spans(device)
    _instrument(solver, spans)
    spans._sync()
    t0 = time.perf_counter()
    if picard:
        x = solver.solve_unsteady_picard(_FLOW_DT, steps * _FLOW_DT,
                                         **_PICARD_KW)
    else:
        x = solver.solve_unsteady(_FLOW_DT, steps * _FLOW_DT, **_NS_KW)
    spans._sync()
    seconds = time.perf_counter() - t0
    iters = [int(i) for i in solver.krylov_iters]
    # the Picard stepper logs each step's last sweep; an fgmres iteration
    # applies M once
    n_iter = spans.calls.get("M", 0) if picard else sum(iters)
    return (x, iters, [float(r) for r in solver.krylov_relres],
            _krylov_timing(spans, seconds, n_iter))


def _flow_whole(dev_mesh, device, grid, steps, picard):
    """The whole-grid run of the NS (or Picard) dryrun, its halo (the
    reach of the Picard rows at the key state, plus the edge slot) and,
    for Picard, M at the key state."""
    solver = _flow_setup(dev_mesh, grid, device)
    shape = tuple(solver.fluid.capacity_p.V.shape)
    key = _flow_key(shape, device)
    ref = dict(halo=_halo_width(solver._picard_rows(key, _FLOW_DT, 0.5),
                                key))
    if picard:
        y = solver.make_block_preconditioner(**_PICARD_M)(key)
        ref["y"] = [a.cpu().numpy() for a in y]
    x, iters, relres, timing = _run_flow(solver, device, steps, picard)
    ref.update(x=[a.cpu().numpy() for a in x], iters=iters, relres=relres,
               timing=timing)
    return ref


def _flow_rank(ctx, sharding, spec, ref, picard):
    """The rank's run of the NS (or Picard) dryrun, as many steps as the
    whole run took, held to it."""
    solver = _flow_setup(sharding.mesh, spec["grid"], ctx.device)
    shape = tuple(solver.fluid.capacity_p.V.shape)
    index = sharding.block(shape)
    rs = _rank_flow(solver, sharding, ref["halo"])
    del solver
    label = "picard" if picard else "ns"
    report = dict(halo=ref["halo"])
    if picard:
        # (a) M at the key state, sharded against whole: machine-tight
        key = tuple(k[index] for k in _flow_key(shape, ctx.device))
        y = rs.make_block_preconditioner(**_PICARD_M)(key)
        scale = max(float(np.abs(a).max()) for a in ref["y"])
        err_M = max(float(np.abs(a.cpu().numpy() - b[index]).max())
                    for a, b in zip(y, ref["y"]))
        _check(err_M < 1e-9 * max(scale, 1.0),
               f"picard: sharded vs whole DCT-Schur M {err_M} (scale "
               f"{scale}) on rank {ctx.rank}")
        report.update(err_M=err_M, scale_M=scale)
    launched = _launches()
    LEDGER.reset()
    x, iters, relres, timing = _run_flow(rs, ctx.device, len(ref["iters"]),
                                         picard)
    report.update(launches=_launches(launched), iters=iters,
                  whole_iters=ref["iters"], relres=relres,
                  whole_relres=ref["relres"], ledger=LEDGER.totals(),
                  largest=LEDGER.largest(), grid_messages=_grid_messages(shape),
                  timing=timing)
    if spec.get("check", True):
        _check_no_grid_message(label, shape)
    scale = max(float(np.abs(a).max()) for a in ref["x"])
    err = max(float(np.abs(a.cpu().numpy() - b[index]).max())
              for a, b in zip(x, ref["x"]))
    report.update(err=err, scale=scale)
    if picard:
        # (b) the scan: a finite state and converged inner solves (not the
        # end state: the rim slivers condition the saddle point ~1e9); where
        # the whole run stops at its cap above 1e-6, within 2x of its relres
        _check(all(bool(torch.isfinite(a).all()) for a in x),
               f"picard: a non-finite state on rank {ctx.rank}")
        bound = max(1e-6, 2.0 * max(ref["relres"]))
        _check(max(relres) < bound,
               f"picard: fgmres relres {relres} not under {bound} (whole "
               f"{ref['relres']}) on rank {ctx.rank}")
    else:
        _check(err < 1e-6 * max(scale, 1.0),
               f"ns: sharded vs whole mismatch {err} (scale {scale}) on rank "
               f"{ctx.rank}")
    report["x"] = [_unshard(a, sharding, shape) for a in x]
    return report


def _ns_whole(dev_mesh, device, grid, steps=3, check=True):
    return _flow_whole(dev_mesh, device, grid, steps, picard=False)


def _picard_whole(dev_mesh, device, grid, steps=2, check=True):
    return _flow_whole(dev_mesh, device, grid, steps, picard=True)


def _ns_rank(ctx, sharding, spec, ref):
    return _flow_rank(ctx, sharding, spec, ref, picard=False)


def _picard_rank(ctx, sharding, spec, ref):
    return _flow_rank(ctx, sharding, spec, ref, picard=True)


def _flow_parts_whole(dev_mesh, device, grid):
    """The pieces of the flow dryruns held alone: M of each Schur kind on
    the key state, and the DCT-II/III pair of the DCT-CG M on one field."""
    solver = _flow_setup(dev_mesh, grid, device)
    shape = tuple(solver.fluid.capacity_p.V.shape)
    key = _flow_key(shape, device)
    out = dict(halo=_halo_width(solver._picard_rows(key, _FLOW_DT, 0.5),
                                key))
    for schur in ("cheb", "dct_cg"):
        M = solver.make_block_preconditioner(
            dt=_FLOW_DT, theta=0.5, schur=schur, schur_cg_iters=8)
        out[schur] = [a.cpu().numpy() for a in M(key)]
    ncell = tuple(n - 1 for n in shape)
    mats = [_dct2_matrix(n, dtype=key[4].dtype, device=device)
            for n in ncell]
    fwd = _along(mats[1], _along(mats[0], key[4][:ncell[0], :ncell[1]], 0),
                 1)
    out["dct"] = fwd.cpu().numpy()
    out["idct"] = _along(mats[1].T, _along(mats[0].T, fwd, 0),
                         1).cpu().numpy()
    return out


def _flow_parts_rank(ctx, sharding, spec, ref):
    solver = _flow_setup(sharding.mesh, spec["grid"], ctx.device)
    shape = tuple(solver.fluid.capacity_p.V.shape)
    index = sharding.block(shape)
    rs = _rank_flow(solver, sharding, ref["halo"])
    del solver
    key = tuple(k[index] for k in _flow_key(shape, ctx.device))
    state = {}
    for schur in ("cheb", "dct_cg"):
        M = rs.make_block_preconditioner(
            dt=_FLOW_DT, theta=0.5, schur=schur, schur_cg_iters=8)
        state[schur] = [_unshard(a, sharding, shape) for a in M(key)]
    # the DCT pair alone, on the block's part of the last key field's core
    grid = rs._grid
    ncell = tuple(n - 1 for n in shape)
    mats = [_dct2_matrix(n, dtype=key[4].dtype, device=ctx.device)
            for n in ncell]
    LEDGER.reset()
    fwd = grid.along(mats[1], grid.along(mats[0], grid.pad(key[4])[
        grid.core(ncell)], 0), 1)
    inv = grid.along(mats[1].T, grid.along(mats[0].T, fwd, 0), 1)
    report = dict(ledger=LEDGER.totals(), largest=LEDGER.largest())
    for name, t in (("dct", fwd), ("idct", inv)):
        block = t.new_zeros(tuple(b.stop - b.start for b in index))
        block[:t.shape[0], :t.shape[1]] = t
        whole = _unshard(block, sharding, shape)
        state[name] = None if whole is None else whole[:ncell[0], :ncell[1]]
    report["out"] = state
    return report


def _same_counts(name, ranks):
    """Every rank took the same Krylov counts: each host read saw the same
    reduced values."""
    counts = [rep["iters"] for rep in ranks]
    _check(all(c == counts[0] for c in counts),
           f"{name}: Krylov counts differ between the ranks: {counts}")


# ---------------------------------------------------------------------------
# the Stefan front-tracking step
# ---------------------------------------------------------------------------

_STEF_DT = 0.02
_STEF_R0 = 1.5
_STEF_T_INF = -0.5
_STEF_CENTER = (4.0, 4.0)
# the JAX dryrun's keywords; the rest are StefanMono2D.solve's defaults
_STEF_NEWTON = (6, 1e-8, 1e-8, 1.0)
_STEF_KW = dict(newton_params=_STEF_NEWTON, interior_fluid=False,
                method="bicgstab", jac="intercept", band_budget=None)


def _stefan_setup(dev_mesh, grid, nm, device):
    """The JAX dryrun's problem: a solid circle of radius 1.5 (``nm``
    markers) at the centre of an 8 × 8 box in liquid at -0.5, held on the
    borders, the interface at 0, the liquid starting from the profile
    -0.5 (1 - R0/r), f64 on the padded mesh."""
    mesh = padded_mesh(dev_mesh, tuple(grid), (8.0, 8.0), (0.0, 0.0))
    front = FrontTracker(device=device).create_circle(_STEF_CENTER, _STEF_R0,
                                                      n=nm)
    cap0 = compute_capacity(lambda x, y: -front.sdf(x, y), mesh, p=4, s=1,
                            device=device)
    C = cap0.C_om.cpu().numpy()
    r = np.hypot(C[..., 0] - _STEF_CENTER[0], C[..., 1] - _STEF_CENTER[1])
    Tw0 = torch.as_tensor(np.where(r >= _STEF_R0, _STEF_T_INF * (
        1 - _STEF_R0 / np.maximum(r, _STEF_R0)), 0.0), device=device)
    bc_b = BorderConditions({k: Dirichlet(_STEF_T_INF)
                             for k in ("left", "right", "top", "bottom")})
    phase = Phase(cap0, make_diffusion_ops(cap0), _zero_source, 1.0)
    ic = InterfaceConditions(ScalarJump(1.0, 1.0, 0.0),
                             FluxJump(1.0, 1.0, 1.0))
    solver = stefan2d.StefanMono2D(phase, bc_b, Dirichlet(0.0), _STEF_DT,
                                   (Tw0, torch.zeros_like(Tw0)), mesh, "BE")
    return solver, front, ic


def _stefan_t_end(steps):
    """The span ``solve`` marches for ``steps`` marker steps: the JAX
    dryrun's dt/2 for its 2, no slab past the first for 1."""
    return _STEF_DT / 2 if steps == 2 else (steps - 1) * _STEF_DT


def _stefan_whole(dev_mesh, device, grid, nm, steps=2, check=True):
    solver, front, ic = _stefan_setup(dev_mesh, grid, nm, device)
    # the halo: the slab operator's reach at the start front, plus the
    # edge slot, plus one for the residual's 3x3 filter
    mk = front.markers
    cap = compute_capacity_spacetime(
        stefan2d._st_marker_body, solver.mesh, 0.0, _STEF_DT, p=4, s=1,
        params=(mk, mk, _STEF_DT, -1.0), device=device)
    apply, _ = build_moving_mono_system(cap, 1.0, _zero_source, solver.bc_i,
                                        solver.border, 0.0, _STEF_DT, "BE")
    halo = _halo_width(apply, solver.u0) + 1
    clock = _Clock(device)
    clock.start()
    solver.solve(front, 0.0, _stefan_t_end(steps), ic, **_STEF_KW)
    ms = clock.stop()
    return dict(T=[a.cpu().numpy() for a in solver.x],
                markers=solver.markers.cpu().numpy(), halo=halo,
                gn_iters=[int(i) for i in solver.iters_log],
                krylov_iters=[int(i) for i in solver.krylov_iters],
                ms_per_gn_iteration=ms / max(int(sum(solver.iters_log)), 1))


def _stefan_march(solver, markers, u0, grid, wmesh, keep, border, ic, spans,
                  steps):
    """``StefanMono2D.solve`` with the JAX dryrun's keywords on one rank:
    the slab capacity rebuilt on the rank's window mesh from the
    replicated markers, the coupled slab system by pbicgstab over the
    blocks with summed dots, the flux and the filtered residual on the
    window, the intercept Jacobian on the window's cells, the normal
    equations summed over the ranks (kind ``"normal_equations"``), the LM
    step, smoothing and resampling on every rank alike."""
    dt, scheme, bc_i = solver.dt, solver.scheme, solver.bc_i
    D, f = solver.phase.diffusion, solver.phase.source
    sign, fuse = -1.0, True
    rhoL = ic.flux.value
    max_iter, lin_tol, lin_maxiter = _STEF_NEWTON[0], 1e-9, 400
    like = dict(dtype=markers.dtype, device=markers.device)

    def capacity(mk_a, mk_b):
        cap = compute_capacity_spacetime(
            stefan2d._st_marker_body, wmesh, 0.0, dt, p=4, s=1,
            params=(mk_a, mk_b, dt, sign), band_budget=None, **like)
        return _windowed(cap, keep, wmesh.np_shape)

    def solve(cap, Told, t):
        apply, rhs = build_moving_mono_system(cap, D, f, bc_i, border, t, dt,
                                              scheme)
        minv = tuple(grid.crop(1.0 / d)
                     for d in moving_mono_diag(cap, D, bc_i, border, scheme))
        T, its, _ = linsolve.pbicgstab(
            lambda x: grid.crop(apply(grid.grow(x))),
            grid.crop(rhs(grid.grow(Told))), Told, Minv=minv, tol=lin_tol,
            maxiter=lin_maxiter, _reduce=all_reduce_sum)
        return T, its

    capacity = spans.wrap("capacity", capacity)
    solve = spans.wrap("solve", solve)

    def jac(d, mk_a, normals):
        J = stefan2d._intercept_jacobian(d, mk_a, normals, wmesh,
                                         sign * -rhoL, fuse)
        J = J.reshape(tuple(wmesh.np_shape) + (-1,))[keep]
        return grid.crop(J).reshape(-1, J.shape[-1])

    def normal(J, Fv):
        nm = J.shape[1]
        tot = all_reduce_sum(torch.cat([(J.T @ J).reshape(-1), J.T @ Fv,
                                        (Fv @ Fv).reshape(1)]),
                             kind="normal_equations")
        return (tot[:nm * nm].reshape(nm, nm), tot[nm * nm:nm * nm + nm],
                torch.sqrt(tot[-1]))

    def inner(Told, mk_a, d0, t):
        def residual(mk_b):
            cap = capacity(mk_a, mk_b)
            T, its = solve(cap, Told, t)
            flux, Va, Vb = stefan2d._slab_flux(cap, D, grid.grow(T))
            F = stefan2d._box3_filter(rhoL * (Va - Vb) - flux)
            return grid.crop(F), T, its

        d, T, _, _, rn, it, kit = stefan2d._gauss_newton(
            residual, jac, mk_a, d0, (max_iter,) + _STEF_NEWTON[1:],
            (1e-4, 10.0, 1e-10, 1e6), (5, 1), 0.5 * min(solver.mesh.h[:2]),
            False, normal)
        return d, T, (it, kit)

    K = _num_slabs(dt, 0.0, _stefan_t_end(steps))
    T, mk, _, (its, kits) = stefan2d._march_markers(inner, u0, markers, 0.0,
                                                    dt, K, 0.8)
    return T, mk, [int(i) for i in its], [int(k) for k in kits]


def _stefan_rank(ctx, sharding, spec, ref):
    solver, front, ic = _stefan_setup(sharding.mesh, spec["grid"],
                                      spec["nm"], ctx.device)
    mesh = solver.mesh
    shape = tuple(mesh.np_shape)
    R = ref["halo"]
    index, window = sharding.block(shape), sharding.window(shape, R)
    wmesh, keep = _window_mesh(mesh, window)
    border = _windowed(solver.border, window, shape)
    grid = _RankGrid(sharding, shape, R)
    u0 = tuple(u[index].contiguous() for u in solver.u0)
    spans = _Spans(ctx.device)
    launched = _launches()
    LEDGER.reset()
    spans._sync()
    t0 = time.perf_counter()
    T, mk, its, kits = _stefan_march(solver, front.markers, u0, grid, wmesh,
                                     keep, border, ic, spans,
                                     len(ref["gn_iters"]))
    spans._sync()
    seconds = time.perf_counter() - t0
    totals = LEDGER.totals()
    nm = int(spec["nm"])
    if spec.get("check", True):
        _check_no_grid_message("stefan", shape,
                               {"normal_equations": nm * (nm + 1) + 1})
    err_T = max(float(np.abs(a.cpu().numpy() - b[index]).max())
                for a, b in zip(T, ref["T"]))
    mk = mk.cpu().numpy()
    err_mk = float(np.abs(mk - ref["markers"]).max())
    _check(err_T < 1e-6, f"stefan: sharded vs whole T mismatch {err_T} on "
           f"rank {ctx.rank}")
    _check(err_mk < 1e-8, f"stefan: sharded vs whole marker mismatch "
           f"{err_mk} on rank {ctx.rank}")
    n_gn = max(sum(its), 1)
    led = totals.get("normal_equations", {})
    timing = dict(
        ms_per_gn_iteration=seconds * 1e3 / n_gn,
        capacity_ms_per_gn_iteration=(spans.seconds.get("capacity", 0.0)
                                      * 1e3 / n_gn),
        solve_ms_per_gn_iteration=spans.seconds.get("solve", 0.0) * 1e3
        / n_gn,
        normal_equations_ms_per_gn_iteration=(led.get("seconds", 0.0) * 1e3
                                              / n_gn))
    return dict(launches=_launches(launched), err_T=err_T, err_mk=err_mk,
                markers=mk, gn_iters=its,
                whole_gn_iters=ref["gn_iters"], krylov_iters=kits,
                whole_krylov_iters=ref["krylov_iters"], halo=R,
                ledger=totals, largest=LEDGER.largest(),
                grid_messages=_grid_messages(shape, ("normal_equations",)),
                timing=timing, T=[_unshard(a, sharding, shape) for a in T])


def _same_markers(name, ranks):
    """The replicated markers are bit-equal on every rank."""
    first = ranks[0]["markers"]
    _check(all(np.array_equal(rep["markers"], first) for rep in ranks),
           f"{name}: the markers differ between the ranks")


# ---------------------------------------------------------------------------
# the halo exchange on its own
# ---------------------------------------------------------------------------

def _halo_whole(dev_mesh, device, shape, widths):
    return dict(grid=np.arange(float(math.prod(shape))).reshape(shape))


def _halo_rank(ctx, sharding, spec, ref):
    """Each rank's block of a known grid, grown at every width: the grown
    blocks and the ledger of each exchange, for the caller to hold to the
    whole grid's windows."""
    whole = torch.as_tensor(ref["grid"], device=ctx.device)
    block = whole[sharding.block(whole.shape)].contiguous()
    grown, ledgers = [], []
    for width in spec["widths"]:
        LEDGER.reset()
        grown.append(halo_exchange(block, sharding.mesh, width).cpu().numpy())
        ledgers.append(LEDGER.totals())
    return dict(coords=sharding.mesh.coords,
                index=sharding.block(whole.shape), grown=grown,
                ledgers=ledgers)


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

_RANKS = {"heat": _heat_rank, "stokes": _stokes_rank, "moving": _moving_rank,
          "ns": _ns_rank, "picard": _picard_rank, "stefan": _stefan_rank,
          "flow_parts": _flow_parts_rank, "halo": _halo_rank}
_WHOLE = {"heat": _heat_whole, "stokes": _stokes_whole,
          "moving": _moving_whole, "ns": _ns_whole, "picard": _picard_whole,
          "stefan": _stefan_whole, "flow_parts": _flow_parts_whole,
          "halo": _halo_whole}
# gates across the ranks' reports, checked by the caller
_ACROSS = {"ns": _same_counts, "picard": _same_counts,
           "stefan": _same_markers}


def _world_dryruns(ctx, specs, refs):
    """Every rank: run the requested dryruns on its block; rank 0 returns
    each one's report with the per-rank reports gathered."""
    sharding = grid_sharding(make_grid_mesh())
    out = {}
    for name, spec in specs.items():
        mine = _RANKS[name](ctx, sharding, spec, refs[name])
        state = {k: mine.pop(k) for k in ("T", "out", "x") if k in mine}
        ranks = [None] * ctx.world if ctx.rank == 0 else None
        dist.gather_object(mine, ranks, dst=0)
        if ctx.rank == 0:
            out[name] = dict(state, ranks=ranks)
    return out


def _dryruns(n_ranks, device, timeout_s=300, **specs):
    """Run the dryruns named in ``specs`` in one world of ``n_ranks``
    ranks: ``heat``, ``stokes``, ``moving``, ``ns``, ``picard`` and
    ``stefan``, each a dict with its ``grid`` (for heat also ``steps``,
    ``maxiter`` and ``timed``; for ns and picard ``steps`` and ``check``;
    for stefan ``nm``, ``steps`` and ``check``), and ``halo``, a ``shape``
    and its ``widths``.  The whole-grid references run here, on
    ``device``, before the ranks do theirs.  Returns, per dryrun, the
    gathered state and every rank's report; any failed gate raises."""
    device = resolve_device(device)
    dev_mesh = make_grid_mesh(n_ranks)
    refs = {}

    def whole_runs():
        for name, spec in specs.items():
            t0 = time.perf_counter()
            refs[name] = _WHOLE[name](dev_mesh, device, **spec)
            refs[name]["seconds"] = time.perf_counter() - t0
        return (refs,)

    # the ranks start and join their group while the whole runs go on
    out = run_world(_world_dryruns, n_ranks, device, specs,
                    timeout_s=timeout_s, later=whole_runs)
    for name in out:
        out[name]["whole"] = refs[name]
        if name in _ACROSS:
            _ACROSS[name](name, out[name]["ranks"])
    return out


def _tensor(a, device):
    return torch.as_tensor(a, device=device)


def dryrun_heat_multichip(n_devices, grid=(63, 63), device=None):
    """Build the flagship 2D cut-cell heat step, keep each rank's block of
    its fields, and run ONE implicit step (rhs + CG solve) decomposed over
    ``n_devices`` ranks: a halo exchange and the stencil kernel per matvec,
    a sum over the ranks per dot.  Asserts it equals the whole-grid step
    and returns the step's field."""
    device = resolve_device(device)
    out = _dryruns(n_devices, device, heat=dict(grid=grid))
    return _tensor(out["heat"]["T"], device)


def dryrun_stokes_multichip(n_devices, grid=(31, 31), device=None):
    """The monolithic Stokes saddle-point apply (staggered velocities and
    pressure of the lid cavity) decomposed over ``n_devices`` ranks: each
    rank applies a windowed view of the solver to its fields grown by the
    operator's reach.  Asserts it equals the whole apply."""
    device = resolve_device(device)
    out = _dryruns(n_devices, device, stokes=dict(grid=grid))
    return tuple(_tensor(o, device) for o in out["stokes"]["out"])


def dryrun_moving_multichip(n_devices, grid=(30, 30), device=None):
    """One prescribed-motion moving-interface step (space-time capacity
    rebuilt per rank on its window, reduced slab CG with halo exchanges and
    summed dots) over ``n_devices`` ranks, on a grid that need not divide
    (the inert padding grows).  Asserts it equals the whole step."""
    device = resolve_device(device)
    out = _dryruns(n_devices, device, moving=dict(grid=grid))
    return tuple(_tensor(o, device) for o in out["moving"]["x"])


def dryrun_ns_multichip(n_devices, grid=(48, 24), n_steps=3, check_hlo=True,
                        device=None):
    """The decomposed FLOW path: ``n_steps`` CN steps with AB2 convection
    and the block-Schur-preconditioned pgmres, on the JAX dryrun's shrunk
    DFG channel (f64), over ``n_devices`` ranks: every operator on the
    rank's window over one halo exchange of the five state fields, M's
    sums over the ranks, each Gram-Schmidt dot one summed reduction.
    Asserts the end state equals the whole run's to 1e-6 of its scale,
    equal pgmres counts on every rank, and (``check_hlo``: the ledger
    stands in for JAX's HLO scan) no grid-sized message.  Returns the end
    state."""
    device = resolve_device(device)
    out = _dryruns(n_devices, device,
                   ns=dict(grid=grid, steps=n_steps, check=check_hlo))
    return tuple(_tensor(o, device) for o in out["ns"]["x"])


def dryrun_ns_picard_multichip(n_devices, grid=(48, 24), n_steps=2,
                               check_hlo=True, device=None):
    """The robust NS path decomposed: implicit-Picard CN steps by fgmres
    with the DCT-CG block-Schur M, over ``n_devices`` ranks.  The DCT is
    reduce-scattered along the rank grid, one block a message.  Asserts
    (a) M on the key state equals the whole M to 1e-9 of its scale, (b)
    the scan's state is finite with fgmres relres under 1e-6, and equal
    counts on every rank (not the end state: the rim slivers condition the
    saddle point ~1e9).  Returns ``(x, grid-sized messages)``, the count 0
    where JAX allows its DCT 4 (None without ``check_hlo``)."""
    device = resolve_device(device)
    out = _dryruns(n_devices, device,
                   picard=dict(grid=grid, steps=n_steps, check=check_hlo))
    run = out["picard"]
    n_grid = (max(rep["grid_messages"] for rep in run["ranks"])
              if check_hlo else None)
    return tuple(_tensor(o, device) for o in run["x"]), n_grid


def dryrun_stefan_multichip(n_devices, grid=(32, 32), nm=32, check_hlo=True,
                            device=None):
    """The flagship decomposed: ``StefanMono2D.solve`` over one time span
    (two marker steps) with the grid fields on ``n_devices`` ranks and the
    ``nm`` markers replicated; the slab capacity is rebuilt on each rank's
    window and the normal equations are summed over the ranks.  Asserts T
    and the markers equal the whole run's (1e-6, 1e-8), the markers
    bit-equal on every rank, and no grid-sized message but the normal
    equations (nm(nm+1)+1 elements).  Returns ``(T, markers)``."""
    device = resolve_device(device)
    out = _dryruns(n_devices, device,
                   stefan=dict(grid=grid, nm=nm, check=check_hlo))
    run = out["stefan"]
    return (tuple(_tensor(o, device) for o in run["T"]),
            _tensor(run["ranks"][0]["markers"], device))


def dryrun_multichip(n_ranks, device=None):
    """The six dryruns at the JAX module's default grids, in one world of
    ``n_ranks`` ranks; prints one ``dryrun_multichip: OK`` line and returns
    each one's gathered state."""
    device = resolve_device(device)
    out = _dryruns(n_ranks, device, heat=dict(grid=(63, 63)),
                   stokes=dict(grid=(31, 31)), moving=dict(grid=(30, 30)),
                   stefan=dict(grid=(32, 32), nm=32),
                   ns=dict(grid=(48, 24)), picard=dict(grid=(48, 24)))
    print(f"dryrun_multichip: OK on {n_ranks} ranks ({device.type}) "
          f"(heat + stokes + moving-geometry + unsteady-NS CN/AB2 scan + "
          f"implicit-Picard fgmres/DCT-Schur scan + Stefan-FT GN steps, "
          f"sharded == unsharded, no grid-sized message in any ledger)")
    return {"heat": _tensor(out["heat"]["T"], device),
            "stokes": tuple(_tensor(o, device) for o in out["stokes"]["out"]),
            "moving": tuple(_tensor(o, device) for o in out["moving"]["x"]),
            "stefan": (tuple(_tensor(o, device) for o in out["stefan"]["T"]),
                       _tensor(out["stefan"]["ranks"][0]["markers"], device)),
            "ns": tuple(_tensor(o, device) for o in out["ns"]["x"]),
            "picard": tuple(_tensor(o, device) for o in out["picard"]["x"])}
