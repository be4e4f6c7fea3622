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

Three dryruns run a solver this way and hold it to the unsharded run, as
the JAX module's do: the heat step (the CG matvec is the CUDA stencil
kernel on each rank's halo-extended block), the Stokes apply and the
moving-geometry step.  In place of JAX's scan of the compiled HLO they read
``_comm.LEDGER``: no message may carry a grid-sized array.  The NS, Picard
and Stefan dryruns are not ported yet.

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
from ..boundary import BorderConditions, Dirichlet
from ..capacity import compute_capacity, compute_capacity_spacetime
from ..kernels.stencil import stencil5_matvec
from ..mesh import Mesh
from ..operators import make_diffusion_ops
from ..phase import Fluid
from ..solvers.heat_fast import CG_CHUNK, FastHeatBE
from ..solvers.moving_diffusion import _reduced_slab, solve_moving_mono_step
from ..solvers.stokes import PinPressureGauge, StokesMono
from ._comm import LEDGER, all_reduce_sum, halo_exchange, run_world

# the JAX module's names ported so far; ``dryrun_multichip`` stands for
# ``__graft_entry__.dryrun_multichip``
__all__ = ["make_grid_mesh", "grid_sharding", "shard_pytree", "padded_mesh",
           "dryrun_heat_multichip", "dryrun_stokes_multichip",
           "dryrun_moving_multichip"]


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
    """A view of a whole-grid ``StokesMono`` on the window ``index``: every
    grid-shaped tensor it reads cut to the window.  ``apply_steady`` of the
    view, on the window of each field, equals the whole apply on the cells
    at least its reach inside the window's interior edges.

    The pin gauge's mask is cut like any other, so it stays with the rank
    whose window holds the pinned cell.  Pieces that index the whole grid
    are refused: ghost cut rows (flat global positions), the mean gauge (a
    sum over the grid) and periodic axes (a wrap across it)."""
    if any(g is not None for g in solver._ghost):
        raise ValueError(
            "a windowed view of StokesMono with ghost cut rows is not "
            "ported: its rows index flat global positions (ROADMAP Queue 1 "
            "item 15b, the NS and Stefan dryruns, windows them)")
    if solver.mean_w is not None:
        raise ValueError("a windowed view needs the pin or outflow gauge: "
                         "the mean gauge sums over the whole grid")
    per = solver.fluid.operator_p.periodic
    if per is not None and any(per):
        raise ValueError("a windowed view cannot wrap a periodic axis")
    return _windowed(solver, index, tuple(solver.fluid.capacity_p.V.shape))


def _halo_width(apply, fields):
    """The halo a window needs for a linear ``apply``: its reach (the
    widest support, in cells, of its response to a unit impulse at the
    grid's centre in each input field) plus one.  The one is the window's
    edge slot: ``_zlast`` reads a window's last slot as the grid's inert
    padding, and a rebuilt capacity's first slot sees no cell below it, so
    that slot is wrong before the operator carries it ``reach`` cells in."""
    shape = fields[0].shape
    centre = tuple(s // 2 for s in shape[:2])
    zero = tuple(torch.zeros_like(f) for f in fields)
    reach = 0
    for i in range(len(fields)):
        x = list(zero)
        x[i] = x[i].clone()
        x[i][centre] = 1.0
        for y in apply(tuple(x)):
            hit = torch.nonzero(y != 0)[:, :2].cpu()
            if len(hit):
                reach = max(reach, int((hit - torch.tensor(centre))
                                       .abs().max()))
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


def _summed_dot(a, b):
    """A Krylov dot of the ranks' blocks: each block's, summed over the
    ranks."""
    return all_reduce_sum(linsolve._tdot(a, b))


def _check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def _check_no_grid_message(label, shape):
    cells = math.prod(shape)
    _check(LEDGER.largest() < cells,
           f"{label}: a message of {LEDGER.largest()} elements, not under "
           f"the grid's {cells}")


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

    blk._cg_matvec, blk._cg_dot = matvec, _summed_dot
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
                                     maxiter=500, _dot=_summed_dot)
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
          "halo": _halo_rank}
_WHOLE = {"heat": _heat_whole, "stokes": _stokes_whole,
          "moving": _moving_whole, "halo": _halo_whole}


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
    ranks: ``heat``, ``stokes`` and ``moving``, each a dict with its
    ``grid`` (and for heat ``steps``, ``maxiter`` and ``timed``), and
    ``halo``, a ``shape`` and its ``widths``.  The whole-grid references
    run here first, on ``device``.  Returns, per dryrun, the gathered state
    and every rank's report; any failed gate raises."""
    device = resolve_device(device)
    dev_mesh = make_grid_mesh(n_ranks)
    refs = {name: _WHOLE[name](dev_mesh, device, **spec)
            for name, spec in specs.items()}
    out = run_world(_world_dryruns, n_ranks, device, specs, refs,
                    timeout_s=timeout_s)
    for name in out:
        out[name]["whole"] = refs[name]
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


def dryrun_multichip(n_ranks, device=None):
    """The dryruns ported so far (heat, Stokes apply, moving step) at the
    JAX module's default grids, in one world of ``n_ranks`` ranks; prints
    one ``dryrun_multichip: OK`` line and returns each one's gathered
    state."""
    device = resolve_device(device)
    out = _dryruns(n_ranks, device, heat=dict(grid=(63, 63)),
                   stokes=dict(grid=(31, 31)), moving=dict(grid=(30, 30)))
    print(f"dryrun_multichip: OK on {n_ranks} ranks ({device.type}) "
          f"(heat + stokes + moving-geometry, sharded == unsharded, no "
          f"grid-sized message in the ledger)")
    return {"heat": _tensor(out["heat"]["T"], device),
            "stokes": tuple(_tensor(o, device) for o in out["stokes"]["out"]),
            "moving": tuple(_tensor(o, device) for o in out["moving"]["x"])}
