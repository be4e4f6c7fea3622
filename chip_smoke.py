#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``penguin_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written CUDA stencil kernels from ``penguin_tpu_torch/
csrc`` with nvcc, checks each against its plain PyTorch version on the card,
runs the benchmark slice (1024² cut-cell backward-Euler heat step, f32, at
the easy dt = 0.25 h² and the stiff dt = 100 h²) plus its 3D counterpart
(128³ sphere, the 7-point kernel) through the solver's entry points, checks
the results, compares the card with the port's CPU path, then drives the
general scalar path (the masked mono/diph assembly and the matrix-free
Krylov solvers of ``linsolve``: diffusion, two-phase and advection-diffusion
solvers, f32 at 1024² and 512²) against the FastHeatBE result and physical
gates, and compares it with the CPU path in f64.  Then it drives the
moving-interface path: the prescribed-motion heat case on an oscillating
circle at 1024² in f32 through ``MovingDiffusionUnsteadyMono`` (a space-time
capacity rebuilt every slab) with its grid convergence in f64, a front of
512 markers on a 512² mesh built dense and through the narrow-band engine
and marched by the same solver, and the moving solvers, the cut-moment
operators and the volume Jacobian card against CPU in f64 (phases 8-10).
Then the phase-change path: the Frank disk of benchmarks/stefan2d_tpu.py at
256² with 256 markers in f32 through ``StefanMono2D.solve`` (a narrow-band
slab capacity rebuilt every Gauss-Newton iteration) and, at 64², its
autodiff, geometric, two-phase and Gibbs-Thomson variants (phase 11); the 1D
Stefan convergence row of benchmarks/stefan1d_convergence.py, the
coupled-Newton and adaptive 1D solvers, the height-function and the
species/binary-alloy solvers (phase 12); every class of that path card
against CPU in f64 (phase 13).  Last it times the steps, the slabs, the GN
and Newton iterations and the kernels with CUDA events (phase 7).  Every
phase raises on failure, so the exit code is 0 only if all
passed.  Without a CUDA device it exits with an error before doing
anything.

The last two lines of standard output are a JSON object with one entry per
kernel and then ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N2D = 1024               # the bench grid: 1024² cells, a 1025×1025 DOF array
N3D = 128                # 3D heat scaling grid: 128³ cells, 129³ DOFs
L = 4.0
TOL = 1e-5               # the bench's CG tolerance
EASY = (0.25, 24)        # (dt / h², cg_maxiter)
STIFF = (100.0, 600)
RUN_STEPS = 300          # main-path steps at each dt
COUNT_STEPS = 20         # steps with per-step CG accounting
# kernel vs plain version, relative to max|y|: FMA contraction and one-
# expression summation differ from the composite by a few ulps
KERNEL_TOL = {torch.float32: 1e-5, torch.float64: 1e-13}
# H100 SXM data-sheet peaks for the roofline bound of each kernel
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12

# the general scalar path
GEN_METHODS = ("cg", "bicgstab", "pgmres")
GEN_STEPS = 5            # one initial solve and 5 BE steps: 6 applications
GEN_TOL = 1e-5           # Krylov relres in f32
# |T_general - T_FastHeatBE| on active cells after 6 applications, f32: two
# Krylov solves to relres 1e-5 of two forms of one system.  FastHeatBE
# eliminates the interface and border unknowns; in the general system the
# interface rows (Γ·1) dominate ‖b‖, so relres 1e-5 leaves bulk rows (of
# scale V ~ h²) loose: measured 4.8e-3 for cg and bicgstab, 4.5e-4 for the
# row-equilibrated pgmres (H100, 1024²)
GEN_FAST_TOL = 1e-2
POISSON_N = 256          # steady Poisson gate size (pgmres to its f32 floor)
DIPH_N = 512
ADV_N = 512
KEYS2 = ("left", "right", "top", "bottom")

# the moving-interface path
MOV_N = 1024             # oscillating circle, f32, solver defaults p=6, s=1
MOV_SLABS = 20           # one initial slab and 20 more
MOV_TOL = 1e-5           # CG relres in f32 (the solver's 1e-10 is an f64 tol)
# error against the manufactured solution after the 21 slabs at 1024², f32:
# the largest over cells holding at least 1% of a full cell's volume at the
# end (measured 5.8e-2 on an H100, in small cut cells; 2.3e-1 at 48² in f64,
# so it is the scheme's and falls with h), and the volume-weighted L2 over
# all wet cells (measured 5.2e-4).  Cells born in the last slab as slivers
# are left out of the first: both packages leave such a cell at 0 (its
# space-time volume is under the empty threshold, so its row is an
# identity), an O(1) error (measured 0.90) in a cell of negligible volume
MOV_ERR_TOL = 0.15
MOV_L2_TOL = 1.5e-3
MOV_VOL_TOL = 1e-4       # |sum(Va) / (pi r²) - 1| of every slab
MOV_CONV_SIZES = (32, 64, 128)
FT_N = 512               # front-tracked slab: 512² mesh, 512 markers
FT_MARKERS = 512
# 1+1 slabs (1+5 before the phase-change phases; cut for the time limit)
FT_SLABS = 1

# the phase-change path
FRANK_S = 1.0            # the Frank disk: R(t) = S sqrt(t), from t0 = 1
FRANK_CENTER = (4.0, 4.0)
STEF_DT = 0.02
STEF_N = 256             # benchmarks/stefan2d_tpu.py's largest size: 256²,
STEF_MARKERS = 256       # 256 markers, f32
STEF_STEPS = 10          # 1+10 steps; the script runs 20, cut for time
STEF_RADIUS_TOL = 0.10   # that script's hard gate on the mean radius
STEF_ROUND_TOL = 0.03    # std/mean of the marker radii
STEF_SMALL = 64          # the autodiff, geometric, diphasic and
                         # Gibbs-Thomson legs: 64², 64 markers, f32,
STEF_SMALL_STEPS = 1     # 1+1 steps each, 1+2 for the two-phase leg whose
                         # gates need the growth (the JAX tests run 1+3 to 1+5)
# benchmarks/stefan1d_convergence.py's row at nx = 64: the one-phase run
# at its finest row, nx = 128, took 62.2 s on an H100, over the 60 s that
# keeps it
STEF1D_NX = 64
HEIGHT_N = (48, 192)     # 4x tests/test_stefan2d_height.py's 12 × 48,
HEIGHT_STEPS = 3         # over 1+3 of its 1+15 steps, cut for time
SPECIES_N = 256          # tests/test_concentration_binary.py's cases


def log(msg):
    print(msg, flush=True)


def sync(device):
    """Wait for the card; nothing to wait for when a phase is rehearsed on
    the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls, with CUDA
    events, after one warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def heat_problem(pt, FastHeatBE, ndim, n, dt_h2, maxiter, dtype, device,
                 cap=None):
    mesh = pt.Mesh((n,) * ndim, (L,) * ndim, (0.0,) * ndim)
    if cap is None:
        body = (pt.geometry.circle((2.0, 2.0), 1.0) if ndim == 2
                else pt.geometry.sphere((2.0, 2.0, 2.0), 1.5))
        cap = pt.compute_capacity(body, mesh, p=4, s=1, dtype=dtype,
                                  device=device)
    keys = ("left", "right", "top", "bottom", "backward", "forward")[:2 * ndim]
    borders = pt.BorderConditions({k: pt.Dirichlet(0.0) for k in keys})
    source = (lambda x, y, z, t: 0.0) if ndim == 2 else (lambda x, y, z: 0.0)
    fast = FastHeatBE(cap, pt.make_diffusion_ops(cap), 1.0, source,
                      pt.Dirichlet(1.0), borders, dt_h2 * (L / n) ** 2,
                      cg_tol=TOL if ndim == 2 else 1e-6, cg_maxiter=maxiter,
                      dtype=dtype)
    return mesh, cap, fast


def counted_steps(fast, T, n_steps):
    """``run``'s loop written out, returning the per-step CG counts."""
    T1 = T2 = T
    its = []
    for _ in range(n_steps):
        Tn, k = fast.step(T, 3.0 * T - 3.0 * T1 + T2)
        T, T1, T2 = Tn, T, T1
        its.append(int(k))
    return T, its


def check_field(name, T, shape):
    if tuple(T.shape) != tuple(shape):
        raise AssertionError(f"{name}: shape {tuple(T.shape)} != {shape}")
    if not bool(torch.isfinite(T).all()):
        raise AssertionError(f"{name}: non-finite values")
    lo, hi = T.min().item(), T.max().item()
    if lo < -0.01 or hi > 1.01:
        raise AssertionError(f"{name}: field outside [-0.01, 1.01]: "
                             f"[{lo}, {hi}]")
    return lo, hi


def phase_environment(build):
    log("== phase 1: environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    nvcc = build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}; nvcc: {ver}")
    lib = build.library_path("stencil")
    if lib.exists():
        lib.unlink()  # prove the build from the checkout's sources
    t0 = time.perf_counter()
    build.load_library("stencil")
    log(f"built {lib.name} from csrc/stencil.cu for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s")
    return smi


def phase_kernels(ks, device):
    log("== phase 2: kernels vs plain versions on the card")
    cases = [((1025, 1025), ks.stencil5_matvec, ks.stencil5_matvec_ref),
             ((1024, 1024), ks.stencil5_matvec, ks.stencil5_matvec_ref),
             ((257, 131), ks.stencil5_matvec, ks.stencil5_matvec_ref),
             ((13, 33), ks.stencil5_matvec, ks.stencil5_matvec_ref),
             ((N3D + 1,) * 3, ks.stencil7_matvec, ks.stencil7_matvec_ref),
             ((13, 33, 17), ks.stencil7_matvec, ks.stencil7_matvec_ref),
             ((8, 8, 128), ks.stencil7_matvec, ks.stencil7_matvec_ref)]
    main_err = {}
    rng = np.random.default_rng(0)
    for shape, kernel, plain in cases:
        host = [rng.standard_normal(shape) for _ in range(2 * len(shape) + 2)]
        for dtype in (torch.float32, torch.float64):
            arrays = [torch.as_tensor(a, device=device).to(dtype)
                      for a in host]
            got = kernel(*arrays)
            torch.cuda.synchronize()
            want = plain(*arrays)
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            ok = err <= KERNEL_TOL[dtype] * scale
            log(f"{kernel.__name__} {shape} {str(dtype)[6:]}: max|err| "
                f"{err:.3e} (max|y| {scale:.3e}, tol "
                f"{KERNEL_TOL[dtype]:.0e}·max|y|) {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{kernel.__name__} disagrees at {shape}")
            if dtype == torch.float32 and shape in ((1025, 1025),
                                                   (N3D + 1,) * 3):
                main_err[kernel.__name__] = err
    return main_err


def phase_main_path(pt, FastHeatBE, ks, device):
    log("== phase 3: the slice at full size on the card (f32)")
    ks.stencil5_matvec.launches = 0
    ks.stencil7_matvec.launches = 0
    rows = {}
    cap = None
    for label, (dt_h2, maxiter) in (("easy", EASY), ("stiff", STIFF)):
        t0 = time.perf_counter()
        mesh, cap, fast = heat_problem(pt, FastHeatBE, 2, N2D, dt_h2, maxiter,
                                       torch.float32, device, cap)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        vsum = cap.V.double().sum().item()
        if abs(vsum / math.pi - 1.0) > 1e-4:
            raise AssertionError(f"sum(V) = {vsum}, not within 1e-4 of pi")
        T0 = torch.zeros(mesh.np_shape, dtype=torch.float32, device=device)
        T, last, mx = fast.run_telemetry(T0, RUN_STEPS)
        lo, hi = check_field(f"2D {label}", T, mesh.np_shape)
        before = ks.stencil5_matvec.launches
        T, its = counted_steps(fast, T, COUNT_STEPS)
        check_field(f"2D {label} (counted)", T, mesh.np_shape)
        grew = ks.stencil5_matvec.launches - before
        if grew < sum(its) + COUNT_STEPS:
            raise AssertionError(f"stencil5 launches grew by {grew} over "
                                 f"{sum(its)} CG iterations")
        rows[label] = dict(its=its, T=T, fast=fast, cap=cap)
        log(f"2D {N2D}² {label} dt={dt_h2}h²: set-up {t_setup:.2f} s, "
            f"sum(V)/pi-1 = {vsum / math.pi - 1:.2e}, {RUN_STEPS} steps via "
            f"run_telemetry: CG iters/step last={int(last)} max={int(mx)}; "
            f"T in [{lo:.3e}, {hi:.6f}]; next {COUNT_STEPS} steps: CG iters "
            f"{its}, stencil5 launches +{grew}")
    mesh, cap, fast = heat_problem(pt, FastHeatBE, 3, N3D, 0.25, 32,
                                   torch.float32, device)
    vsum = cap.V.double().sum().item()
    vref = 4.0 / 3.0 * math.pi * 1.5 ** 3
    if abs(vsum / vref - 1.0) > 1e-4:
        raise AssertionError(f"3D sum(V) = {vsum}, not within 1e-4 of {vref}")
    T, last, mx = fast.run_telemetry(
        torch.zeros(mesh.np_shape, dtype=torch.float32, device=device), 50)
    lo, hi = check_field("3D", T, mesh.np_shape)
    rows["3d"] = dict(fast=fast, T=T)
    log(f"3D {N3D}³ sphere dt=0.25h²: sum(V)/ref-1 = {vsum / vref - 1:.2e}, "
        f"50 steps: CG iters/step last={int(last)} max={int(mx)}; "
        f"T in [{lo:.3e}, {hi:.6f}]")
    torch.cuda.synchronize()
    launches = {"stencil5_matvec": ks.stencil5_matvec.launches,
                "stencil7_matvec": ks.stencil7_matvec.launches}
    log(f"main-path kernel launches: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was never launched on the main path")
    return rows, launches


def _compare_capacities(cap_a, cap_b, max_flips):
    """Card against CPU, both f32.  The bound is f32 round-off as the
    geometry amplifies it: the port's own f32 build at 1024² differs from
    its f64 build by up to 1.1e-3 of a field's scale at grazing cells (B)
    with a relative L1 difference of at most 3.2e-7 (5.5e-5 for C_ga, a
    closest-point step through an f32 finite difference).  So each field
    is held to 2e-3 of its scale pointwise and to 1e-5 (C_ga 2e-4) in
    relative L1, away from cells that changed class."""
    from penguin_tpu_torch.convert import CAPACITY_FIELDS, capacity_to_numpy
    a, b = capacity_to_numpy(cap_a), capacity_to_numpy(cap_b)
    flip = a["cell_types"] != b["cell_types"]
    if int(flip.sum()) > max_flips:
        raise AssertionError(f"{int(flip.sum())} cells changed class")
    near = np.zeros_like(flip)
    for s0 in (-1, 0, 1):
        for s1 in (-1, 0, 1):
            near |= np.roll(flip, (s0, s1), (0, 1))
    report = []
    for name in CAPACITY_FIELDS:
        if name == "cell_types" or a[name] is None:
            continue
        xs = a[name] if isinstance(a[name], tuple) else (a[name],)
        ys = b[name] if isinstance(b[name], tuple) else (b[name],)
        for x, y in zip(xs, ys):
            keep = ~near if x.ndim == 2 else ~near[..., None]
            diff = np.abs(np.where(keep, x.astype(np.float64) - y, 0.0))
            rel_max = diff.max() / max(np.abs(x).max(), 1e-30)
            rel_l1 = diff.sum() / max(np.abs(x).astype(np.float64).sum(),
                                      1e-30)
            report.append(f"{name} {rel_max:.1e}/{rel_l1:.1e}")
            if rel_max > 2e-3 or rel_l1 > (2e-4 if name == "C_ga" else 1e-5):
                raise AssertionError(
                    f"capacity field {name}: card and CPU differ by "
                    f"{rel_max:.3e} of its scale, {rel_l1:.3e} in L1")
    return int(flip.sum()), ", ".join(report)


def phase_card_vs_cpu(pt, FastHeatBE, device, rows):
    log("== phase 4: card against the port's CPU path")
    cpu = torch.device("cpu")
    # 256² in f64: the same arithmetic up to summation order and FMA
    for label, (dt_h2, maxiter) in (("easy", EASY), ("stiff", STIFF)):
        out = []
        for dev in (device, cpu):
            mesh, cap, fast = heat_problem(pt, FastHeatBE, 2, 256, dt_h2,
                                           maxiter, torch.float64, dev)
            T, its = counted_steps(
                fast, torch.zeros(mesh.np_shape, dtype=torch.float64,
                                  device=dev), COUNT_STEPS)
            out.append((T.cpu().numpy(), its, fast.active.cpu().numpy()))
        (Tg, itg, act), (Tc, itc, actc) = out
        if not np.array_equal(act, actc):
            raise AssertionError("active masks differ between card and CPU")
        err = np.abs(Tg - Tc)[act].max()
        log(f"256² f64 {label}: max|T_card - T_cpu| on active cells {err:.3e}"
            f" (tol 1e-9); CG iters card {itg} cpu {itc}")
        if err > 1e-9 or itg != itc:
            raise AssertionError(f"256² f64 {label}: card and CPU disagree")
    # 1024² in f32: capacity fields and 20 easy steps
    easy = rows["easy"]
    mesh, cap_c, fast_c = heat_problem(pt, FastHeatBE, 2, N2D, *EASY,
                                       torch.float32, cpu)
    flips, report = _compare_capacities(easy["cap"], cap_c, 64)
    log(f"1024² f32 capacity: {flips} cells changed class (bound 64); "
        f"card vs CPU, max/L1 relative to each field: {report}")
    T0 = torch.zeros(mesh.np_shape, dtype=torch.float32)
    Tc, itc = counted_steps(fast_c, T0, COUNT_STEPS)
    Tg, itg = counted_steps(easy["fast"], T0.to(device), COUNT_STEPS)
    err = (Tg.cpu() - Tc).abs().max().item()
    dits = max(abs(a - b) for a, b in zip(itg, itc))
    log(f"1024² f32 easy, {COUNT_STEPS} steps: max|T_card - T_cpu| "
        f"{err:.3e} (tol 5e-4); CG iters card {itg} cpu {itc}")
    if err > 5e-4 or dits > 1:
        raise AssertionError("1024² f32: card and CPU disagree")


# ---------------------------------------------------------------------------
# the general scalar path
# ---------------------------------------------------------------------------

def bench_mono(pt, td, cap, dt, scheme="BE"):
    """DiffusionUnsteadyMono on FastHeatBE's problem: zero borders, an
    interface Dirichlet of 1, no source.  ``solve(k·dt)`` takes k steps
    after the initial solve."""
    return td.DiffusionUnsteadyMono(
        pt.Phase(cap, pt.make_diffusion_ops(cap), lambda x, y, z, t: 0.0,
                 1.0),
        pt.BorderConditions({k: pt.Dirichlet(0.0) for k in KEYS2}),
        pt.Dirichlet(1.0), dt,
        td.zero_state_mono(cap.mesh, cap.V.dtype, cap.V.device), scheme)


def poisson(pt, td, n, dtype, device, method, tol):
    """tests/test_diffusion_steady.py:39: -Δu = 4 in the unit circle at
    (2, 2), u = 0 on it; exact 1 - r².  Returns (solver, weighted L2)."""
    mesh = pt.Mesh((n, n), (L, L), (0.0, 0.0))
    cap = pt.compute_capacity(pt.geometry.circle((2.0, 2.0), 1.0), mesh,
                              dtype=dtype, device=device)
    s = td.DiffusionSteadyMono(
        pt.Phase(cap, pt.make_diffusion_ops(cap), lambda x, y, z: 4.0, 1.0),
        pt.BorderConditions({k: pt.Dirichlet(1.0) for k in KEYS2}),
        pt.Dirichlet(0.0))
    s.solve(method=method, tol=tol)
    _, _, glob, *_ = pt.check_convergence(
        lambda x, y: 1.0 - (x - 2.0) ** 2 - (y - 2.0) ** 2, s, cap, 2,
        False, verbose=False)
    return s, glob


def diph_caps(pt, n, dtype, device):
    mesh = pt.Mesh((n, n), (L, L), (0.0, 0.0))
    inside = pt.geometry.circle((2.0, 2.0), 1.0)
    return [pt.compute_capacity(b, mesh, dtype=dtype, device=device)
            for b in (inside, pt.geometry.complement(inside))]


def henry_diph(pt, td, caps, dt, steps, method, tol, steady=False):
    """Two phases of unit diffusivity with a Henry jump T1 = 0.5·T2 and
    flux continuity (the case of tests/test_diffusion_unsteady.py:31 on a
    circle); phase 2 (outside, touching the borders) starts at 1 with
    border Dirichlet 1, phase 1 (inside) at 0: the maximum principle keeps
    both in [0, 1]."""
    cap1, cap2 = caps
    ic = pt.InterfaceConditions(pt.ScalarJump(1.0, 0.5, 0.0),
                                pt.FluxJump(1.0, 1.0, 0.0))
    bc_b = pt.BorderConditions({k: pt.Dirichlet(1.0) for k in KEYS2})
    ops = [pt.make_diffusion_ops(c) for c in caps]
    if steady:
        s = td.DiffusionSteadyDiph(
            pt.Phase(cap1, ops[0], lambda x, y, z: 1.0, 1.0),
            pt.Phase(cap2, ops[1], lambda x, y, z: 0.0, 1.0), bc_b, ic)
        s.solve(method=method, tol=tol)
        return s
    z, _ = td.zero_state_mono(cap1.mesh, cap1.V.dtype, cap1.V.device)
    u0 = (z, z, z + 1.0, z + 1.0)
    s = td.DiffusionUnsteadyDiph(
        pt.Phase(cap1, ops[0], lambda x, y, z, t: 0.0, 1.0),
        pt.Phase(cap2, ops[1], lambda x, y, z, t: 0.0, 1.0), bc_b, ic, dt,
        u0, "CN")
    s.solve(steps * dt, method=method, tol=tol)
    return s


def swirl(pt, tad, caps, kind, method, tol, dt=None):
    """Advection-diffusion on the two phases of ``diph_caps`` in a swirl
    about the circle's centre, tangent to the interface; borders at 1,
    interface jumps as in ``henry_diph``.  ``kind``: "steady mono" (the
    outer phase, interface Dirichlet 0), "steady diph" or "unsteady diph"
    (CN, one step after the initial solve, from phase 1 at 0 and phase 2
    at 1)."""
    convs = []
    for c in caps:
        x, y = c.C_om[..., 0], c.C_om[..., 1]
        convs.append(pt.make_convection_ops(
            c, (-(y - 2.0), x - 2.0), (torch.zeros_like(x),) * 2))
    bc_b = pt.BorderConditions({k: pt.Dirichlet(1.0) for k in KEYS2})
    ic = pt.InterfaceConditions(pt.ScalarJump(1.0, 0.5, 0.0),
                                pt.FluxJump(1.0, 1.0, 0.0))
    if kind == "steady mono":
        s = tad.AdvectionDiffusionSteadyMono(
            pt.Phase(caps[1], convs[1], lambda x, y, z: 1.0, 0.1), bc_b,
            pt.Dirichlet(0.0))
        s.solve(method=method, tol=tol)
        return s.x, None
    if kind == "steady diph":
        s = tad.AdvectionDiffusionSteadyDiph(
            pt.Phase(caps[0], convs[0], lambda x, y, z: 1.0, 1.0),
            pt.Phase(caps[1], convs[1], lambda x, y, z: 0.0, 1.0), bc_b, ic)
        s.solve(method=method, tol=tol)
        return s.x, None
    z = torch.zeros_like(caps[0].V)
    s = tad.AdvectionDiffusionUnsteadyDiph(
        pt.Phase(caps[0], convs[0], lambda x, y, z, t: 0.0, 1.0),
        pt.Phase(caps[1], convs[1], lambda x, y, z, t: 0.0, 1.0), bc_b, ic,
        dt, (z, z, z + 1.0, z + 1.0), "CN")
    s.solve(dt, method=method, tol=tol)
    return s.x, s.krylov and s.krylov.history


def rotation(pt, tad, n, dtype, device, dt, steps, method, tol):
    """tests/test_advdiff_darcy.py:161: a Gaussian blob in solid-body
    rotation about the centre of [0, 2]², CN.  Returns (solver, mass before,
    mass after)."""
    Lr, c = 2.0, 1.0
    mesh = pt.Mesh((n, n), (Lr, Lr), (0.0, 0.0))
    cap = pt.compute_capacity(pt.geometry.full_domain(2), mesh, dtype=dtype,
                              device=device)
    x, y = cap.C_om[..., 0], cap.C_om[..., 1]
    conv = pt.make_convection_ops(cap, (-(y - c), x - c),
                                  (torch.zeros_like(x), torch.zeros_like(x)))
    blob = torch.exp(-((x - c - 0.5) ** 2 + (y - c) ** 2) / 0.02)
    blob = torch.where(cap.V == 0, 0.0, blob)
    bc0 = pt.Dirichlet(0.0)
    s = tad.AdvectionDiffusionUnsteadyMono(
        pt.Phase(cap, conv, lambda x, y, z, t: 0.0, 1e-4),
        pt.BorderConditions({k: bc0 for k in KEYS2}), bc0, dt,
        (blob, torch.zeros_like(blob)), "CN")
    s.solve(steps * dt, method=method, tol=tol)
    V = cap.V.double()
    return s, (blob.double() * V).sum().item(), \
        (s.x_omega.double() * V).sum().item()


def check_bounded(name, tensors, lo=-0.01, hi=1.01, active=None):
    for i, T in enumerate(tensors):
        if not bool(torch.isfinite(T).all()):
            raise AssertionError(f"{name}[{i}]: non-finite values")
        v = T if active is None else T[active[i]]
        a, b = v.min().item(), v.max().item()
        if a < lo or b > hi:
            raise AssertionError(f"{name}[{i}]: outside [{lo}, {hi}]: "
                                 f"[{a}, {b}]")


def phase_general(pt, device, rows, n_poisson=POISSON_N, n_diph=DIPH_N,
                  n_adv=ADV_N):
    log("== phase 5: the general scalar path on the card (f32)")
    from penguin_tpu_torch import linsolve
    from penguin_tpu_torch.solvers import advdiff as tad, diffusion as td
    easy = rows["easy"]
    cap, fast = easy["cap"], easy["fast"]
    n = cap.mesh.n[0]
    dt = EASY[0] * (L / n) ** 2
    T_fast = fast.run(torch.zeros(cap.mesh.np_shape, dtype=torch.float32,
                                  device=device), GEN_STEPS + 1)
    act = fast.active
    for method in GEN_METHODS:
        s = bench_mono(pt, td, cap, dt)
        s.solve(GEN_STEPS * dt, method=method, tol=GEN_TOL)
        check_field(f"{n}² {method}", s.x_omega, cap.mesh.np_shape)
        check_field(f"{n}² {method} (interface)", s.x_gamma,
                    cap.mesh.np_shape)
        err = (s.x_omega - T_fast)[act].abs().max().item()
        log(f"{n}² f32 DiffusionUnsteadyMono BE dt=0.25h², {method} "
            f"(tol {GEN_TOL:.0e}), 1+{GEN_STEPS} solves: Krylov iterations "
            f"{s.krylov.history}; max|T - T_FastHeatBE| on active cells "
            f"{err:.3e} (tol {GEN_FAST_TOL:.0e})")
        if err > GEN_FAST_TOL:
            raise AssertionError(f"{method}: general path and FastHeatBE "
                                 f"disagree by {err}")
    # steady Poisson: pgmres to its f32 floor, with solve_linear's defaults
    reads = linsolve.host_read.count
    t0 = time.perf_counter()
    s, glob = poisson(pt, td, n_poisson, torch.float32, device, "pgmres",
                      0.0)
    torch.cuda.synchronize()
    log(f"{n_poisson}² f32 DiffusionSteadyMono Poisson, pgmres to the f32 "
        f"floor (8 eps): weighted L2 error vs 1-r² {glob:.3e} (gate 1e-2), "
        f"{linsolve.host_read.count - reads} host reads, "
        f"{time.perf_counter() - t0:.2f} s")
    check_bounded("Poisson", s.x[:1], -0.01, 1.01)
    if not glob < 1e-2:
        raise AssertionError(f"Poisson gate: L2 error {glob}")
    # two phases with a Henry jump, a few CN steps.  Full cells obey the
    # maximum principle; small cut cells and interface values do not, in
    # the JAX package either (direct solve at 64², f64: phase-1 cut cells
    # in [-0.26, 0.33], phase-2 up to 1.19; the excursions grow as the
    # slivers shrink with h).  So each bulk field is also held in the
    # measure the method conserves: its part outside [0, 1], weighted by V,
    # is below 1e-3 of the phase's volume.  The interface unknowns are held
    # to be finite, and their Γ-weighted share outside [0, 1] is printed
    caps = diph_caps(pt, n_diph, torch.float32, device)
    dt_d = 0.25 * (L / n_diph) ** 2
    s = henry_diph(pt, td, caps, dt_d, 3, "pgmres", GEN_TOL)
    full = [c.cell_types == 1 for c in caps]
    shares = []
    for T, w in zip(s.x, (caps[0].V, caps[0].Gamma, caps[1].V,
                          caps[1].Gamma)):
        excess = torch.clamp_min(T - 1.0, 0.0) + torch.clamp_min(-T, 0.0)
        shares.append(((w.double() * excess.double()).sum()
                       / w.double().sum()).item())
    log(f"{n_diph}² f32 DiffusionUnsteadyDiph CN, Henry jump T1 = 0.5 T2, "
        f"dt=0.25h², 1+3 solves, pgmres: iterations {s.krylov.history}, "
        f"last relres {float(s.krylov.relres):.2e}; full cells: T1 in "
        f"[{s.x[0][full[0]].min().item():.4f}, "
        f"{s.x[0][full[0]].max().item():.4f}], T2 in "
        f"[{s.x[2][full[1]].min().item():.4f}, "
        f"{s.x[2][full[1]].max().item():.4f}] (bound [-0.01, 1.01]); all "
        f"unknowns in [{min(x.min().item() for x in s.x):.3f}, "
        f"{max(x.max().item() for x in s.x):.3f}]; V/Γ-weighted share "
        f"outside [0, 1] of TW1, TG1, TW2, TG2: "
        f"{', '.join(f'{v:.1e}' for v in shares)} (bound 1e-3 for TW)")
    check_bounded("diph full cells", s.x[::2], active=full)
    check_bounded("diph", s.x, -math.inf, math.inf)
    if max(shares[::2]) > 1e-3:
        raise AssertionError(f"diph: weighted share outside [0, 1] {shares}")
    # advection-diffusion: solid-body rotation, mass within 2%
    dt_a = 0.5 * (2.0 / n_adv)
    s, m0, m1 = rotation(pt, tad, n_adv, torch.float32, device, dt_a, 10,
                         "bicgstab", GEN_TOL)
    check_bounded("rotation", s.x[:1], -0.05, 1.05)
    log(f"{n_adv}² f32 AdvectionDiffusionUnsteadyMono rotation CN, "
        f"dt = h/2, 1+10 solves, bicgstab: iterations "
        f"{s.krylov.history}; mass {m0:.6e} -> {m1:.6e} "
        f"({(m1 - m0) / m0:+.2e}, bound 2e-2)")
    if not abs(m1 - m0) / m0 < 0.02:
        raise AssertionError(f"rotation: mass {m0} -> {m1}")


def general_cases(pt, td, tad, n, device):
    """(label, run) pairs for the card-vs-CPU comparison, f64: each run
    returns (state tuple, Krylov history or None)."""
    dtype = torch.float64
    mesh = pt.Mesh((n, n), (L, L), (0.0, 0.0))
    cap = pt.compute_capacity(pt.geometry.circle((2.0, 2.0), 1.0), mesh,
                              p=4, s=1, dtype=dtype, device=device)
    dt = EASY[0] * (L / n) ** 2
    caps = diph_caps(pt, n, dtype, device)
    cases = []

    def mono(method, scheme):
        s = bench_mono(pt, td, cap, dt, scheme)
        s.solve(3 * dt, method=method, tol=1e-10)
        return s.x, s.krylov.history

    for m in GEN_METHODS:
        cases.append((f"UnsteadyMono BE {m}", lambda m=m: mono(m, "BE")))
    cases.append(("UnsteadyMono CN pgmres", lambda: mono("pgmres", "CN")))
    for m in ("bicgstab", "pgmres"):
        cases.append((f"SteadyMono Poisson {m}", lambda m=m: (
            poisson(pt, td, n, dtype, device, m, 1e-10)[0].x, None)))
    cases.append(("SteadyDiph pgmres", lambda: (henry_diph(
        pt, td, caps, None, 0, "pgmres", 1e-10, steady=True).x, None)))
    # the diph pgmres takes hundreds of iterations, and the card's and the
    # CPU's rounding drift apart with each: 5.2e-10 at dt = 0.25 h² (758
    # iterations a solve, H100); dt = 0.01 h² halves the count
    cases.append(("UnsteadyDiph CN pgmres", lambda: (
        lambda s: (s.x, s.krylov.history))(henry_diph(
            pt, td, caps, 0.01 * (L / n) ** 2, 1, "pgmres", 1e-10))))
    # pgmres, whose residual falls monotonically: bicgstab's counts on this
    # convective system moved by up to 2 between card and CPU, whose
    # answers agreed to 1e-10 (H100)
    cases.append(("AdvDiffUnsteadyMono CN pgmres", lambda: (
        lambda s: (s[0].x, s[0].krylov.history))(rotation(
            pt, tad, n, dtype, device, 1.0 / n, 3, "pgmres", 1e-10))))
    # the other advection-diffusion classes by dense LU at 40² (6724
    # unknowns): at 128² the row-norm estimate zeroes a few of their rows,
    # whose 1e30 weights end pgmres after one step in both packages
    # (ROADMAP Queue 3)
    caps40 = diph_caps(pt, 40, dtype, device)
    for kind in ("steady mono", "steady diph", "unsteady diph"):
        cases.append((f"AdvDiff {kind} 40² direct", lambda kind=kind: swirl(
            pt, tad, caps40, kind, "direct", 0.0, 0.01 * (L / 40) ** 2)))
    return cases


def phase_general_card_vs_cpu(pt, device, n=128):
    log(f"== phase 6: the general path, card against the CPU path "
        f"({n}² f64)")
    from penguin_tpu_torch.solvers import advdiff as tad, diffusion as td
    card = general_cases(pt, td, tad, n, device)
    cpu = general_cases(pt, td, tad, n, torch.device("cpu"))
    for (label, run_g), (_, run_c) in zip(card, cpu):
        xg, hg = run_g()
        xc, hc = run_c()
        err = max((a.cpu() - b).abs().max().item() / max(
            b.abs().max().item(), 1.0) for a, b in zip(xg, xc))
        log(f"{label}: max|x_card - x_cpu| / scale {err:.3e} (tol 1e-9); "
            f"iterations card {hg} cpu {hc}")
        if err > 1e-9 or hg != hc:
            raise AssertionError(f"{label}: card and CPU disagree")


# ---------------------------------------------------------------------------
# the moving-interface path
# ---------------------------------------------------------------------------

def _sin(t):
    return torch.sin(t) if isinstance(t, torch.Tensor) else math.sin(t)


def osc_radius(t):
    return 1.0 + 0.5 * _sin(2 * math.pi * t)


def osc_body(x, y, t):
    """benchmarks/phaseflow/prescribed_motion.py:74: a circle at (2, 2) of
    radius 1 + 0.5 sin(2 pi t), fluid inside."""
    return torch.sqrt((x - 2.0) ** 2 + (y - 2.0) ** 2) - osc_radius(t)


def osc_phi(x, y, t):
    """The manufactured solution, on tensors or numpy arrays; ``t`` a
    float."""
    cos = torch.cos if isinstance(x, torch.Tensor) else np.cos
    return osc_radius(t) * cos(math.pi * x) * cos(math.pi * y)


def osc_source(x, y, z, t):
    return (math.pi * math.cos(2 * math.pi * t) * torch.cos(math.pi * x)
            * torch.cos(math.pi * y)
            + 2 * math.pi ** 2 * osc_phi(x, y, t))


def osc_solver(pt, n, dtype, device, scheme="BE", cls=None):
    """``MovingDiffusionUnsteadyMono`` (or ``cls``) on the oscillating
    circle: Dirichlet interface from the manufactured solution, zero
    borders, dt = 0.5 h², started at t = dt from the exact field."""
    from penguin_tpu_torch.solvers import MovingDiffusionUnsteadyMono
    mesh = pt.Mesh((n, n), (L, L), (0.0, 0.0))
    dt = 0.5 * (L / n) ** 2
    cap0 = pt.compute_capacity(lambda x, y: osc_body(x, y, dt), mesh,
                               dtype=dtype, device=device)
    C = cap0.C_om
    u0 = (osc_phi(C[..., 0], C[..., 1], dt), torch.zeros_like(cap0.V))
    solver = (cls or MovingDiffusionUnsteadyMono)(
        pt.Phase(None, None, osc_source, 1.0),
        pt.BorderConditions({k: pt.Dirichlet(0.0) for k in KEYS2}),
        pt.Dirichlet(lambda x, y, t: osc_phi(x, y, t)), dt, u0, mesh, scheme)
    return solver, mesh, dt


def osc_error(pt, solver, mesh, tf):
    """(max error on wet cells, the same over cells holding at least 1% of
    a full cell, weighted L2 over all cells) against the manufactured
    solution at ``tf``, on the static capacity there."""
    like = dict(dtype=solver.x[0].dtype, device=solver.x[0].device)
    cap_f = pt.compute_capacity(lambda x, y: osc_body(x, y, tf), mesh,
                                compute_centroids=False, **like)
    _, _, glob, *_ = pt.check_convergence(
        lambda x, y: osc_phi(x, y, tf), solver, cap_f, 2, verbose=False)
    exact = osc_phi(cap_f.C_om[..., 0], cap_f.C_om[..., 1], tf)
    err = (solver.x[0] - exact).abs()
    full = mesh.h[0] * mesh.h[1]
    return (err[cap_f.V > 0].max().item(),
            err[cap_f.V > 0.01 * full].max().item(), glob)


def phase_moving(pt, device, rows, n=MOV_N, slabs=MOV_SLABS,
                 conv_sizes=MOV_CONV_SIZES):
    log("== phase 8: the moving-interface path on the card")
    from penguin_tpu_torch.capacity import compute_capacity_spacetime
    dtype = torch.float32
    t0 = time.perf_counter()
    solver, mesh, dt = osc_solver(pt, n, dtype, device)
    # ceil((t_end - t_start)/dt) slabs after the first: half a step short of
    # the last one, so rounding cannot add a slab
    solver.solve(osc_body, dt, dt + (slabs - 0.5) * dt, tol=MOV_TOL)
    sync(device)
    wall = time.perf_counter() - t0
    its, res = solver.krylov_iters, solver.krylov_relres
    if len(its) != slabs + 1:
        raise AssertionError(f"{len(its)} slabs solved, not {slabs + 1}")
    for T in solver.x:
        if not bool(torch.isfinite(T).all()):
            raise AssertionError("moving path: non-finite values")
    if not (res <= MOV_TOL).all():
        raise AssertionError(f"moving path: relres {res} above {MOV_TOL}")
    tf = dt + (slabs + 1) * dt
    err_wet, err, glob = osc_error(pt, solver, mesh, tf)
    # each slab's start volume against the circle's area
    vsum = []
    for k in range(slabs + 1):
        t = dt + k * dt
        cap = compute_capacity_spacetime(osc_body, mesh, t, t + dt, p=6, s=1,
                                         dtype=dtype, device=device)
        vsum.append(cap.A[2][..., 0].double().sum())
    vsum = torch.stack(vsum).cpu().numpy()
    area = np.array([math.pi * osc_radius(dt + k * dt) ** 2
                     for k in range(slabs + 1)])
    vrel = np.abs(vsum / area - 1.0).max()
    log(f"{n}² f32 MovingDiffusionUnsteadyMono, oscillating circle, BE, "
        f"dt=0.5h², p=6 s=1, reduced CG tol {MOV_TOL:.0e}, 1+{slabs} slabs in "
        f"{wall:.2f} s with set-up: CG iterations {its.tolist()}; max relres "
        f"{res.max():.2e}; max|T - exact| on cells wet at the end "
        f"{err_wet:.3e}, on those holding 1% of a full cell or more "
        f"{err:.3e} (tol {MOV_ERR_TOL:.1e}), weighted L2 {glob:.3e} (tol "
        f"{MOV_L2_TOL:.1e}); max|sum(Va)/(pi r²) - 1| over the slabs "
        f"{vrel:.2e} (tol {MOV_VOL_TOL:.0e})")
    if err > MOV_ERR_TOL or glob > MOV_L2_TOL:
        raise AssertionError(f"moving path: error {err}, L2 {glob}")
    if vrel > MOV_VOL_TOL:
        raise AssertionError(f"moving path: sum(Va) off by {vrel}")
    rows["moving"] = dict(solver=solver, mesh=mesh, dt=dt)
    # grid convergence in f64 to t_end = 0.1, the solver's defaults
    errs = []
    for m in conv_sizes:
        t0 = time.perf_counter()
        s, msh, dtm = osc_solver(pt, m, torch.float64, device)
        s.solve(osc_body, dtm, 0.1)
        K = len(s.krylov_iters) - 1
        _, _, g = osc_error(pt, s, msh, dtm + (K + 1) * dtm)
        errs.append(g)
        log(f"{m}² f64 to t=0.1: {K + 1} slabs, CG iterations/slab "
            f"{s.krylov_iters.mean():.1f}, max relres "
            f"{s.krylov_relres.max():.1e}, weighted L2 error {g:.4e}, "
            f"{time.perf_counter() - t0:.1f} s")
    order = -np.polyfit(np.log(np.asarray(conv_sizes, float)),
                        np.log(errs), 1)[0]
    log(f"order over all cells, {conv_sizes}: {order:.2f} (gate > 0.9)")
    if not order > 0.9:
        raise AssertionError(f"oscillating circle: order {order}")


def front_slab(pt, n, n_markers, dtype, device, grow):
    """A circle of ``n_markers`` markers at (2, 2), radius 1, and the same
    front grown by ``grow``; the slab body interpolates their signed
    distances linearly over t in [0, T] (``params = (mk_a, mk_b, T)``)."""
    from penguin_tpu_torch.front_tracking import markers_circle, polyline_sdf
    mesh = pt.Mesh((n, n), (L, L), (0.0, 0.0))
    mk_a = markers_circle((2.0, 2.0), 1.0, n_markers, dtype=dtype,
                          device=device)
    mk_b = 2.0 + (mk_a - 2.0) * (1.0 + grow)

    def body(x, y, t, params):
        a, b, T = params
        return ((T - t) * polyline_sdf(a, x, y)
                + t * polyline_sdf(b, x, y)) / T

    return mesh, mk_a, mk_b, body


def _caps_equal(cd, cb, tol):
    """tests/test_capacity_band.py's comparison: every capacity field within
    ``tol`` absolute, the cell types equal.  Returns the largest gap."""
    worst = 0.0
    pairs = [(cd.V, cb.V), (cd.Gamma, cb.Gamma), (cd.C_om, cb.C_om),
             (cd.C_ga, cb.C_ga)]
    for fam in ("A", "B", "W"):
        pairs += list(zip(getattr(cd, fam), getattr(cb, fam)))
    for a, b in pairs:
        worst = max(worst, (a - b).abs().max().item())
    if worst > tol:
        raise AssertionError(f"band and dense builds differ by {worst}")
    if not torch.equal(cd.cell_types, cb.cell_types):
        raise AssertionError("band and dense builds classify cells apart")
    return worst


def phase_front(pt, device, rows, n=FT_N, n_markers=FT_MARKERS,
                slabs=FT_SLABS):
    log("== phase 9: front-tracked geometry, dense and narrow band")
    from penguin_tpu_torch import capacity as tc
    from penguin_tpu_torch.front_tracking import polygon_area
    from penguin_tpu_torch.solvers import MovingDiffusionUnsteadyMono
    h = L / n
    mesh, mk_a, mk_b, body = front_slab(pt, n, n_markers, torch.float64,
                                        device, 0.5 * h)
    T = 0.5 * h * h
    params = (mk_a, mk_b, T)
    kw = dict(p=4, s=1, params=params, dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    cd = tc.compute_capacity_spacetime(body, mesh, 0.0, T, **kw)
    sync(device)
    t_dense = time.perf_counter() - t0
    t0 = time.perf_counter()
    cb = tc.compute_capacity_spacetime(body, mesh, 0.0, T, band_budget="auto",
                                       **kw)
    sync(device)
    t_band = time.perf_counter() - t0
    worst = _caps_equal(cd, cb, 1e-10)
    nodes = [np.asarray(v) for v in mesh.nodes] + [np.array([0.0, T])]
    count = tc.estimate_band_budget(
        lambda *cs: body(*cs, params), nodes, tuple(mesh.n) + (1,),
        torch.float64, 2.0, spacetime=True, device=device)
    budget = tc._round_budget(count, mesh.ncells())
    va = cd.A[2][..., 0].sum().item()
    area = polygon_area(mk_a).item()
    log(f"{n}² mesh, {n_markers} markers, one slab with the front growing "
        f"by h/2, f64, p=4 s=1: dense build {t_dense:.2f} s, band build "
        f"{t_band:.2f} s (first calls); every field within {worst:.2e} "
        f"(tol 1e-10), cell types equal; band work items {count} of "
        f"{mesh.ncells()} cells ({count / mesh.ncells():.2%}), budget "
        f"{budget}; sum(Va)/polygon area - 1 = {va / area - 1:.2e} (tol "
        f"1e-3)")
    if abs(va / area - 1.0) > 1e-3:
        raise AssertionError(f"front slab: sum(Va) {va} against area {area}")
    rows["front"] = dict(mesh=mesh, body=body, params=params, T=T)
    # the solver on that front, f32: heat enters from the interface at 1
    m32 = tuple(m.float() for m in (mk_a, mk_b))
    dt = 0.5 * h * h
    span = (slabs + 2) * dt          # the final capacity's slab included

    def body_st(x, y, t):
        return body(x, y, t, (m32[0], m32[1], span))

    z = torch.zeros(mesh.np_shape, dtype=torch.float32, device=device)
    s = MovingDiffusionUnsteadyMono(
        pt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0),
        pt.BorderConditions({k: pt.Dirichlet(0.0) for k in KEYS2}),
        pt.Dirichlet(1.0), dt, (z, z), mesh, "BE")
    t0 = time.perf_counter()
    s.solve(body_st, 0.0, (slabs - 0.5) * dt, tol=MOV_TOL)
    sync(device)
    wall = time.perf_counter() - t0
    lo, hi = check_field("front-tracked mono", s.x[0], mesh.np_shape)
    if not (s.krylov_relres <= MOV_TOL).all() or len(s.krylov_iters) != \
            slabs + 1:
        raise AssertionError(f"front-tracked mono: relres {s.krylov_relres}")
    va = s.capacity_final.A[2][..., 0].double().sum().item()
    # the front at the final capacity's start, slabs·dt into the span
    lam = slabs / (slabs + 2)
    area_f = polygon_area((1.0 - lam) * mk_a + lam * mk_b).item()
    log(f"{n}² f32 MovingDiffusionUnsteadyMono on the marker front, BE, "
        f"dt=0.5h², p=6 s=1 dense builds, 1+{slabs} slabs in {wall:.2f} s: CG "
        f"iterations {s.krylov_iters.tolist()}, max relres "
        f"{s.krylov_relres.max():.2e}; T in [{lo:.3e}, {hi:.6f}]; final "
        f"sum(Va)/polygon area - 1 = {va / area_f - 1:.2e} (tol 1e-3)")
    if abs(va / area_f - 1.0) > 1e-3:
        raise AssertionError("front-tracked mono: final volume off")
    if not hi > 0.5:
        raise AssertionError("front-tracked mono: no heat entered")


def moving_cases(pt, device, n):
    """(label, run) pairs for the moving path's card-vs-CPU comparison in
    f64: each run returns (tuple of tensors, Krylov counts or None)."""
    from penguin_tpu_torch import capacity as tc
    from penguin_tpu_torch.front_tracking import (compute_volume_jacobian,
                                                  markers_circle)
    from penguin_tpu_torch.solvers import moving_diffusion as md
    f64 = torch.float64
    like = dict(dtype=f64, device=device)
    cases = []

    def mono(scheme, method):
        s, _, dt = osc_solver(pt, n, f64, device, scheme)
        s.solve(osc_body, dt, dt + 2.5 * dt, method=method, tol=1e-10)
        masks = md.moving_masks(*md.slice_spacetime(s.capacity_final)[:4],
                                1.0, 0.0)
        return s.x + tuple(m.to(f64) for m in masks), s.krylov_iters.tolist()

    cases.append(("Mono BE auto (reduced CG), fields and masks",
                  lambda: mono("BE", "auto")))
    cases.append(("Mono CN pbicgstab, fields and masks",
                  lambda: mono("CN", "pbicgstab")))

    def diph():
        # the translating circle of tests/test_moving_diffusion.py:242 at
        # 32²: a dense LU of the 4 x 65² unknowns of 64² would take most
        # of a minute per slab on the CPU
        mesh = pt.Mesh((32, 32), (L, L), (0.0, 0.0))
        b1 = lambda x, y, t: -(torch.sqrt((x - 2.0 - 0.2 * t) ** 2
                                          + (y - 2.0) ** 2) - 1.0)
        z = torch.zeros(mesh.np_shape, **like)
        s = md.MovingDiffusionUnsteadyDiph(
            pt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0),
            pt.Phase(None, None, lambda x, y, z, t: 0.0, 2.0),
            pt.BorderConditions({k: pt.Dirichlet(0.0) for k in KEYS2}),
            pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.0),
                                   pt.FluxJump(1.0, 2.0, 0.0)),
            0.01, (z + 1.0, z, z, z), mesh, "BE")
        s.solve(b1, lambda x, y, t: -b1(x, y, t), 0.0, 0.015,
                method="direct", p=4, s=1)
        return s.x, s.krylov_iters.tolist()

    cases.append(("Diph BE direct 32²", diph))

    def advdiff():
        s, mesh, dt = osc_solver(pt, n, f64, device,
                                 cls=md.MovingAdvDiffusionUnsteadyMono)
        c = pt.compute_capacity(pt.geometry.full_domain(2), mesh, p=2, s=1,
                                **like).C_om
        u = (-(c[..., 1] - 2.0), c[..., 0] - 2.0)
        s.solve(osc_body, dt, dt + 1.5 * dt, u, torch.zeros_like(u[0]),
                tol=1e-10)
        return s.x, s.krylov_iters.tolist()

    cases.append(("AdvDiffMono BE pgmres, rotating velocity", advdiff))

    def moments():
        mesh = pt.Mesh((n, n), (L, L), (0.0, 0.0))
        cap = pt.compute_capacity(pt.geometry.circle((2.01, 1.98), 1.0), mesh,
                                  cut_moments=True, **like)
        ops = pt.make_diffusion_ops(cap, cross_moment=True)
        g = torch.Generator().manual_seed(3)
        x, xg = (torch.randn(mesh.np_shape, generator=g, dtype=f64)
                 .to(device) for _ in range(2))
        out = list(ops.flux(x, xg)) + [ops.GT(ops.G(x))]
        for S_lo, X_lo, S_hi, X_hi in tc.gamma_half_moments(cap):
            out += [S_lo, X_lo, S_hi, X_hi]
        return tuple(out), None

    cases.append(("cross-moment flux, GT·G and gamma_half_moments", moments))
    cases.append(("compute_volume_jacobian 24², 32 markers", lambda: ((
        compute_volume_jacobian(
            pt.Mesh((24, 24), (L, L), (0.0, 0.0)),
            markers_circle((2.0, 2.0), 1.0, 32, **like)),), None)))
    return cases


def phase_moving_card_vs_cpu(pt, device, n=64):
    log(f"== phase 10: the moving path, card against the CPU path "
        f"({n}² f64)")
    card = moving_cases(pt, device, n)
    cpu = moving_cases(pt, torch.device("cpu"), n)
    for (label, run_g), (_, run_c) in zip(card, cpu):
        xg, hg = run_g()
        xc, hc = run_c()
        err = max((a.cpu() - b).abs().max().item() / max(
            b.abs().max().item(), 1.0) for a, b in zip(xg, xc))
        log(f"{label}: max|x_card - x_cpu| / scale {err:.3e} (tol 1e-9); "
            f"iterations card {hg} cpu {hc}")
        if err > 1e-9 or hg != hc:
            raise AssertionError(f"{label}: card and CPU disagree")


# ---------------------------------------------------------------------------
# the phase-change path (phases 11-13)
# ---------------------------------------------------------------------------

def frank_problem(pt, n, n_markers, dtype, device, bc_i=None, diph=False):
    """The Frank disk of benchmarks/stefan2d_tpu.py:23-80: a solid disk of
    radius S·sqrt(t0) at (4, 4) in an 8 × 8 box grows into liquid
    undercooled to T_inf, held on the borders; the interface is at the
    melting temperature 0 and the liquid starts from the similarity solution
    at t0 = 1 on the liquid capacity's centroids.  Returns (solver, front,
    ic): ``StefanMono2D`` with ``bc_i`` (default Dirichlet 0), or
    ``StefanDiph2D`` with the solid as phase 1 at 0."""
    from scipy.special import exp1
    from penguin_tpu_torch.front_tracking import FrontTracker
    from penguin_tpu_torch.solvers.stefan2d import StefanDiph2D, StefanMono2D
    like = dict(dtype=dtype, device=device)
    q = FRANK_S ** 2 / 4
    T_inf = -q * math.exp(q) * exp1(q)   # the undercooling St of S
    mesh = pt.Mesh((n, n), (8.0, 8.0), (0.0, 0.0))
    front = FrontTracker(**like).create_circle(FRANK_CENTER, FRANK_S,
                                               n=n_markers)
    cap0 = pt.compute_capacity(lambda x, y: -front.sdf(x, y), mesh, p=4, s=1,
                               **like)
    C = cap0.C_om.double().cpu().numpy()
    r = np.hypot(C[..., 0] - FRANK_CENTER[0], C[..., 1] - FRANK_CENTER[1])
    Tw = np.where(r >= FRANK_S, T_inf * (
        1 - exp1(np.maximum(r ** 2 / 4, 1e-9)) / exp1(q)), 0.0)
    Tw = torch.as_tensor(Tw, **like)
    z = torch.zeros_like(Tw)
    bc_b = pt.BorderConditions({k: pt.Dirichlet(float(T_inf))
                                for k in KEYS2})
    phase = pt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    ic = pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.0),
                                pt.FluxJump(1.0, 1.0, 1.0))
    if diph:
        return (StefanDiph2D(phase, phase, bc_b, ic, STEF_DT, (z, z, Tw, z),
                             mesh, "BE"), front, ic)
    return (StefanMono2D(phase, bc_b, bc_i or pt.Dirichlet(0.0), STEF_DT,
                         (Tw, z), mesh, "BE"), front, ic)


def frank_radius(markers):
    """(mean radius about the centre, std/mean) of a marker front."""
    mk = markers.double().cpu().numpy()
    r = np.hypot(mk[:, 0] - FRANK_CENTER[0], mk[:, 1] - FRANK_CENTER[1])
    return float(r.mean()), float(r.std() / r.mean())


def frank_exact(steps_solved):
    return FRANK_S * math.sqrt(1.0 + steps_solved * STEF_DT)


def check_front(label, s):
    """Markers and the per-step residuals finite; returns (mean radius,
    roundness, similarity radius, relative error)."""
    if not bool(torch.isfinite(s.markers).all()):
        raise AssertionError(f"{label}: non-finite markers")
    if not np.isfinite(s.residual_log).all():
        raise AssertionError(f"{label}: non-finite residuals "
                             f"{s.residual_log}")
    R, rnd = frank_radius(s.markers)
    R_ex = frank_exact(len(s.residual_log))
    return R, rnd, R_ex, R / R_ex - 1.0


def phase_stefan(pt, ks, device, rows, n=STEF_N, n_markers=STEF_MARKERS,
                 steps=STEF_STEPS, small=STEF_SMALL,
                 small_steps=STEF_SMALL_STEPS):
    log("== phase 11: the marker Stefan flagship at full width on the card "
        "(f32)")
    f32 = torch.float32
    gn = dict(interior_fluid=False, method="auto", p=4, s=1)
    ks.stencil5_matvec.launches = 0
    ks.stencil7_matvec.launches = 0
    s, front, ic = frank_problem(pt, n, n_markers, f32, device)
    sync(device)
    t0 = time.perf_counter()
    s.solve(front, 0.0, (steps - 0.5) * STEF_DT, ic,
            newton_params=(8, 1e-4, 1e-6, 1.0), jac="intercept",
            band_budget="auto", **gn)
    sync(device)
    wall = time.perf_counter() - t0
    launches = {"stencil5_matvec": ks.stencil5_matvec.launches,
                "stencil7_matvec": ks.stencil7_matvec.launches}
    R, rnd, R_ex, rel = check_front("flagship", s)
    its = s.iters_log
    log(f"{n}² mesh, {n_markers} markers, f32, dt={STEF_DT}, BE, intercept "
        f"Jacobian, band budget {s._band_budget}: 1+{steps} steps in "
        f"{wall:.2f} s with set-up, GN iterations/step {its.tolist()} "
        f"({its.sum()} in all, {wall / its.sum() * 1e3:.1f} ms each), "
        f"Krylov iterations/step {s.krylov_iters.tolist()}, final GN "
        f"residuals {np.array2string(s.residual_log, precision=3)}; mean "
        f"radius {R:.5f} against S·sqrt(t0 + K·dt) = {R_ex:.5f}: "
        f"{rel:+.3%} (gate ±{STEF_RADIUS_TOL:.0%}); std/mean {rnd:.4f} "
        f"(gate {STEF_ROUND_TOL}); stencil kernels launched on this path: "
        f"{launches} (it reaches no TPU kernel)")
    if abs(rel) > STEF_RADIUS_TOL or rnd > STEF_ROUND_TOL:
        raise AssertionError(f"flagship: radius {R} against {R_ex}, "
                             f"roundness {rnd}")
    rows["stefan"] = dict(solver=s, wall=wall)
    R0 = FRANK_S
    def leg(steps=small_steps, **kw):
        """A 64² f32 Frank disk solved over 1+``steps`` steps: (solver,
        wall seconds)."""
        span = (steps - 0.5) * STEF_DT
        s, front, ic = frank_problem(pt, small, small, f32, device,
                                     bc_i=kw.pop("bc_i", None),
                                     diph=kw.pop("diph", False))
        sync(device)
        t0 = time.perf_counter()
        if kw.pop("geom", False):
            s.solve_geom(front, 0.0, span, ic, **gn)
        elif isinstance(s, StefanDiph2D):
            s.solve(front, 0.0, span, **kw)
        else:
            s.solve(front, 0.0, span, ic, **gn, **kw)
        sync(device)
        return s, time.perf_counter() - t0

    from penguin_tpu_torch.solvers.stefan2d import StefanDiph2D
    s, wall = leg(newton_params=(8, 1e-4, 1e-6, 1.0), jac="autodiff")
    if not bool(torch.isfinite(s.markers).all()):
        raise AssertionError("autodiff leg: non-finite markers")
    R, rnd = frank_radius(s.markers)
    R_ex = frank_exact(len(s.iters_log))
    its = s.iters_log
    log(f"{small}² × {small} markers f32, autodiff Jacobian, 1+{small_steps} "
        f"steps in {wall:.2f} s: GN iterations/step {its.tolist()} "
        f"({wall / its.sum() * 1e3:.1f} ms each), final GN residuals "
        f"{np.array2string(s.residual_log, precision=3)}; radius {R:.5f} "
        f"against {R_ex:.5f}: {R / R_ex - 1:+.3%} (reported: the JAX package "
        f"treats f32 autodiff convergence as marginal), std/mean {rnd:.4f}")
    if not R > R0:
        raise AssertionError(f"autodiff leg: the front did not grow ({R})")
    rows["stefan_ad"] = dict(wall=wall, iters=int(its.sum()), solver=s)
    s, wall = leg(geom=True)
    R, rnd, R_ex, rel = check_front("solve_geom", s)
    log(f"{small}² solve_geom, 1+{small_steps} steps in {wall:.2f} s: "
        f"iterations/step {s.iters_log.tolist()}; radius {R:.5f} against "
        f"{R_ex:.5f}: {rel:+.3%} (gate ±{STEF_RADIUS_TOL:.0%}), std/mean "
        f"{rnd:.4f}")
    if not R > R0 or abs(rel) > STEF_RADIUS_TOL:
        raise AssertionError(f"solve_geom: radius {R} against {R_ex}")
    # the diphasic disk with tests/test_stefan2d_diph.py's settings and gates
    s, wall = leg(steps=small_steps + 1, diph=True,
                  newton_params=(12, 1e-4, 1e-6, 1.0),
                  interior_phase1=True, latent_sign=-1.0,
                  enable_stencil_fusion=False, smooth_window=5,
                  smooth_passes=1, extrapolation_factor=0.5,
                  jac="intercept", p=4, s=1)
    R, rnd, R_ex, rel = check_front("StefanDiph2D", s)
    log(f"{small}² StefanDiph2D, latent_sign -1, intercept, "
        f"1+{small_steps + 1} steps in {wall:.2f} s: GN iterations/step "
        f"{s.iters_log.tolist()}, "
        f"last residual {s.residual_log[-1]:.3e} (gate 0.05); radius "
        f"{R:.5f} (gate > {R0 + 0.02}) against {R_ex:.5f}: {rel:+.3%} (gate "
        f"±3%), std/mean {rnd:.4f} (gate 0.02)")
    if not (R > R0 + 0.02 and rnd < 0.02 and abs(rel) < 0.03
            and s.residual_log[-1] < 0.05):
        raise AssertionError("StefanDiph2D gates failed")
    # Gibbs-Thomson: curvature and kinetic undercooling each slow growth
    # (tests/test_stefan2d.py:221,274).  Gated on the markers only: in f32
    # the curvature run's GN residual grows step by step and an inner CG
    # ends in NaN by the fourth step, in the JAX package too (ROADMAP
    # Queue 3), and whether the disk still grows is printed, not gated
    radii, res = {}, {}
    for label, gt in (("eps=0", (0.0, 0.0)), ("eps_k=0.1", (0.1, 0.0)),
                      ("eps_v=0.2", (0.0, 0.2))):
        s, wall = leg(bc_i=pt.GibbsThomson(0.0, *gt),
                      newton_params=(10, 1e-4, 1e-6, 1.0), jac="intercept")
        if not bool(torch.isfinite(s.markers).all()):
            raise AssertionError(f"{label}: non-finite markers")
        radii[label] = frank_radius(s.markers)[0]
        res[label] = np.array2string(s.residual_log, precision=3)
    base = radii["eps=0"]
    log(f"{small}² Gibbs-Thomson, 1+{small_steps} steps: mean radii {radii} "
        f"(gate: eps_k below eps=0 by 1e-4, eps_v by 1e-5; above the start "
        f"radius {R0}: "
        f"{ {k: r > R0 for k, r in radii.items()} }); final GN residuals "
        f"{res}")
    if not (radii["eps_k=0.1"] < base - 1e-4
            and radii["eps_v=0.2"] < base - 1e-5):
        raise AssertionError(f"Gibbs-Thomson gates failed: {radii}")


def stefan1d_convergence_row(nx):
    """The row of benchmarks/stefan1d_convergence.csv for ``nx``: (one-phase
    front error, two-phase front error)."""
    import csv
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "stefan1d_convergence.csv")
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            if int(row["nx"]) == nx:
                return float(row["front_err_1ph"]), float(row["front_err_2ph"])
    raise AssertionError(f"no row for nx={nx} in {path}")


def stefan1d_problem(pt, nx, dt, t_start, device, two_phase=False,
                     cls=None):
    """benchmarks/stefan1d_convergence.py:39-101 (and
    tests/test_stefan1d.py): the one-phase Stefan problem with T0 = 1 at
    x = 0, St = 1, or the two-phase Neumann problem (St_l = 1, St_s = 0.2),
    on [0, 2] from the similarity solution at ``t_start``, in f64.  Returns
    (solver, xf0, ic, λ)."""
    from scipy.special import erf, erfc
    from penguin_tpu_torch.solvers import stefan1d as s1
    like = dict(dtype=torch.float64, device=device)
    mesh = pt.Mesh((nx,), (2.0,), (0.0,))
    ic = pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.0),
                                pt.FluxJump(1.0, 1.0, 1.0))
    phase = pt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    if two_phase:
        lam = s1.find_lambda_stefan_two_phase(1.0, 0.2)
    else:
        lam = s1.find_lambda_stefan(1.0)
    xf0 = 2 * lam * math.sqrt(t_start)
    C = pt.compute_capacity(pt.geometry.halfspace(0, xf0), mesh,
                            **like).C_om[..., 0].cpu().numpy()
    sq = 2 * np.sqrt(t_start)
    if two_phase:
        T1 = np.where(C <= xf0, 1.0 - erf(C / sq) / erf(lam), 0.0)
        T2 = np.where(C >= xf0, -0.2 * (1 - erfc(C / sq) / erfc(lam)), 0.0)
        z = np.zeros_like(T1)
        u0 = tuple(torch.as_tensor(a, **like) for a in (T1, z, T2, z))
        bc_b = pt.BorderConditions({"bottom": pt.Dirichlet(1.0),
                                    "top": pt.Dirichlet(-0.2)})
        return (s1.MovingLiquidDiffusionUnsteadyDiph(
            phase, phase, bc_b, ic, dt, u0, mesh, "BE"), xf0, ic, lam)
    Tw = np.maximum(1.0 - erf(C / sq) / erf(lam), 0.0)
    u0 = (torch.as_tensor(Tw, **like), torch.zeros(Tw.shape, **like))
    bc_b = pt.BorderConditions({"bottom": pt.Dirichlet(1.0),
                                "top": pt.Dirichlet(0.0)})
    cls = cls or s1.MovingLiquidDiffusionUnsteadyMono
    return (cls(phase, bc_b, pt.Dirichlet(0.0), dt, u0, mesh, "BE"), xf0, ic,
            lam)


def height_problem(pt, nx, ny, device, diph=False):
    """tests/test_stefan2d_height.py's flat front, f64: (solver, h0, ic)."""
    from scipy.special import erf
    from penguin_tpu_torch.solvers import stefan1d as s1
    from penguin_tpu_torch.solvers import stefan2d_height as sh
    like = dict(dtype=torch.float64, device=device)
    lam = s1.find_lambda_stefan(1.0)
    hf0 = 2 * lam * math.sqrt(0.05)
    mesh = pt.Mesh((nx, ny), (0.6, 2.0), (0.0, 0.0))
    C = pt.compute_capacity(pt.geometry.halfspace(1, hf0), mesh, p=4, s=1,
                            **like).C_om[..., 1].cpu().numpy()
    Tw = torch.as_tensor(np.maximum(1.0 - erf(C / (2 * np.sqrt(0.05)))
                                    / erf(lam), 0.0), **like)
    z = torch.zeros_like(Tw)
    bc_b = pt.BorderConditions({"left": pt.Dirichlet(1.0),
                                "right": pt.Dirichlet(0.0)})
    ph = pt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    ic = pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.0),
                                pt.FluxJump(1.0, 1.0, 1.0))
    if diph:
        s = sh.MovingLiquidDiffusionUnsteadyDiph2D(ph, ph, bc_b, ic, 2e-3,
                                                   (Tw, z, z, z), mesh, "BE")
    else:
        s = sh.MovingLiquidDiffusionUnsteadyMono2D(ph, bc_b, pt.Dirichlet(0.0),
                                                   2e-3, (Tw, z), mesh, "BE")
    return s, torch.full((nx,), hf0, **like), ic


def phase_stefan_more(pt, device, rows, nx1d=STEF1D_NX, height=HEIGHT_N,
                      nx_species=SPECIES_N):
    log("== phase 12: the 1D, height-function and species solvers on the "
        "card (f64)")
    from penguin_tpu_torch.solvers import stefan1d as s1
    want = stefan1d_convergence_row(nx1d)
    dt = 0.4 * (2.0 / nx1d) * 0.05
    for two_phase in (False, True):
        s, xf0, ic, lam = stefan1d_problem(pt, nx1d, dt, 0.05, device,
                                           two_phase)
        sync(device)
        t0 = time.perf_counter()
        if two_phase:
            s.solve(xf0, 0.05, 0.13, newton_params=(200, 1e-10, 1e-10, 1.0),
                    p=6, s=1)
        else:
            s.solve(xf0, 0.05, 0.13, ic,
                    newton_params=(200, 1e-10, 1e-10, 1.0))
        sync(device)
        wall = time.perf_counter() - t0
        t_eff = 0.05 + len(s.xf_log) * dt
        err = abs(s.xf - 2 * lam * math.sqrt(t_eff))
        rec = want[1 if two_phase else 0]
        label = "two-phase" if two_phase else "one-phase"
        its = int(s.newton_iters.sum())
        log(f"1D {label} Stefan, nx={nx1d}, dt={dt:.4e}, t 0.05 -> 0.13: "
            f"{len(s.xf_log)} slabs, {its} Newton iterations in {wall:.2f} s "
            f"({wall / its * 1e3:.2f} ms each); front error {err:.4e} "
            f"against the recorded {rec:.4e} (gate 1.5x); max Newton "
            f"residual {s.newton_errs.max():.2e} (gate 1e-8)")
        if err > 1.5 * rec or s.newton_errs.max() >= 1e-8:
            raise AssertionError(f"1D {label} Stefan gates failed")
        if not two_phase:
            rows["stefan1d"] = dict(solver=s, ic=ic, wall=wall, iters=its,
                                    dt=dt)
    # tests/test_stefan1d.py's coupled Newton and adaptive driver
    s, xf0, ic, lam = stefan1d_problem(
        pt, 48, 2e-3, 0.05, device,
        cls=s1.MovingLiquidDiffusionUnsteadyMonoCoupled)
    s.solve(xf0, 0.05, 0.08, ic, newton_params=(30, 1e-9, 1e-9, 1.0))
    ex = 2 * lam * math.sqrt(0.05 + len(s.xf_log) * 2e-3)
    log(f"1D coupled Newton, nx=48: front {s.xf:.6f} against {ex:.6f} (gate "
        f"0.03), Newton iterations {s.newton_iters.tolist()}, max residual "
        f"{s.newton_errs.max():.2e} (gate 1e-6)")
    if not (s.xf > xf0 + 0.005 and abs(s.xf - ex) < 0.03
            and s.newton_errs.max() < 1e-6):
        raise AssertionError("1D coupled Newton gates failed")
    s, xf0, ic, lam = stefan1d_problem(pt, 48, 5e-4, 0.05, device)
    s1.solve_stefan_1d_adaptive(s, xf0, 0.05, 0.08, ic,
                                newton_params=(100, 1e-10, 1e-10, 1.0),
                                cfl_target=0.4, dt_min=1e-5, dt_max=5e-3,
                                max_steps=300)
    ex = 2 * lam * math.sqrt(0.08)
    log(f"1D adaptive dt, nx=48: {s.n_steps} steps, t_final {s.t_final!r} "
        f"(t_end 0.08), front {s.xf:.6f} against {ex:.6f} (gate 0.03)")
    if abs(s.t_final - 0.08) > 1e-9 or abs(s.xf - ex) > 0.03:
        raise AssertionError("1D adaptive driver gates failed")
    # the height-function flat front at 4x tests/test_stefan2d_height.py's
    # resolution, with its gates
    nxh, nyh = height
    for diph in (False, True):
        s, h0, ic = height_problem(pt, nxh, nyh, device, diph)
        t0 = time.perf_counter()
        args = (h0, 0.0, (HEIGHT_STEPS - 0.5) * 2e-3) + (
            () if diph else (ic,))
        s.solve(*args, newton_params=(60, 1e-9, 1e-9, 1.0), p=4, s=1)
        sync(device)
        wall = time.perf_counter() - t0
        lam = s1.find_lambda_stefan(1.0)
        ex = 2 * lam * math.sqrt(0.05 + s.height_log.shape[0] * 2e-3)
        mono = bool(np.all(np.diff(s.height_log.mean(axis=1)) > -1e-10))
        x2 = float(s.x[2].abs().max()) if diph else 0.0
        label = "diph" if diph else "mono"
        log(f"height-function {label} {nxh} × {nyh}, "
            f"{s.height_log.shape[0]} steps in "
            f"{wall:.2f} s: iterations/step {s.newton_iters.tolist()}; mean "
            f"height {s.heights.mean():.5f} against {ex:.5f} (gate 0.03), "
            f"std {s.heights.std():.2e} (gate 5e-3), monotone {mono}"
            + (f", max|T2| {x2:.1e} (gate 1e-6)" if diph else ""))
        if not (mono and abs(s.heights.mean() - ex) < 0.03
                and s.heights.std() < 5e-3 and x2 < 1e-6):
            raise AssertionError(f"height-function {label} gates failed")
    # tests/test_concentration_binary.py's static interfaces at nx_species
    from penguin_tpu_torch.solvers import binary, concentration
    like = dict(dtype=torch.float64, device=device)
    nxs = nx_species
    mesh = pt.Mesh((nxs,), (8.0,), (0.0,))
    z = torch.zeros(mesh.np_shape, **like)
    ph = pt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
    body, body_c = (lambda x, t: x - 4.0), (lambda x, t: -(x - 4.0))
    s = concentration.DiffusionUnsteadyConcentration(
        ph, ph, pt.BorderConditions({"bottom": pt.Dirichlet(0.0),
                                     "top": pt.Dirichlet(1.0)}),
        pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.5),
                               pt.FluxJump(1.0, 1.0, 0.0)),
        2e-3, (z, z, z + 1.0, z + 1.0), mesh)
    t0 = time.perf_counter()
    s.solve(body, body_c, 0.0, 0.05, method="direct")
    C1, C1g, C2, C2g = (a.cpu().numpy() for a in s.x)
    n1 = nxs // 2
    ok = (np.isfinite(C1).all() and np.isfinite(C2).all()
          and np.abs(C1g - 0.5).max() < 1e-10
          and np.abs(C2g - 0.5).max() < 1e-10
          and C1[1:n1].min() > -1e-8 and C1[1:n1].max() < 0.5 + 1e-8
          and C2[n1 + 1:nxs - 1].max() < 1.0 + 1e-8
          and C2[n1 + 1:nxs - 1].min() > 0.5 - 1e-8)
    log(f"DiffusionUnsteadyConcentration, static interface, nx={nxs}, 26 "
        f"slabs in {time.perf_counter() - t0:.2f} s: C1 in "
        f"[{C1[1:n1].min():.3e}, {C1[1:n1].max():.6f}], C2 in [{C2[n1 + 1:nxs - 1].min():.6f}, "
        f"{C2[n1 + 1:nxs - 1].max():.6f}], max|Cγ - Cm| "
        f"{max(np.abs(C1g - 0.5).max(), np.abs(C2g - 0.5).max()):.1e}")
    if not ok:
        raise AssertionError("concentration gates failed")
    bc_T = pt.BorderConditions({"bottom": pt.Dirichlet(-0.5),
                                "top": pt.Dirichlet(0.5)})
    bc_C = pt.BorderConditions({"bottom": pt.Dirichlet(0.2),
                                "top": pt.Dirichlet(0.8)})
    s = binary.DiffusionUnsteadyBinary(ph, ph, ph, ph, bc_T, bc_C, 2e-3,
                                       (z,) * 8, mesh, "BE", Tm=0.1,
                                       m_liq=-0.5, k_part=0.6)
    t0 = time.perf_counter()
    s.solve(body, body_c, 0.0, 0.02, method="direct")
    T1w, T1g, T2w, T2g, C1w, C1g, C2w, C2g = (a.cpu().numpy() for a in s.x)
    sel = pt.compute_capacity(pt.geometry.halfspace(0, 4.0), mesh,
                              **like).cell_types.cpu().numpy() == -1
    gaps = [np.abs(T1g - (0.1 - 0.5 * C1g))[sel].max(),
            np.abs(T2g - T1g)[sel].max(), np.abs(C2g - 0.6 * C1g)[sel].max()]
    finite = all(np.isfinite(a).all() for a in (T1w, T2w, C1w, C2w))
    log(f"DiffusionUnsteadyBinary, static interface, nx={nxs}, 11 slabs in "
        f"{time.perf_counter() - t0:.2f} s: {int(sel.sum())} cut cells; "
        f"liquidus, continuity, partition gaps {gaps} (gate 1e-8)")
    if not (finite and sel.any() and max(gaps) < 1e-8):
        raise AssertionError("binary gates failed")


def stefan_cases(pt, device):
    """(label, run) pairs for the phase-change path's card-vs-CPU comparison
    in f64: each run returns (tuple of tensors, iteration counts)."""
    from penguin_tpu_torch.front_tracking import polyline_normals
    from penguin_tpu_torch.solvers import binary, concentration
    from penguin_tpu_torch.solvers import stefan1d as s1
    from penguin_tpu_torch.solvers import stefan2d as s2
    f64 = torch.float64
    n, nm = 24, 24
    few = (3, 1e-6, 1e-6, 1.0)
    cases = []

    def as_t(a):
        return torch.as_tensor(np.asarray(a), dtype=f64)

    def mono1d(cls, strategy):
        def run():
            s, xf0, ic, _ = stefan1d_problem(pt, 24, 2e-3, 0.05, device,
                                             cls=getattr(s1, cls))
            kw = {} if strategy is None else {"lr_strategy": strategy}
            s.solve(xf0, 0.05, 0.05 + 1.5 * 2e-3, ic,
                    newton_params=(30, 1e-10, 1e-10, 1.0), **kw)
            return s.x + (as_t(s.xf_log),), s.newton_iters.tolist()
        return run

    cases.append(("1D Mono, secant steps", mono1d(
        "MovingLiquidDiffusionUnsteadyMono", "secant")))
    cases.append(("1D MonoCoupled", mono1d(
        "MovingLiquidDiffusionUnsteadyMonoCoupled", None)))

    def diph1d():
        s, xf0, _, _ = stefan1d_problem(pt, 24, 1e-3, 0.05, device, True)
        s.solve(xf0, 0.05, 0.05 + 1.5e-3,
                newton_params=(200, 1e-10, 1e-10, 1.0))
        return s.x + (as_t(s.xf_log),), s.newton_iters.tolist()

    cases.append(("1D Diph", diph1d))

    def adaptive():
        s, xf0, ic, _ = stefan1d_problem(pt, 24, 5e-4, 0.05, device)
        s1.solve_stefan_1d_adaptive(s, xf0, 0.05, 0.054, ic,
                                    newton_params=(100, 1e-10, 1e-10, 1.0),
                                    cfl_target=0.4, dt_min=1e-5,
                                    dt_max=5e-3)
        return s.x + (as_t([s.xf, s.t_final]),), [s.n_steps]

    cases.append(("1D adaptive driver", adaptive))

    def mono2d(jac, bc_i=None):
        def run():
            s, front, ic = frank_problem(pt, n, nm, f64, device, bc_i=bc_i)
            s.solve(front, 0.0, 0.5 * STEF_DT, ic, newton_params=few,
                    interior_fluid=False, jac=jac)
            hist = as_t(np.nan_to_num(s.residual_hist, nan=-1.0))
            return (s.x + (s.markers, hist),
                    s.iters_log.tolist() + s.krylov_iters.tolist())
        return run

    cases.append(("StefanMono2D intercept", mono2d("intercept")))
    cases.append(("StefanMono2D autodiff", mono2d("autodiff")))
    cases.append(("StefanMono2D Gibbs-Thomson eps_k 0.1, eps_v 0.2",
                  mono2d("intercept", pt.GibbsThomson(0.0, 0.1, 0.2))))

    def geom():
        s, front, ic = frank_problem(pt, n, nm, f64, device)
        s.solve_geom(front, 0.0, 0.5 * STEF_DT, ic, newton_params=few,
                     interior_fluid=False)
        return s.x + (s.markers,), s.iters_log.tolist()

    cases.append(("StefanMono2D.solve_geom", geom))

    def diph2d():
        s, front, _ = frank_problem(pt, n, nm, f64, device, diph=True)
        s.solve(front, 0.0, 0.5 * STEF_DT, newton_params=few,
                latent_sign=-1.0, enable_stencil_fusion=False,
                jac="intercept")
        return s.x + (s.markers,), s.iters_log.tolist()

    cases.append(("StefanDiph2D intercept", diph2d))

    def jacobians():
        s, front, _ = frank_problem(pt, n, nm, f64, device)
        mk = front.markers
        normals = polyline_normals(mk)
        d = 0.05 * torch.cos(3 * torch.arange(nm, dtype=f64, device=device))
        budget = s2._auto_band_budget(mk, s.mesh, STEF_DT, -1.0, "auto")
        out = [s2._jacobian_fn(jac, s.mesh, -1.0, -1.0, True, 4, 1, b)(
            d, mk, normals) for jac, b in (("autodiff", None),
                                           ("autodiff", budget),
                                           ("intercept", None))]
        slab = s._slab_solver(-1.0, budget, 4, 1, "auto", 1e-9, 400)
        T, flux, Va, Vb, its = slab(s.u0, mk, mk + d[:, None] * normals, 0.0)
        F = s2._box3_filter(Va - Vb - flux)
        return tuple(out) + (F,) + T, [its]

    cases.append(("both volume Jacobians (dense, band) and one GN residual",
                  jacobians))

    def height(diph):
        def run():
            s, h0, ic = height_problem(pt, 6, 24, device, diph)
            args = (h0, 0.0, 1e-3) + (() if diph else (ic,))
            s.solve(*args, newton_params=(60, 1e-9, 1e-9, 1.0))
            return s.x + (as_t(s.height_log),), s.newton_iters.tolist()
        return run

    cases.append(("height-function Mono2D", height(False)))
    cases.append(("height-function Diph2D", height(True)))

    def species():
        like = dict(dtype=f64, device=device)
        mesh = pt.Mesh((24,), (8.0,), (0.0,))
        z = torch.zeros(mesh.np_shape, **like)
        ph = pt.Phase(None, None, lambda x, y, z, t: 0.0, 1.0)
        bc = pt.BorderConditions({"bottom": pt.Dirichlet(0.0),
                                  "top": pt.Dirichlet(1.0)})
        body = lambda x, t: x - 4.1 - 5.0 * t  # noqa: E731
        body_c = lambda x, t: 4.1 + 5.0 * t - x  # noqa: E731
        c = concentration.DiffusionUnsteadyConcentration(
            ph, ph, bc, pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.5),
                                               pt.FluxJump(1.0, 1.0, 0.0)),
            2e-3, (z, z, z + 1.0, z + 1.0), mesh)
        c.solve(body, body_c, 0.0, 0.01)
        b = binary.DiffusionUnsteadyBinary(ph, ph, ph, ph, bc, bc, 2e-3,
                                           (z,) * 8, mesh, "BE", Tm=0.1,
                                           m_liq=-0.5, k_part=0.6)
        b.solve(body, body_c, 0.0, 0.01)
        return c.x + b.x, []

    cases.append(("Concentration and Binary, moving interface", species))
    return cases


def phase_stefan_card_vs_cpu(pt, device):
    log("== phase 13: the phase-change path, card against the CPU path "
        "(f64)")
    card = stefan_cases(pt, device)
    cpu = stefan_cases(pt, torch.device("cpu"))
    for (label, run_g), (_, run_c) in zip(card, cpu):
        xg, hg = run_g()
        xc, hc = run_c()
        err = max((a.cpu() - b).abs().max().item() / max(
            b.abs().max().item(), 1.0) for a, b in zip(xg, xc))
        log(f"{label}: max|x_card - x_cpu| / scale {err:.3e} (tol 1e-8); "
            f"iterations card {hg} cpu {hc}")
        if not err <= 1e-8 or hg != hc:
            raise AssertionError(f"{label}: card and CPU disagree")


def stefan_times(pt, rows, smi, device):
    """The flagship's GN iteration at 256², split into slab capacity build,
    inner solve, intercept Jacobian and LM update, with kernels, host syncs,
    device busy share and peak memory; ms per GN iteration of the 64²
    autodiff leg; ms per Newton iteration of the 1D solve."""
    from penguin_tpu_torch.capacity import compute_capacity_spacetime
    from penguin_tpu_torch.front_tracking import polyline_normals
    from penguin_tpu_torch.solvers import stefan2d as s2
    from penguin_tpu_torch.solvers.moving_diffusion import (
        solve_moving_mono_step)
    s = rows["stefan"]["solver"]
    its = s.iters_log.copy()
    mesh, dt = s.mesh, s.dt
    n = mesh.n[0]
    mk_a = torch.as_tensor(s.marker_log[-2], device=device)
    normals = polyline_normals(mk_a)
    # one step's growth, the size of a converged displacement
    d = torch.full((mk_a.shape[0],), frank_radius(s.markers)[0]
                   - frank_radius(mk_a)[0], dtype=mk_a.dtype, device=device)
    mk_b = mk_a + d[:, None] * normals
    budget = s._band_budget
    src = s.phase.source
    lam = torch.full((), 1e-4, dtype=mk_a.dtype, device=device)
    max_disp = 0.5 * min(mesh.h)
    state = {}

    def build():
        state["cap"] = compute_capacity_spacetime(
            s2._st_marker_body, mesh, 0.0, dt, p=4, s=1,
            params=(mk_a, mk_b, dt, -1.0), band_budget=budget,
            dtype=mk_a.dtype, device=device)

    def solve():
        state["T"] = solve_moving_mono_step(
            state["cap"], 1.0, src, s.bc_i, s.border, s.x, 0.0, dt, "BE",
            tol=1e-9, maxiter=400, method="auto")[0]

    def jac():
        state["J"] = s2._intercept_jacobian(d, mk_a, normals, mesh, 1.0,
                                            True)

    def lm():
        flux, Va, Vb = s2._slab_flux(state["cap"], 1.0, state["T"])
        state["F"] = s2._box3_filter(Va - Vb - flux).reshape(-1)
        state["d"] = s2._lm_step(state["J"], state["F"], d, lam, 1.0, 5, 1,
                                 max_disp)

    def iteration():
        build()
        solve()
        jac()
        lm()
        # the GN loop's one read per iteration
        return bool(torch.linalg.norm(state["F"]) > 1e-4)

    iteration()
    parts = {name: [cuda_ms(fn, 1) for _ in range(3)]
             for name, fn in (("build", build), ("solve", solve),
                              ("jacobian", jac), ("LM", lm))}
    whole = [cuda_ms(iteration, 1) for _ in range(3)]
    n_kernels, busy = _profile_kernels(iteration)
    syncs = count_syncs(iteration)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    iteration()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    fmt = lambda v: ", ".join(f"{m:.2f}" for m in v)  # noqa: E731
    log(f"flagship {n}² × {mk_a.shape[0]} markers f32, one GN iteration "
        f"(band budget {budget}), ms, 3 repeats: slab capacity build "
        f"{fmt(parts['build'])}; inner solve (reduced CG) "
        f"{fmt(parts['solve'])}; intercept Jacobian {fmt(parts['jacobian'])}"
        f"; flux, residual and LM update {fmt(parts['LM'])}; whole "
        f"iteration {fmt(whole)}; {n_kernels} kernels ({busy:.2f} ms of "
        f"device time, busy {busy / min(whole):.1%}), {syncs} host syncs per "
        f"iteration; GN iterations/step in phase 11 {its.tolist()} (mean "
        f"{its.mean():.2f}), {rows['stefan']['wall'] * 1e3 / its.sum():.1f} ms "
        f"per GN iteration over phase 11's run with its set-up; peak memory "
        f"of an iteration above the state {peak:.0f} MiB [{smi}]")
    ad = rows["stefan_ad"]
    sa = ad["solver"]
    mk = torch.as_tensor(sa.marker_log[-2], device=device)
    nr = polyline_normals(mk)
    dz = torch.zeros(mk.shape[0], dtype=mk.dtype, device=device)
    bud = sa._band_budget
    jac_ms = [cuda_ms(lambda: s2._autodiff_jacobian(
        dz, mk, nr, sa.mesh, -1.0, -1.0, True, 4, 1, bud), 1)
        for _ in range(3)]
    log(f"autodiff leg {sa.mesh.n[0]}² × {mk.shape[0]} markers f32: "
        f"{ad['wall'] * 1e3 / ad['iters']:.1f} ms per GN iteration over "
        f"phase 11's {ad['iters']} (set-up included); the autodiff Jacobian "
        f"alone (band budget {bud}, {s2._JAC_CHUNK} tangents a pass) "
        f"{fmt(jac_ms)} ms [{smi}]")
    r1 = rows["stefan1d"]
    s1d = r1["solver"]
    slab = s1d._mono_slab_solve(0.1, r1["dt"], 1.0, 6, 1)
    xf = torch.full((), s1d.xf, dtype=torch.float64, device=device)
    one = [cuda_ms(lambda: slab(s1d.x, xf, xf + 1e-3), 3) for _ in range(3)]
    log(f"1D one-phase Stefan nx={s1d.mesh.n[0]} f64: "
        f"{r1['wall'] * 1e3 / r1['iters']:.2f} ms per Newton iteration over "
        f"phase 12's {r1['iters']}; one slab build, direct solve and "
        f"residual alone {fmt(one)} ms [{smi}]")


def count_syncs(fn):
    """Run ``fn`` with CUDA sync debugging on; returns the number of calls
    that waited for the device."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def _profile_kernels(fn):
    """(number of device kernels, their summed milliseconds) of one call."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def general_times(pt, rows, smi):
    """Set-up time, ms/step, Krylov iterations/step, host syncs/step, peak
    memory and the device's busy share of the general path's BE steps at
    the bench size, per method."""
    from penguin_tpu_torch.solvers import diffusion as td
    cap = rows["easy"]["cap"]
    n = cap.mesh.n[0]
    dt = EASY[0] * (L / n) ** 2
    solves = GEN_STEPS + 1
    for method in GEN_METHODS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = bench_mono(pt, td, cap, dt)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        setup_syncs = count_syncs(lambda: bench_mono(pt, td, cap, dt))

        def run():
            s.solve(GEN_STEPS * dt, method=method, tol=GEN_TOL)

        syncs = count_syncs(run)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = [cuda_ms(run, 1) / solves for _ in range(3)]
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        its = s.krylov.history[-solves:]
        n_kernels, busy_ms = _profile_kernels(run)
        log(f"general {n}² f32 BE {method}: set-up {t_setup:.2f} s "
            f"({setup_syncs} host syncs); ms/step over 1+{GEN_STEPS} solves,"
            f" 3 repeats: {', '.join(f'{m:.2f}' for m in ms)}; Krylov "
            f"iterations/step {np.mean(its):.2f} {its}; host syncs/step "
            f"{syncs / solves:.1f}; peak memory above the capacity "
            f"{peak:.0f} MiB; profiler: {n_kernels / solves:.0f} kernels/"
            f"step, {busy_ms / solves:.3f} ms of device time/step, so the "
            f"device is busy {busy_ms / solves / min(ms):.1%} of the fastest "
            f"step [{smi}]")


def moving_times(pt, rows, smi, device):
    """The moving path at the bench size: ms per slab split into capacity
    build and solve, CG iterations, host syncs, kernels, device busy share
    and peak memory; then the marker front at 512²: dense against band
    build, and ``polyline_sdf`` per evaluation for several segment chunks."""
    from penguin_tpu_torch import capacity as tc
    from penguin_tpu_torch.front_tracking import polyline_sdf
    from penguin_tpu_torch.solvers import moving_diffusion as md
    mv = rows["moving"]
    solver, mesh, dt = mv["solver"], mv["mesh"], mv["dt"]
    n = mesh.n[0]
    f32 = dict(dtype=torch.float32, device=device)
    t1 = 5 * dt

    def build():
        return tc.compute_capacity_spacetime(osc_body, mesh, t1, t1 + dt, p=6,
                                             s=1, **f32)

    cap = build()
    x_prev = solver.x
    phase, bc_i, border = solver.phase, solver.bc_i, solver.border

    def solve():
        return md.solve_moving_mono_step(
            cap, phase.diffusion, phase.source, bc_i, border, x_prev, t1, dt,
            "BE", tol=MOV_TOL, maxiter=2000)

    nsl = 3

    def slabs():
        s2, _, _ = osc_solver(pt, n, torch.float32, device)
        s2.solve(osc_body, dt, dt + (nsl - 1.5) * dt, tol=MOV_TOL)
        return s2

    ms_build = [cuda_ms(build, 1) for _ in range(3)]
    ms_solve = [cuda_ms(solve, 1) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ms_slab = [cuda_ms(slabs, 1) / nsl for _ in range(3)]
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    its = slabs().krylov_iters
    sync_build = count_syncs(build)
    sync_solve = count_syncs(solve)
    sync_slabs = count_syncs(slabs)
    kb, busy_b = _profile_kernels(build)
    ks_, busy_s = _profile_kernels(solve)
    log(f"moving {n}² f32 BE, oscillating circle, p=6 s=1: capacity build "
        f"ms, 3 repeats: {', '.join(f'{m:.1f}' for m in ms_build)}; reduced "
        f"CG solve ms: {', '.join(f'{m:.2f}' for m in ms_solve)} "
        f"({int(solve()[1])} iterations); ms/slab through the class over "
        f"{nsl} slabs with its set-up and final capacity: "
        f"{', '.join(f'{m:.1f}' for m in ms_slab)}; CG iterations/slab "
        f"{its.mean():.2f} {its.tolist()}; host syncs: build {sync_build}, "
        f"solve {sync_solve}, class run {sync_slabs / nsl:.1f}/slab; "
        f"kernels: build {kb} ({busy_b:.2f} ms of device time, busy "
        f"{busy_b / min(ms_build):.1%}), solve {ks_} ({busy_s:.2f} ms, busy "
        f"{busy_s / min(ms_solve):.1%}); peak memory above the solver's "
        f"state {peak:.0f} MiB [{smi}]")
    # the marker front: dense against band, f64, p=4 s=1
    fr = rows["front"]
    kw = dict(p=4, s=1, params=fr["params"], dtype=torch.float64,
              device=device)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    dense = [timed(lambda: tc.compute_capacity_spacetime(
        fr["body"], fr["mesh"], 0.0, fr["T"], **kw))]
    band = [timed(lambda: tc.compute_capacity_spacetime(
        fr["body"], fr["mesh"], 0.0, fr["T"], band_budget="auto", **kw))
        for _ in range(3)]
    nodes = [np.asarray(v) for v in fr["mesh"].nodes] + [
        np.array([0.0, fr["T"]])]
    budget = tc._round_budget(tc.estimate_band_budget(
        lambda *cs: fr["body"](*cs, fr["params"]), nodes,
        tuple(fr["mesh"].n) + (1,), torch.float64, 2.0, spacetime=True,
        device=device), fr["mesh"].ncells())
    fixed = [timed(lambda: tc.compute_capacity_spacetime(
        fr["body"], fr["mesh"], 0.0, fr["T"], band_budget=budget, **kw))
        for _ in range(3)]
    sync_band = count_syncs(lambda: tc.compute_capacity_spacetime(
        fr["body"], fr["mesh"], 0.0, fr["T"], band_budget=budget, **kw))
    m = fr["mesh"]
    log(f"marker slab {m.n[0]}² × {fr['params'][0].shape[0]} markers, f64, "
        f"p=4 s=1: dense build s (once more after phase 9's): "
        f"{', '.join(f'{t:.2f}' for t in dense)}; "
        f"band build with budget \"auto\" ({budget}, sized per call): "
        f"{', '.join(f'{t:.3f}' for t in band)}; with the budget given: "
        f"{', '.join(f'{t:.3f}' for t in fixed)} ({sync_band} host syncs); "
        f"dense/band = {min(dense) / min(band):.1f} [{smi}]")
    nx = m.n[0]
    for dtype in (torch.float64, torch.float32):
        xs = torch.linspace(0.0, L, nx, dtype=dtype, device=device)
        x, y = xs[:, None], xs[None, :]
        mk = fr["params"][0].to(dtype)
        parts = []
        for chunk in (32, 64, 128, 512, None):
            us = cuda_ms(lambda: polyline_sdf(mk, x, y, chunk=chunk), 3) * 1e3
            parts.append(f"chunk {chunk}: {us:.0f}")
        log(f"polyline_sdf, {nx}² points × {mk.shape[0]} markers, "
            f"{str(dtype)[6:]}, µs per evaluation (3 calls each): "
            f"{'; '.join(parts)} [{smi}]")


def phase_times(pt, ks, rows, device, smi):
    log("== phase 7: times on the card (CUDA events)")
    # the step is bound by the host's launch rate, which varies with the
    # host's load: three repeats of each, all printed
    for label, n in (("easy", 200), ("stiff", 50), ("3d", 20)):
        r = rows[label]
        fast, T = r["fast"], r["T"]
        ms = [cuda_ms(lambda: fast.run(T, n), 1) / n for _ in range(3)]
        _, last, mx = fast.run_telemetry(T, n)
        mean = f", mean {np.mean(r['its']):.2f} over {COUNT_STEPS} counted " \
            f"steps" if "its" in r else ""
        log(f"{label}: ms/step over {n} steps, 3 repeats: "
            f"{', '.join(f'{m:.4f}' for m in ms)}; CG iters/step over the "
            f"span last={int(last)} max={int(mx)}{mean} [{smi}]")
    general_times(pt, rows, smi)
    moving_times(pt, rows, smi, device)
    stefan_times(pt, rows, smi, device)
    kernels = []
    for name, shape, kernel, plain in (
            ("stencil5_matvec", (N2D + 1,) * 2, ks.stencil5_matvec,
             ks.stencil5_matvec_ref),
            ("stencil7_matvec", (N3D + 1,) * 3, ks.stencil7_matvec,
             ks.stencil7_matvec_ref)):
        n_in = 2 * len(shape) + 2          # coefficients and x
        g = torch.Generator(device=device).manual_seed(0)
        arrays = [torch.randn(shape, generator=g, device=device,
                              dtype=torch.float32)
                  for _ in range(n_in)]
        # the bare launch (no input checks, preallocated y) times the
        # kernel; the wrapper adds its host-side checks and allocation
        entry = ks._entry(name, n_in + 1, len(shape))
        y = torch.empty_like(arrays[-1])
        ptrs = [a.data_ptr() for a in arrays] + [y.data_ptr()]
        stream = torch.cuda.current_stream().cuda_stream

        def bare():
            err = entry(*ptrs, *shape, 4, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        # kernel and plain version in turns; keep the faster of two each
        times = {"bare": [], "wrapper": [], "plain": []}
        for _ in range(2):
            times["bare"].append(cuda_ms(bare, 200))
            times["wrapper"].append(cuda_ms(lambda: kernel(*arrays), 200))
            times["plain"].append(cuda_ms(lambda: plain(*arrays), 200))
        t_k, t_w, t_p = (min(times[k]) for k in ("bare", "wrapper", "plain"))
        nbytes = (n_in + 1) * 4 * math.prod(shape)  # inputs and y
        # one multiply per term and one add between terms, per element
        flops = (2 * n_in - 3) * math.prod(shape)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        log(f"{name} {shape} f32, {nbytes / 1e6:.1f} MB per call: kernel "
            f"{t_k * 1e3:.2f} µs ({nbytes / t_k / 1e6:.0f} GB/s effective, "
            f"{bound / t_k:.0%} of the {bound * 1e3:.2f} µs bound), through "
            f"the wrapper {t_w * 1e3:.2f} µs, plain torch {t_p * 1e3:.2f} µs "
            f"({nbytes / t_p / 1e6:.0f} GB/s) [{smi}]")
        kernels.append(dict(name=name, ms=t_k, plain_ms=t_p, bound_ms=bound,
                            bound_by="bytes" if t_bytes >= t_ops
                            else "operations"))
    return kernels


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: "
                         "torch.cuda.is_available() is False")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import penguin_tpu_torch as pt
    from penguin_tpu_torch.kernels import _build as build
    from penguin_tpu_torch.kernels import stencil as ks
    from penguin_tpu_torch.solvers import FastHeatBE

    device = torch.device("cuda", torch.cuda.current_device())
    t_start = time.perf_counter()
    took = {}

    def timed_phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t0, 1)
        return out

    smi = timed_phase("1", phase_environment, build)
    errs = timed_phase("2", phase_kernels, ks, device)
    rows, launches = timed_phase("3", phase_main_path, pt, FastHeatBE, ks,
                                 device)
    timed_phase("4", phase_card_vs_cpu, pt, FastHeatBE, device, rows)
    timed_phase("5", phase_general, pt, device, rows)
    timed_phase("6", phase_general_card_vs_cpu, pt, device)
    # the moving and phase-change paths launch neither kernel (nor do the
    # JAX package's): their counts are those of phase 3
    timed_phase("8", phase_moving, pt, device, rows)
    timed_phase("9", phase_front, pt, device, rows)
    timed_phase("10", phase_moving_card_vs_cpu, pt, device)
    timed_phase("11", phase_stefan, pt, ks, device, rows)
    timed_phase("12", phase_stefan_more, pt, device, rows)
    timed_phase("13", phase_stefan_card_vs_cpu, pt, device)
    timed = timed_phase("7", phase_times, pt, ks, rows, device, smi)
    replaces = {"stencil5_matvec": "penguin_tpu/pallas_kernels/stencil.py:250",
                "stencil7_matvec": "penguin_tpu/pallas_kernels/stencil.py:220"}
    kernels = [dict(name=t["name"], route="cuda",
                    source="penguin_tpu_torch/csrc/stencil.cu",
                    replaces=replaces[t["name"]],
                    launches=launches[t["name"]],
                    max_abs_err=errs[t["name"]], ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"],
                    # no single PyTorch call computes a stencil whose
                    # coefficients vary per cell (conv2d takes fixed weights)
                    library_ms=None) for t in timed]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s on "
        f"{smi}; seconds per phase: {took}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
