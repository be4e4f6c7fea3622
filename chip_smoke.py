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
against CPU in f64 (phase 13).  Then the Stokes path: the Taylor-Couette
annulus of benchmarks/couette_cylinder.py through ``StokesMono.solve`` (its
f64 convergence over 32²-128², f32 at 512² and 256²), the lid cavity through
``solve_unsteady`` (1024² f32, 32² f64), ``StokesDiph``'s two-layer Couette
and the 3D hydrostatic box (phase 14); the Galilean Couette of
benchmarks/moving_couette_galilean.py through ``MovingStokesMono`` at 24²
in f64 and 256² in f32 (phase 15); every class and preconditioner branch
card against CPU in f64 (phase 16).  Then the Navier-Stokes path: the DFG
2D-1 channel of benchmarks/dfg_cylinder_steady.py at 256 × 128 in f32
through ``NavierStokesMono.solve_steady_newton_krylov``, cut after the
Newton steps whose inner fgmres converges (Cd and ΔP gated against JAX's
at the same cut), 3 steps of DFG 2D-2 from rest by the implicit-Picard ``fgmres``
stepper with its per-step force and probe record, and the JAX tests'
Ghia Re=100 and chunked-AB2 gates in f64 (phase 17); 2 steps of the
differentially heated cavity of benchmarks/differential_cavity.py at 64²
through ``NavierStokesScalarCoupler.run_fast`` (Nu reported), the buoyant
cavity and the stream-vorticity gates (phase 18); every class and path
card against CPU in f64 (phase 19).  Last it times the steps, the slabs,
the GN and Newton iterations, the Stokes and Navier-Stokes solves, their
preconditioner and Krylov iterations, and the kernels (warm and with the
L2 flushed) with CUDA events (phase 7).  Every phase raises on failure, so
the exit code is 0 only if all passed.  Without a CUDA device it exits with
an error before doing anything.

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

# the Stokes path (phases 14-16): the Taylor-Couette annulus of
# benchmarks/couette_cylinder.py (inner wall rotating at OM, outer at rest)
COUETTE_C = (2.0 + 0.008, 2.0 + 0.008)
COUETTE_RI, COUETTE_RO, COUETTE_OM = 0.5, 1.5, 1.0
COUETTE_SIZES = (32, 64, 128)
# max|u_θ - exact| in f64 with the moment cut flux: benchmarks/
# couette_cylinder.csv at n = 32 and 64, docs/BENCHMARKS.md:22 at n = 128;
# each gated at 1.5x.  The order: every successive rate above 1.0 (the
# benchmark's own --convergence gate) and the fit over 32-128 above 1.4:
# the JAX package reaches 1.44 there (0.004294, 0.001809, 0.000581; its
# --convergence run on the CPU), not the 1.5 its docs' rounded 0.0005
# suggests
COUETTE_ERR = {32: 0.004294604063034058, 64: 0.001805812120437622,
               128: 0.0005}
COUETTE_ORDER = 1.4
# f32 at 4x the benchmark's finest size, solve(tol=1e-5); the largest of
# these whose schur_gmres converges is gated
COUETTE_F32_SIZES = (512, 256, 128)
COUETTE_F32_TOL = 1e-5
COUETTE_F32_ERR = 0.05   # profile error at the measured f32 floor
# the lid cavity of tests/test_stokes.py:99, BE at dt = 1e-3 through
# solve_unsteady's pbicgstab with the block-Schur M.  That iteration stalls
# at n >= 48 in both packages (JAX, f64, 64²: 400 iterations, relres
# 9e-4-0.2) and diverges in f32 at 32² (CPU): 1+1 steps at 1024² in f32
# record the stall, and 1+10 steps are gated at 32² in f64, where it
# converges (JAX: 192, 156, 157 iterations a step)
CAVITY_N = 1024
CAVITY_CONVERGED_N = 32
CAVITY_STEPS = 3         # 1+3 steps (the 1+10 asked for take 61 s at 32²:
                         # cut for the time limit); one step at 1024²
CAVITY_DT = 1e-3
CAVITY_TOL = 1e-5
CAVITY_DIV_TOL = 1e-4    # max|continuity residual| off the pin at 32²: the
                         # solve leaves relres 1e-5 of a ‖b‖ ≈ 5.7
STOKES_DIPH_N = 24       # 1.5x tests/test_stokes_diph.py's two-layer
                         # Couette (32², 10,890 unknowns, took 29.6 s in its
                         # lstsq: cut for the time limit)
GALILEAN_U0 = 0.5        # benchmarks/moving_couette_galilean.py
GALILEAN_N = 24
GALILEAN_STEPS = 12
GALILEAN_ERR = 0.004144348872151926   # its csv, moment cut flux, n = 24
MOVING_STOKES_N = 256    # the same problem in f32 by fgmres, 1+1 slabs
MOVING_STOKES_SLABS = 1  # (1+3 took 36.8 s, the last two stalled: cut)
MOVING_STOKES_TOL = 1e-5
# fgmres converges the first slab and stalls on the later ones, in both
# packages (the CPU, f32, 256²: JAX 90 iterations to 9.94e-6 then relres
# 1.27e-2 at 600; the port 49 to 9.93e-6, then 6.69e-3; 2040 iterations do
# not help, relres 3e-3-4e-2 on an H100).  The JAX docstring's relres 7e-7
# at 600 iterations does not hold on this problem; the cap only keeps the
# stalled slab short.  The first slab is gated
MOVING_STOKES_MAXITER = 600
STOKES_CVC_N = 48        # card against CPU, f64
# the Navier-Stokes path (phases 17-19): the DFG channel of
# benchmarks/dfg_cylinder_steady.py and dfg_cylinder_shedding.py at their
# default 256 × 128 in f32
DFG_N = (256, 128)
DFG_L = (2.2, 0.41)
DFG_R, DFG_C = 0.05, (0.2, 0.2)
DFG_CD = 5.5810          # 2D-1 control-volume Cd, the JAX package's record
                         # at 256 × 128 f32 (docs/BENCHMARKS.md:23)
DFG_BOX = (0.10, 0.32, 0.08, 0.32)
DFG_PROBES = [(0.15, 0.2), (0.25, 0.2)]
# JFNK's inner fgmres runs to its 800 cap from the fourth Newton step on,
# in both packages (JAX on the CPU, f32 with x64 off: 3, 11, 20, then 800
# iterations a step; the port likewise), ~100 s a Newton step on an H100
# (110-260 ms an fgmres iteration, 65-115 ms of it the jvp): the solve is
# cut where the cap starts, at |R| < DFG_JFNK_CUT, after the three
# uncapped updates (the benchmark asks 1e-10 within 25 steps)
DFG_JFNK_ITERS = 25
DFG_JFNK_CUT = 2.5e-3    # JAX f32 and the port reach 1.97e-3 and 1.91e-3
# at that cut the pressure is not converged (ΔP ≈ 0.078 against DFG's
# 0.117), so Cd and ΔP are held to JAX's at the same cut, in f64 on the CPU
# (tests/test_torch_navierstokes.py::test_dfg_cut_force_matches_jax, which
# holds the port there to 0.1% in f64 and 2% in f32): 2%, since f32
# round-off moves an inexact Newton iterate's pressure by ~1%
DFG_CUT_CD, DFG_CUT_DP = 5.5999, 0.07813
DFG_CUT_TOL = 0.02
DFG2_DT = 0.002
DFG2_STEPS = 3           # from rest; St and Cd need 4000 steps: cut to 3
DFG2_TOL = 1e-6
# in f32 the Picard sweeps' fgmres stalls at its 120 iterations in both
# packages (JAX, x64 off, on the CPU: relres 1.7e-4-1.9e-4; the port on an
# H100: 4.1e-5 at most): gated just above the larger
DFG2_STALL_TOL = 5e-4
GHIA_N = 24              # tests/test_navierstokes.py:93
CARRY_N = (32, 16)       # tests/test_navierstokes.py:334
HEAT_N = 64              # benchmarks/differential_cavity.py, dt = 0.05: its
HEAT_STEPS = 2           # 400 steps to t = 20 take 8-11 s each on an H100
                         # (the momentum pgmres runs to its cap, as in JAX):
                         # 2, cut for time
NS_CVC_N = 12            # card against CPU, f64
CVC_CHANNEL = (32, 16)


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


# ---------------------------------------------------------------------------
# the Stokes path (phases 14-16)
# ---------------------------------------------------------------------------

def stokes_fluid(pt, body, n, size, dtype, device, ndim=2, mu=1.0, f_u=None,
                 cut_moments="auto", p=4, s=1):
    """A Fluid on the pressure mesh and the velocity meshes offset -h/2
    along their own axis; ``body`` None is the full domain."""
    h = size / n
    mesh_p = pt.Mesh((n,) * ndim, (size,) * ndim, (0.0,) * ndim)
    meshes_u = tuple(pt.Mesh((n,) * ndim, (size,) * ndim,
                             tuple(-0.5 * h if i == a else 0.0
                                   for i in range(ndim)))
                     for a in range(ndim))
    body = body or pt.geometry.full_domain(ndim)
    caps = [pt.compute_capacity(body, m, p=p, s=s, dtype=dtype,
                                device=device, cut_moments=cut_moments)
            for m in meshes_u + (mesh_p,)]
    ops = [pt.make_diffusion_ops(c) for c in caps]
    return pt.Fluid(mesh_u=meshes_u, mesh_p=mesh_p,
                    capacity_u=tuple(caps[:ndim]), operator_u=tuple(ops[:ndim]),
                    capacity_p=caps[ndim], operator_p=ops[ndim], mu=mu,
                    rho=1.0, f_u=f_u or (lambda x, y, z: 0.0),
                    f_p=lambda x, y, z: 0.0)


def fluid_to(pt, fl, device):
    """``fl`` with its capacities copied to ``device`` and its operators
    rebuilt there: card and CPU then see the same geometry."""
    import dataclasses

    def move(cap):
        kw = {}
        for f in dataclasses.fields(cap):
            v = getattr(cap, f.name)
            if isinstance(v, torch.Tensor):
                kw[f.name] = v.to(device)
            elif isinstance(v, tuple):
                kw[f.name] = tuple(a.to(device) for a in v)
        return dataclasses.replace(cap, **kw)

    caps_u = tuple(move(c) for c in fl.capacity_u)
    cap_p = move(fl.capacity_p)
    return dataclasses.replace(
        fl, capacity_u=caps_u,
        operator_u=tuple(pt.make_diffusion_ops(c) for c in caps_u),
        capacity_p=cap_p, operator_p=pt.make_diffusion_ops(cap_p))


def stokes_walls(pt, value=0.0, keys=KEYS2):
    return pt.BorderConditions({k: pt.Dirichlet(value) for k in keys})


def couette_body(x, y):
    cx, cy = COUETTE_C
    r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    return torch.maximum(COUETTE_RI - r, r - COUETTE_RO)


def couette_wall(comp):
    """The cut velocity: rigid rotation on the inner wall, rest on the
    outer, selected by the radius."""
    cx, cy = COUETTE_C

    def g(x, y, z, t=None):
        r = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2)
        rot = -COUETTE_OM * (y - cy) if comp == 0 else COUETTE_OM * (x - cx)
        return torch.where(r < 0.5 * (COUETTE_RI + COUETTE_RO), rot, 0.0)

    return g


def couette_solver(pt, n, dtype, device, fluid=None, **kw):
    from penguin_tpu_torch.solvers import StokesMono
    fl = fluid or stokes_fluid(pt, couette_body, n, L, dtype, device,
                               cut_moments=True)
    bc = stokes_walls(pt)
    return StokesMono(fl, (bc, bc), None, (pt.Dirichlet(couette_wall(0)),
                                           pt.Dirichlet(couette_wall(1))),
                      **kw)


def couette_exact(r):
    ri, ro, om = COUETTE_RI, COUETTE_RO, COUETTE_OM
    a = -om * ri ** 2 / (ro ** 2 - ri ** 2)
    b = om * ri ** 2 * ro ** 2 / (ro ** 2 - ri ** 2)
    return a * r + b / np.maximum(r, 1e-12)


def couette_error(s, n):
    """benchmarks/couette_cylinder.py's measure: max |u_θ - exact| along the
    vertical line through the centre, 2 cells away from both walls."""
    d = L / n
    ux = s.velocity(0).double().cpu().numpy()
    cy = s.fluid.capacity_u[0].C_om.double().cpu().numpy()
    j = np.argmin(np.abs(np.asarray(s.fluid.mesh_u[0].nodes[0]) + 0.5 * d
                         - COUETTE_C[0]))
    ys = cy[j, :, 1]
    r = np.abs(ys - COUETTE_C[1])
    sel = (r > COUETTE_RI + 2 * d) & (r < COUETTE_RO - 2 * d)
    u_th = np.where(ys > COUETTE_C[1], -ux[j, :], ux[j, :])
    return float(np.abs(u_th - couette_exact(r))[sel].max())


def cavity_solver(pt, n, dtype, device, fluid=None):
    """The lid-driven Stokes cavity of tests/test_stokes.py:99."""
    from penguin_tpu_torch.solvers import StokesMono
    fl = fluid or stokes_fluid(pt, None, n, 1.0, dtype, device)
    bc_ux = pt.BorderConditions({"left": pt.Dirichlet(0.0),
                                 "right": pt.Dirichlet(0.0),
                                 "bottom": pt.Dirichlet(0.0),
                                 "top": pt.Dirichlet(lambda x, y, z: 1.0)})
    return StokesMono(fl, (bc_ux, stokes_walls(pt)), None, pt.Dirichlet(0.0))


def two_layer(pt, n, dtype, device):
    """The two-layer Couette of tests/test_stokes_diph.py:31 (lower μ = 1,
    upper μ = 0.25, lid at 1) and its exact interface shear τ."""
    from penguin_tpu_torch.solvers import StokesDiph
    yint, mu1, mu2 = 0.511, 1.0, 0.25
    fa = stokes_fluid(pt, pt.geometry.halfspace(1, yint), n, 1.0, dtype,
                      device, mu=mu1, p=6)
    fb = stokes_fluid(pt, pt.geometry.halfspace(1, yint, -1.0), n, 1.0,
                      dtype, device, mu=mu2, p=6)
    tau = 1.0 / (yint / mu1 + (1.0 - yint) / mu2)
    prof1 = pt.Dirichlet(lambda x, y, z: tau * y / mu1)
    prof2 = pt.Dirichlet(lambda x, y, z: tau * yint / mu1
                         + tau * (y - yint) / mu2)
    d0 = pt.Dirichlet(0.0)
    bc_a = (pt.BorderConditions({"left": prof1, "right": prof1,
                                 "bottom": d0}),
            pt.BorderConditions({"left": d0, "right": d0, "bottom": d0}))
    bc_b = (pt.BorderConditions({"left": prof2, "right": prof2,
                                 "top": pt.Dirichlet(1.0)}),
            pt.BorderConditions({"left": d0, "right": d0, "top": d0}))
    ic = pt.InterfaceConditions(pt.ScalarJump(1.0, 1.0, 0.0),
                                pt.FluxJump(1.0, 1.0, 0.0))
    exact = (lambda y: tau * y / mu1,
             lambda y: tau * yint / mu1 + tau * (y - yint) / mu2)
    return StokesDiph(fa, fb, bc_a, bc_b, ic), exact


def hydrostatic_3d(pt, n, dtype, device):
    """The closed 3D box of tests/test_stokes3d_vmap.py:15: a constant force
    balanced by the pressure gradient."""
    from penguin_tpu_torch.solvers import StokesMono
    fl = stokes_fluid(pt, None, n, 1.0, dtype, device, ndim=3,
                      f_u=lambda x, y, z: 1.0)
    bc = stokes_walls(pt, keys=KEYS2 + ("backward", "forward"))
    return StokesMono(fl, (bc, bc, bc), None, pt.Dirichlet(0.0))


def phase_stokes(pt, ks, device, rows, sizes=COUETTE_SIZES,
                 f32_sizes=COUETTE_F32_SIZES, cavity_n=CAVITY_N,
                 cavity_small=CAVITY_CONVERGED_N, cavity_steps=CAVITY_STEPS,
                 diph_n=STOKES_DIPH_N):
    log("== phase 14: static Stokes at full width on the card")
    from penguin_tpu_torch.solvers.stokes import stokes_divergence
    f32, f64 = torch.float32, torch.float64
    ks.stencil5_matvec.launches = 0
    ks.stencil7_matvec.launches = 0
    # (a) the Couette convergence in f64 through solve(tol=1e-8)
    errs = {}
    for n in sizes:
        s = couette_solver(pt, n, f64, device)
        sync(device)
        t0 = time.perf_counter()
        s.solve(tol=1e-8)
        sync(device)
        wall = time.perf_counter() - t0
        errs[n] = couette_error(s, n)
        how = (f"schur_gmres, {s.krylov_iters} iterations, relres "
               f"{s.krylov_relres:.2e}, Chebyshev depth "
               f"{s._schur_bounds[2]}" if hasattr(s, "krylov_iters")
               else "direct (auto, at most 12,000 unknowns)")
        ref = COUETTE_ERR.get(n)
        log(f"Couette annulus {n}² f64, {s.cut_flux} cut flux: {how}; "
            f"solve {wall:.2f} s; max|u_θ - exact| {errs[n]:.3e}"
            + (f" (recorded {ref:.3e}, gate 1.5x)" if ref else ""))
        if ref and not errs[n] <= 1.5 * ref:
            raise AssertionError(f"Couette {n}²: error {errs[n]}")
    n0, n1 = sizes[0], sizes[-1]
    order = math.log(errs[n0] / errs[n1]) / math.log(n1 / n0)
    rates = [math.log2(errs[a] / errs[b]) for a, b in zip(sizes, sizes[1:])]
    log(f"Couette order over {n0}²-{n1}²: {order:.2f} (gate > "
        f"{COUETTE_ORDER}); successive rates "
        f"{', '.join(f'{r:.2f}' for r in rates)} (gate > 1.0)")
    if not (order > COUETTE_ORDER and min(rates) > 1.0):
        raise AssertionError(f"Couette order {order}, rates {rates}")
    # (b) the annulus in f32 at the largest size whose solve converges
    for n in f32_sizes:
        s = couette_solver(pt, n, f32, device)
        sync(device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        s.solve(tol=COUETTE_F32_TOL)
        sync(device)
        wall = time.perf_counter() - t0
        peak = ((torch.cuda.max_memory_allocated() - base) / 2 ** 20
                if device.type == "cuda" else float("nan"))
        err = couette_error(s, n)
        log(f"Couette annulus {n}² f32, solve(tol={COUETTE_F32_TOL}): "
            f"schur_gmres {s.krylov_iters} iterations, relres "
            f"{s.krylov_relres:.3e}, Chebyshev depth {s._schur_bounds[2]}, "
            f"{wall:.2f} s ({wall / max(s.krylov_iters, 1) * 1e3:.1f} ms per "
            f"iteration with the set-up of M); max|u_θ - exact| {err:.3e}")
        if s.krylov_relres <= COUETTE_F32_TOL:
            break
        log(f"Couette {n}² f32: schur_gmres stalls above the tolerance "
            f"(the Jacobi momentum block's 1/h² conditioning); next size")
    else:
        raise AssertionError("Couette f32: no size converged")
    if not (err <= COUETTE_F32_ERR and torch.isfinite(s.velocity(0)).all()):
        raise AssertionError(f"Couette {n}² f32: error {err}")
    rows["couette_f32"] = dict(solver=s, n=n, wall=wall, peak=peak)
    # (c) the lid cavity, unsteady BE in f32: the stall at full size, the
    # gates where the iteration converges
    for n, steps, dtype in ((cavity_n, 0, f32),
                            (cavity_small, cavity_steps, f64)):
        s = cavity_solver(pt, n, dtype, device)
        sync(device)
        t0 = time.perf_counter()
        s.solve_unsteady(CAVITY_DT, (steps + 0.5) * CAVITY_DT, scheme="BE",
                         method="pbicgstab", tol=CAVITY_TOL)
        sync(device)
        wall = time.perf_counter() - t0
        ux, uy = s.velocity(0), s.velocity(1)
        finite = bool(torch.isfinite(ux).all() and torch.isfinite(uy).all())
        lid = (ux[:n, n - 1] - 1.0).abs().max().item()
        umax = max(ux.abs().max().item(), uy.abs().max().item())
        div = stokes_divergence(s.fluid, [s.x[0], s.x[2]],
                                [s.x[1], s.x[3]])
        div = torch.where(s.pin_mask, 0.0, div)[:n, :n].abs().max().item()
        its, rr = s.krylov_iters, s.krylov_relres
        converged = bool(np.all(rr <= CAVITY_TOL))
        log(f"lid cavity {n}² {str(dtype)[6:]}, BE dt={CAVITY_DT}, "
            f"1+{steps} steps, "
            f"pbicgstab with the block-Schur M (Chebyshev depth "
            f"{s._schur_bounds[2]}): {wall:.2f} s, iterations/step "
            f"{its.tolist()}, relres {np.array2string(rr, precision=2)} (tol "
            f"{CAVITY_TOL}, {'converged' if converged else 'stalled'}); "
            f"|lid row - 1| {lid:.1e}; max|u| {umax:.4f}; max|div| off the "
            f"pin {div:.2e} (h = {1.0 / n:.2e}); finite {finite}")
        if not finite:
            raise AssertionError(f"lid cavity {n}²: non-finite field")
        if n == cavity_n:
            rows["cavity"] = dict(solver=s, wall=wall, its=its, relres=rr)
    if not (converged and lid <= 1e-5 and umax <= 1.01
            and div <= CAVITY_DIV_TOL):
        raise AssertionError("lid cavity: a gate failed")
    # (d) two-phase Stokes: the two-layer Couette in f64 by lstsq
    s, exact = two_layer(pt, diph_n, f64, device)
    sync(device)
    t0 = time.perf_counter()
    s.solve()
    sync(device)
    wall = time.perf_counter() - t0
    l2 = []
    for k, fl in ((0, s.a.fluid), (1, s.b_.fluid)):
        cap = fl.capacity_u[0]
        full = (cap.cell_types == 1).cpu().numpy()
        full[0, :] = full[-1, :] = full[:, 0] = full[:, -1] = False
        ys = np.asarray(fl.mesh_u[0].nodes[1])
        e = (s.velocity(k, 0).cpu().numpy() - exact[k](ys)[None, :])[full]
        w = cap.V.cpu().numpy()[full]
        l2.append(float(np.sqrt((e ** 2 * w).sum() / w.sum())))
    cut = (s.a.fluid.capacity_u[0].cell_types == -1).cpu().numpy()
    cut[0, :] = cut[diph_n - 1, :] = cut[-1, :] = False
    jump = float(np.abs(s.velocity(0, 0, True).cpu().numpy()
                        - s.velocity(1, 0, True).cpu().numpy())[cut].max())
    log(f"two-layer Couette (StokesDiph) {diph_n}² f64, lstsq of "
        f"{sum(t.numel() for t in s.x)} unknowns: {wall:.2f} s; L2 "
        f"{l2[0]:.3e}, {l2[1]:.3e} (gate 0.12); interface |uγ1 - uγ2| "
        f"{jump:.1e} (gate 1e-6)")
    if not (max(l2) < 0.12 and jump < 1e-6):
        raise AssertionError("StokesDiph: a gate failed")
    # (e) the 3D hydrostatic box
    n = 8
    s = hydrostatic_3d(pt, n, f64, device)
    s.solve(method="lstsq")
    u = max(s.velocity(d)[:n, :n, :n].abs().max().item() for d in range(3))
    p = s.pressure.cpu().numpy()
    dp = p[1:n - 1, 1:n - 1, 1:n - 1] - p[0:n - 2, 1:n - 1, 1:n - 1]
    dev = float(np.abs(dp + 1.0 / n).max())
    log(f"3D hydrostatic box {n}³ f64, lstsq: max|u| {u:.1e} (gate 1e-8), "
        f"max|dp + h| {dev:.1e} (gate 1e-8)")
    if not (u < 1e-8 and dev < 1e-8):
        raise AssertionError("3D hydrostatic: a gate failed")


def galilean_u(comp, x, y, t):
    """benchmarks/moving_couette_galilean.py's lab-frame exact velocity."""
    cx, cy = COUETTE_C
    ri, ro, om = COUETTE_RI, COUETTE_RO, COUETTE_OM
    a = -om * ri ** 2 / (ro ** 2 - ri ** 2)
    b = om * ri ** 2 * ro ** 2 / (ro ** 2 - ri ** 2)
    dx = x - cx - GALILEAN_U0 * t
    dy = y - cy
    w = a + b / torch.clamp_min(dx * dx + dy * dy, 1e-12)
    return -w * dy + GALILEAN_U0 if comp == 0 else w * dx


def galilean_f(comp, x, y, t):
    """Its manufactured force -ρ U0 ∂x u_s(x - U t)."""
    cx, cy = COUETTE_C
    ri, ro, om = COUETTE_RI, COUETTE_RO, COUETTE_OM
    a = -om * ri ** 2 / (ro ** 2 - ri ** 2)
    b = om * ri ** 2 * ro ** 2 / (ro ** 2 - ri ** 2)
    dx = x - cx - GALILEAN_U0 * t
    dy = y - cy
    r2 = torch.clamp_min(dx * dx + dy * dy, 1e-12)
    if comp == 0:
        ddx = 2.0 * b * dx * dy / (r2 * r2)
    else:
        ddx = a + b / r2 - 2.0 * b * dx * dx / (r2 * r2)
    return -GALILEAN_U0 * ddx


def galilean_body(x, y, tau, params):
    t = params[0] + tau
    cx = COUETTE_C[0] + GALILEAN_U0 * t
    r = torch.sqrt((x - cx) ** 2 + (y - COUETTE_C[1]) ** 2)
    return torch.maximum(COUETTE_RI - r, r - COUETTE_RO)


def galilean_problem(pt, n, dtype, device, cut_flux):
    """The annulus translating at U0: (solver, exact start, dt), with 0.1
    cells of wall travel per slab as in the benchmark."""
    from penguin_tpu_torch.solvers import MovingStokesMono
    fl = stokes_fluid(
        pt, couette_body, n, L, dtype, device, cut_moments=False,
        f_u=(lambda x, y, z, t=0.0: galilean_f(0, x, y, t),
             lambda x, y, z, t=0.0: galilean_f(1, x, y, t)))
    bc = tuple(pt.BorderConditions({k: pt.Dirichlet(
        lambda x, y, z, t=0.0, c=c: galilean_u(c, x, y, t)) for k in KEYS2})
        for c in (0, 1))
    cut = tuple(pt.Dirichlet(lambda x, y, z, t=0.0, c=c:
                             galilean_u(c, x, y, t)) for c in (0, 1))
    s = MovingStokesMono(fl, bc, None, cut, cut_flux=cut_flux)
    x0 = list(s.zero_state())
    for k in (0, 1):
        C = fl.capacity_u[k].C_om
        x0[2 * k] = x0[2 * k + 1] = galilean_u(k, C[..., 0], C[..., 1], 0.0)
    return s, tuple(x0), 0.1 * fl.mesh_p.h[0] / GALILEAN_U0


def galilean_error(s, n, t_end):
    """Max |u_x - exact| over the full cells of the final annulus, 2 cells
    away from both walls."""
    d = L / n
    ux = s.velocity(0)[:n, :n].double()
    C = s.fluid.capacity_u[0].C_om[:n, :n].double()
    xg, yg = C[..., 0], C[..., 1]
    r = torch.sqrt((xg - COUETTE_C[0] - GALILEAN_U0 * t_end) ** 2
                   + (yg - COUETTE_C[1]) ** 2)
    band = (r > COUETTE_RI + 2 * d) & (r < COUETTE_RO - 2 * d)
    ex = galilean_u(0, xg, yg, t_end)
    return (ux - ex).abs()[band].max().item()


def phase_moving_stokes(pt, ks, device, rows, n=GALILEAN_N,
                        big=MOVING_STOKES_N, slabs=MOVING_STOKES_SLABS):
    log("== phase 15: moving-boundary Stokes on the card")
    f32, f64 = torch.float32, torch.float64
    # equilibrated pgmres stalls on these slabs in both packages (JAX,
    # 24², first two slabs: 2040 iterations each, relres 6.5e-5 and 3.4e-2;
    # the port on an H100: 1.2e-5 and 3.4e-2), and a stalled iterate
    # depends on round-off: the first slab is run by pgmres to record the
    # stall, and the gated runs take the dense minimum-norm lstsq of the
    # benchmark's --fine mode
    s, x0, dt = galilean_problem(pt, n, f64, device, "moment")
    sync(device)
    t0 = time.perf_counter()
    s.solve(galilean_body, dt, 0.0, dt, x0=x0, p=4, s=1,
            method="pgmres", tol=1e-10)
    sync(device)
    log(f"Galilean Couette {n}² f64, moment, pgmres over 1 slab in "
        f"{time.perf_counter() - t0:.2f} s: iterations/slab "
        f"{s.krylov_iters.tolist()}, relres "
        f"{np.array2string(s.krylov_relres, precision=2)} (the reference's "
        f"stall)")
    errs = {}
    for flux in ("centroid", "moment"):
        s, x0, dt = galilean_problem(pt, n, f64, device, flux)
        t_end = GALILEAN_STEPS * dt
        sync(device)
        t0 = time.perf_counter()
        s.solve(galilean_body, dt, 0.0, t_end, x0=x0, p=4, s=1,
                method="lstsq")
        sync(device)
        wall = time.perf_counter() - t0
        errs[flux] = galilean_error(s, n, t_end)
        log(f"Galilean Couette {n}² f64, {flux} cut flux, lstsq of "
            f"{sum(t.numel() for t in s.x)} unknowns a slab, "
            f"{GALILEAN_STEPS} slabs in {wall:.2f} s; max|u_x - exact| "
            f"{errs[flux]:.5f}")
    log(f"moment/centroid {errs['moment'] / errs['centroid']:.3f} (gate < "
        f"0.5); moment against the csv's {GALILEAN_ERR:.5f} (gate 1.5x)")
    if not (errs["moment"] < 0.5 * errs["centroid"]
            and errs["moment"] <= 1.5 * GALILEAN_ERR):
        raise AssertionError(f"Galilean Couette: {errs}")
    # the scalable method at 256² in f32
    s, x0, dt = galilean_problem(pt, big, f32, device, "moment")
    sync(device)
    t0 = time.perf_counter()
    s.solve(galilean_body, dt, 0.0, (slabs + 1) * dt, x0=x0, p=4, s=1,
            method="fgmres", tol=MOVING_STOKES_TOL,
            maxiter=MOVING_STOKES_MAXITER)
    sync(device)
    wall = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(t).all()) for t in s.x)
    err = galilean_error(s, big, (slabs + 1) * dt)
    log(f"Galilean Couette {big}² f32, moment, fgmres (static block-Schur/"
        f"DCT M), 1+{slabs} slabs in {wall:.2f} s with the set-up of M: "
        f"iterations/slab {s.krylov_iters.tolist()}, relres reached "
        f"{np.array2string(s.krylov_relres, precision=2)} (tol "
        f"{MOVING_STOKES_TOL}, gated on the first slab; the later ones "
        f"stall in both packages); max|u_x - exact| {err:.4f}; finite "
        f"{finite}")
    if not finite:
        raise AssertionError("moving Stokes 256² f32: non-finite field")
    if not s.krylov_relres[0] <= MOVING_STOKES_TOL:
        raise AssertionError(
            f"moving Stokes 256² f32: the first slab ends at relres "
            f"{s.krylov_relres[0]:.2e} after {s.krylov_iters[0]} iterations "
            f"(both packages reach the tolerance there on the CPU)")
    rows["moving_stokes"] = dict(solver=s, dt=dt, x0=x0, n=big)
    launches = {"stencil5_matvec": ks.stencil5_matvec.launches,
                "stencil7_matvec": ks.stencil7_matvec.launches}
    log(f"stencil kernels launched on the Stokes path (phases 14-15): "
        f"{launches} (it reaches no TPU kernel)")
    if any(launches.values()):
        raise AssertionError(f"the Stokes path launched {launches}")


def stokes_cases(pt, device, fluids):
    """(label, run, gate) triples for the Stokes path's card-vs-CPU
    comparison in f64 on the geometry ``fluids`` (already on ``device``):
    each run returns (tuple of tensors, Krylov counts or None), and for
    the residual gates also the relative true residual function of its
    system.  Gate "eq" holds the card to 1e-9 of scale with equal counts.
    On these saddle points (condition ~1e9) relres 1e-10 determines the
    field to ~1e-4 only, and the card's and the CPU's rounding move the
    Krylov iterates apart (schur_gmres at 32²: 1.2e-9 of scale with equal
    counts on an H100): "resid" holds the card's solution to 10x the
    solver's tolerance in the CPU's system, "resid=" also asks for equal
    counts (GMRES), "resid" not (BiCGStab and flexible GMRES take other
    paths on the two devices)."""
    from penguin_tpu_torch.linsolve import _ravel

    def relres(apply_fn, b):
        def fn(out):
            r = tuple(bb - aa for bb, aa in
                      zip(b, apply_fn(tuple(out[:len(b)]))))
            return (torch.linalg.vector_norm(_ravel(r)[0])
                    / torch.linalg.vector_norm(_ravel(b)[0])).item()
        return fn

    f64 = torch.float64
    like = dict(dtype=f64, device=device)
    g = torch.Generator().manual_seed(14)
    base = couette_solver(pt, 0, f64, device, fluid=fluids["couette"])
    r = tuple(torch.randn(t.shape, generator=g, dtype=f64).to(device)
              for t in base.zero_state())
    cases = []

    def ops():
        s = base
        out = s.apply_steady(r) + s.rhs_steady()
        out += s.make_unsteady_apply(0.05, 0.5)(r)
        out += s.make_unsteady_rhs(0.05, 0.5)(r, 0.1, 0.15)
        return out, None

    cases.append(("apply/rhs steady and unsteady (θ = 1/2)", ops, "eq"))

    def precond(schur, mom):
        def run():
            M = base.make_block_preconditioner(schur=schur, mom=mom)
            return M(r), [base._schur_bounds[2]]
        return run

    for schur in ("cheb", "cg", "dct_cg", "mass"):
        for mom in ("jacobi", "cg", "cg_dst"):
            cases.append((f"M(r) schur={schur} mom={mom}",
                          precond(schur, mom), "eq"))

    def steady(method, key):
        def run():
            s = couette_solver(pt, 0, f64, device, fluid=fluids[key])
            s.solve(method=method, tol=1e-10)
            out = s.x + tuple(torch.tensor(v, **like) for v in
                              s.force_diagnostics(parts=True)[0]
                              + s.interface_force(parts=True)[1]
                              + s.drag_lift_coefficients(
                                  interface_only=True))
            return (out, [getattr(s, "krylov_iters", 0)],
                    relres(s.apply_steady, s.rhs_steady()))
        return run

    cases.append(("solve direct 24², with the forces",
                  steady("direct", "couette24"), "eq"))
    cases.append(("solve schur_gmres 32², with the forces",
                  steady("schur_gmres", "couette32"), "resid="))

    def unsteady(method, key, t_end):
        def run():
            s = couette_solver(pt, 0, f64, device, fluid=fluids[key])
            x0 = tuple(t + 0.1 for t in s.zero_state())
            s.solve_unsteady(0.05, t_end, scheme="CN", method=method, x0=x0,
                             tol=1e-10)
            b = s.make_unsteady_rhs(0.05, 0.5)(x0, 0.0, 0.05)
            return (s.x, getattr(s, "krylov_iters", np.zeros(0)).tolist(),
                    relres(s.make_unsteady_apply(0.05, 0.5), b))
        return run

    cases.append(("solve_unsteady CN direct 24², 3 steps",
                  unsteady("direct", "couette24", 0.15), "eq"))
    cases.append(("solve_unsteady CN pbicgstab, one step",
                  unsteady("pbicgstab", "couette", 0.05), "resid"))

    def diph():
        s, _ = two_layer(pt, 16, f64, device)
        return s.solve(), None

    cases.append(("StokesDiph 16² lstsq", diph, "eq"))

    def moving(method):
        def run():
            s, x0 = disk_problem(pt, fluids["disk"])
            s.solve(disk_body, DISK_DT, DISK_T0, DISK_T0 + DISK_DT, x0=x0,
                    method=method, tol=1e-10)
            apply_fn, rhs_fn = s._slab_system(disk_body, DISK_T0, DISK_DT,
                                              1.0, "BE", 4, 1, x0,
                                              DISK_T0 + DISK_DT)
            return s.x, s.krylov_iters.tolist(), relres(apply_fn, rhs_fn())
        return run

    cases.append(("MovingStokesMono one slab lstsq, translating disk 16²",
                  moving("lstsq"), "eq"))
    cases.append(("MovingStokesMono one slab pgmres", moving("pgmres"),
                  "resid="))
    cases.append(("MovingStokesMono one slab fgmres", moving("fgmres"),
                  "resid"))
    return cases


DISK_U, DISK_T0, DISK_DT = 0.7, 0.1, 0.05


def disk_body(x, y, tau, params):
    """A fluid disk of radius 0.4 translating at (DISK_U, 0) through a 2 × 2
    box (tests/test_cut_moments.py:259)."""
    t = params[0] + tau
    return torch.sqrt((x - 0.8 - DISK_U * t) ** 2 + (y - 1.0) ** 2) - 0.4


def disk_problem(pt, fluid):
    """MovingStokesMono on the disk and the exact rigid motion as start."""
    from penguin_tpu_torch.solvers import MovingStokesMono
    s = MovingStokesMono(fluid, (stokes_walls(pt, DISK_U), stokes_walls(pt)),
                         None, (pt.Dirichlet(DISK_U), pt.Dirichlet(0.0)))
    x0 = list(s.zero_state())
    x0[0] = x0[0] + DISK_U
    x0[1] = x0[1] + DISK_U
    return s, tuple(x0)


def _rel(xa, xb):
    return max((a.cpu() - b.cpu()).abs().max().item() / max(
        b.abs().max().item(), 1.0) for a, b in zip(xa, xb))


def phase_stokes_card_vs_cpu(pt, device, n=STOKES_CVC_N):
    log(f"== phase 16: the Stokes path, card against the CPU path ({n}² "
        f"f64)")
    f64 = torch.float64
    cpu = torch.device("cpu")
    # the capacities are built on the card and copied: both paths see the
    # same geometry (sliver weights Wꜝ ~ 1e6 would carry any difference of
    # the two builds into every comparison)
    card = {
        "couette": stokes_fluid(pt, couette_body, n, L, f64, device,
                                cut_moments=True),
        "couette24": stokes_fluid(pt, couette_body, 24, L, f64, device,
                                  cut_moments=True),
        "couette32": stokes_fluid(pt, couette_body, 32, L, f64, device,
                                  cut_moments=True),
        "disk": stokes_fluid(pt, lambda x, y: disk_body(x, y, 0.0, (0.0,)),
                             16, 2.0, f64, device, mu=0.5),
    }
    host = {k: fluid_to(pt, v, cpu) for k, v in card.items()}
    compare_cases(stokes_cases(pt, device, card),
                  stokes_cases(pt, cpu, host))


def compare_cases(card, cpu):
    """Run each (label, run, gate[, tol]) case on the card and on the CPU
    and hold them to the gate: "eq", 1e-9 of scale with equal counts;
    "resid", the card's solution in the CPU's system to ``tol`` (default
    1e-9, 10x the solvers' tolerance); "resid=", that and equal counts."""
    for case_g, case_c in zip(card, cpu):
        label, run_g, gate = case_g[:3]
        tol = case_g[3] if len(case_g) > 3 else 1e-9
        run_c = case_c[1]
        if gate == "eq":
            xg, hg = run_g()[:2]
            xc, hc = run_c()[:2]
            err = _rel(xg, xc)
            log(f"{label}: max|x_card - x_cpu| / scale {err:.3e} (tol "
                f"1e-9); counts card {hg} cpu {hc}")
            if not err <= 1e-9 or hg != hc:
                raise AssertionError(f"{label}: card and CPU disagree")
        else:
            xg, hg, _ = run_g()
            xc, hc, res_c = run_c()
            res = res_c(tuple(t.cpu() for t in xg))
            log(f"{label}: the card's solution in the CPU's system: relres "
                f"{res:.2e} (gate {tol:.0e}, 10x the tolerance); the CPU's "
                f"own {res_c(xc):.2e}; max|x_card - x_cpu| / scale "
                f"{_rel(xg, xc):.2e}; counts card {hg} cpu {hc}"
                + (" (gate: equal)" if gate == "resid=" else ""))
            if not res <= tol or (gate == "resid=" and hg != hc):
                raise AssertionError(f"{label}: the card's solution fails")


# ---------------------------------------------------------------------------
# the Navier-Stokes path (phases 17-19)
# ---------------------------------------------------------------------------

def read_launches(ks, label):
    """Both stencil counters, which must read 0: the Navier-Stokes path
    reaches no TPU kernel (nor does the JAX package's)."""
    launches = {"stencil5_matvec": ks.stencil5_matvec.launches,
                "stencil7_matvec": ks.stencil7_matvec.launches}
    log(f"stencil kernels launched on {label}: {launches} (it reaches no "
        f"TPU kernel)")
    if any(launches.values()):
        raise AssertionError(f"{label} launched {launches}")


def reset_launches(ks):
    ks.stencil5_matvec.launches = 0
    ks.stencil7_matvec.launches = 0


def dfg_solver(pt, n, dtype, device, umax, ramp=None, fluid=None,
               ghost=True):
    """The DFG channel of benchmarks/dfg_cylinder_steady.py:55-115 (and
    dfg_cylinder_shedding.py:55-160): 2.2 × 0.41 with the walls exactly at
    y = 0 and 0.41 (origin shifted half a cell, ghost wall rows), a
    cylinder of radius 0.05 at (0.2, 0.2) with the moment cut flux, a
    parabolic inlet of peak ``umax`` (times a cosine start-up ramp over
    ``ramp`` time units when given), an Outflow outlet, ν = 1e-3; on
    ``fluid`` when given.  ``ghost=False``: the same channel as
    tests/test_navierstokes.py:334 builds it, on the staggered meshes from
    the origin with the solver's default wall rows and cut flux."""
    from penguin_tpu_torch.solvers import NavierStokesMono
    Lx, Ly = DFG_L
    if fluid is None:
        nx, ny = n
        dx, dy = Lx / nx, Ly / ny
        sx, sy = (0.0, 0.0) if ghost else (0.5 * dx, 0.5 * dy)
        meshes = tuple(pt.Mesh((nx, ny), (Lx, Ly), (ox + sx, oy + sy))
                       for ox, oy in ((-dx, -0.5 * dy), (-0.5 * dx, -dy),
                                      (-0.5 * dx, -0.5 * dy)))
        body = pt.geometry.complement(pt.geometry.circle(DFG_C, DFG_R))
        caps = [pt.compute_capacity(body, m, p=4, s=1, dtype=dtype,
                                    device=device,
                                    cut_moments=True if ghost else "auto")
                for m in meshes]
        ops = [pt.make_diffusion_ops(c) for c in caps]
        fluid = pt.Fluid(mesh_u=meshes[:2], mesh_p=meshes[2],
                         capacity_u=tuple(caps[:2]),
                         operator_u=tuple(ops[:2]), capacity_p=caps[2],
                         operator_p=ops[2], mu=1e-3, rho=1.0,
                         f_u=lambda x, y, z: 0.0, f_p=lambda x, y, z: 0.0)

    def inflow(x, y, z=0.0, t=None):
        prof = umax * 4.0 * (y / Ly) * (1.0 - y / Ly)
        if ramp is None or t is None:
            return prof
        return prof * (1.0 if t >= ramp
                       else 0.5 * (1.0 - math.cos(math.pi * t / ramp)))

    noslip = pt.Dirichlet(0.0)
    bc_ux = pt.BorderConditions({"left": pt.Dirichlet(inflow),
                                 "right": pt.Outflow(), "bottom": noslip,
                                 "top": noslip})
    kw = dict(wall_row="ghost", cut_flux="moment") if ghost else {}
    return NavierStokesMono(fluid, (bc_ux, stokes_walls(pt)), None, noslip,
                            **kw)


def dfg_record(s):
    """The per-step record of dfg_cylinder_shedding.py: the rim force on
    the body, the LSQ-probe pressure drop and the control-volume (Fs, M)."""
    cvf = s.make_control_volume_recorder(DFG_BOX)
    probe = s.make_pressure_probe(DFG_PROBES)

    def record(x):
        fx, fy = s.interface_force_traced(x)
        pab = probe(x)
        return (-fx, -fy, pab[0] - pab[1]) + cvf(x)

    return record


def ns_cavity(pt, n, dtype, device, Re, fluid=None):
    """The lid cavity of tests/test_navierstokes.py:93 at Re (lid u = 1)."""
    from penguin_tpu_torch.solvers import NavierStokesMono
    fl = fluid or stokes_fluid(pt, None, n, 1.0, dtype, device, mu=1.0 / Re)
    bc_ux = pt.BorderConditions({"left": pt.Dirichlet(0.0),
                                 "right": pt.Dirichlet(0.0),
                                 "bottom": pt.Dirichlet(0.0),
                                 "top": pt.Dirichlet(1.0)})
    return NavierStokesMono(fl, (bc_ux, stokes_walls(pt)), None,
                            pt.Dirichlet(0.0))


def phase_navier_stokes(pt, ks, device, rows, n=DFG_N,
                        jfnk_iters=DFG_JFNK_ITERS, shed_steps=DFG2_STEPS,
                        ghia_n=GHIA_N):
    log("== phase 17: Navier-Stokes at full width on the card")
    f32, f64 = torch.float32, torch.float64
    reset_launches(ks)
    # (a) DFG 2D-1: steady Re = 20 by JFNK (fgmres, DCT-CG Schur M)
    s = dfg_solver(pt, n, f32, device, umax=0.3)
    scale = 0.5 * 1.0 * 0.2 ** 2 * (2 * DFG_R)
    sync(device)
    t0 = time.perf_counter()
    s.solve_steady_newton_krylov(max_iter=jfnk_iters, tol=DFG_JFNK_CUT,
                                 lin_maxiter=800, restart=100)
    sync(device)
    wall = time.perf_counter() - t0
    fcx, fcy = s.control_volume_force(DFG_BOX)
    cd, cl = fcx / scale, fcy / scale
    fx, fy = s.interface_force()
    pa, pb = s.pressure_probe(DFG_PROBES)
    hist, lin = s.residual_history, s.newton_lin_iters
    log(f"DFG 2D-1 {n[0]}×{n[1]} f32, JFNK (fgmres restart 100, "
        f"lin_maxiter 800) cut at |R| < {DFG_JFNK_CUT}: {wall:.2f} s for "
        f"{len(lin)} Newton steps and "
        f"{sum(lin)} fgmres iterations ({wall / max(len(lin), 1):.2f} s per "
        f"Newton step, {wall / max(sum(lin), 1) * 1e3:.1f} ms per fgmres "
        f"iteration with the rest); |R| per step "
        f"{' '.join(f'{r:.1e}' for r in hist)}; fgmres iterations per step "
        f"{lin}; control-volume Cd {cd:.4f} ({100 * (cd / DFG_CD - 1):+.2f}%"
        f" from the converged JAX record {DFG_CD}), Cl {cl:+.5f}; "
        f"rim-integral Cd {-fx / scale:.4f}, Cl {-fy / scale:+.5f}; ΔP by "
        f"the LSQ probe {pa - pb:.4f} (DFG 0.1172-0.1176)")
    # gated at the cut: each Newton step contracts |R| tenfold or more with
    # an uncapped inner solve, as in JAX, and Cd and ΔP match JAX's at the
    # same cut (the record's Cd needs the capped steps)
    contracts = all(b_ < 0.1 * a_ for a_, b_ in zip(hist, hist[1:]))
    dcd, ddp = cd / DFG_CUT_CD - 1, (pa - pb) / DFG_CUT_DP - 1
    log(f"DFG 2D-1: cut at |R| {hist[-1]:.1e}; tenfold contraction every "
        f"step {contracts}; against JAX f64 at the same cut (Cd "
        f"{DFG_CUT_CD}, ΔP {DFG_CUT_DP}): Cd {100 * dcd:+.2f}%, ΔP "
        f"{100 * ddp:+.2f}% (gate {100 * DFG_CUT_TOL:.0f}%)")
    if not (contracts and hist[-1] < DFG_JFNK_CUT and max(lin) < 800
            and abs(dcd) <= DFG_CUT_TOL and abs(ddp) <= DFG_CUT_TOL
            and np.isfinite(cl)):
        raise AssertionError(f"DFG 2D-1: Cd {cd}, |R| {hist}, its {lin}")
    rows["dfg1"] = dict(solver=s, wall=wall, steps=len(lin), its=sum(lin))
    # (b) DFG 2D-2 from rest: CN implicit Picard (2 sweeps of fgmres) with
    # the per-step record
    s = dfg_solver(pt, n, f32, device, umax=1.5, ramp=1.0, fluid=s.fluid)
    record = dfg_record(s)
    sync(device)
    t0 = time.perf_counter()
    s.solve_unsteady_picard(DFG2_DT, shed_steps * DFG2_DT, scheme="CN",
                            picard_iters=2, method="fgmres", tol=DFG2_TOL,
                            maxiter=120, record=record)
    sync(device)
    wall = time.perf_counter() - t0
    its, rel = s.krylov_iters, s.krylov_relres
    rec = np.array(s.record_log)
    finite = bool(np.isfinite(rec).all()) and all(
        bool(torch.isfinite(t).all()) for t in s.x)
    log(f"DFG 2D-2 {n[0]}×{n[1]} f32, CN implicit Picard (2 fgmres sweeps, "
        f"tol {DFG2_TOL}, maxiter 120), {shed_steps} steps of dt {DFG2_DT} "
        f"from rest with the record: {wall:.2f} s "
        f"({wall / shed_steps * 1e3:.1f} ms per step); last-sweep fgmres "
        f"iterations per step mean "
        f"{its.mean():.1f}, max {its.max()}; relres max {rel.max():.2e} "
        f"(tol {DFG2_TOL}; gate {DFG2_STALL_TOL}, the f32 stall of both "
        f"packages); at t = {shed_steps * DFG2_DT:.3f}: rim Cd "
        f"{rec[0, -1] / (0.5 * 1.0 ** 2 * 2 * DFG_R):.4f}, ΔP "
        f"{rec[2, -1]:.4f}, box momentum {rec[5, -1]:.5f}; record finite "
        f"{finite}")
    if not (finite and rel.max() <= DFG2_STALL_TOL):
        raise AssertionError("DFG 2D-2: a gate failed")
    rows["dfg2"] = dict(solver=s, wall=wall, steps=shed_steps, its=its)
    # (c) the JAX tests' own gates at their sizes, f64
    s = ns_cavity(pt, ghia_n, f64, device, 100.0)
    sync(device)
    t0 = time.perf_counter()
    s.solve_steady(max_iter=40, tol=1e-9, method="lstsq")
    sync(device)
    wall = time.perf_counter() - t0
    center = s.velocity(0)[ghia_n // 2, :ghia_n]
    umin, lid = center.min().item(), abs(center[-1].item() - 1.0)
    log(f"Ghia Re=100 cavity {ghia_n}² f64, lstsq Picard: "
        f"{len(s.residual_history)} sweeps in {wall:.2f} s, last max|Δx| "
        f"{s.residual_history[-1]:.1e}; centreline min u {umin:.4f} (gate "
        f"-0.30..-0.12, Ghia -0.2109), |lid - 1| {lid:.1e}")
    if not (-0.30 < umin < -0.12 and lid < 1e-8):
        raise AssertionError("Ghia Re=100: a gate failed")
    dt = 0.005
    s1 = dfg_solver(pt, CARRY_N, f64, device, 0.3, ghost=False)
    x_full = s1.solve_unsteady(dt, 8 * dt, scheme="CN", method="fgmres",
                               tol=1e-10, maxiter=120)
    s2 = dfg_solver(pt, None, f64, device, 0.3, fluid=s1.fluid,
                    ghost=False)
    x, cp = None, None
    for k0 in (0, 4):
        x = s2.solve_unsteady(dt, (k0 + 4) * dt, scheme="CN",
                              method="fgmres", tol=1e-10, maxiter=120, x0=x,
                              t_start=k0 * dt, conv_prev=cp)
        cp = s2.conv_prev_out
    equal = all(torch.equal(a, b) for a, b in zip(x, x_full))
    log(f"chunked AB2 (4 + 4 fgmres CN steps, the convection carried) "
        f"against 8 steps at once, {CARRY_N[0]}×{CARRY_N[1]} f64: bit-equal "
        f"{equal}; fgmres iterations per step {s1.krylov_iters.tolist()}")
    if not equal:
        raise AssertionError("chunked AB2 carry: not bit-equal")
    read_launches(ks, "the Navier-Stokes path (phase 17)")


def heated_cavity(pt, n, device):
    """benchmarks/differential_cavity.py: Ra = 1e3, Pr = 0.71, hot wall
    x = 0 (+0.5), cold x = 1 (-0.5), adiabatic floor and lid, Boussinesq
    buoyancy with the Picard coupling, f64."""
    from penguin_tpu_torch.solvers import (NavierStokesMono,
                                           NavierStokesScalarCoupler,
                                           PicardCoupling)
    Ra, Pr = 1.0e3, 0.71
    nu = math.sqrt(Pr / Ra)
    fl = stokes_fluid(pt, None, n, 1.0, torch.float64, device, mu=nu)
    mom = NavierStokesMono(fl, (stokes_walls(pt), stokes_walls(pt)), None,
                           pt.Dirichlet(0.0))
    # the scalar border keys follow the plane classification of the scalar
    # assembly: "bottom"/"top" are the x = 0 and x = 1 planes
    bc_T = pt.BorderConditions({"bottom": pt.Dirichlet(0.5),
                                "top": pt.Dirichlet(-0.5),
                                "left": pt.Neumann(0.0),
                                "right": pt.Neumann(0.0)})
    cap = fl.capacity_p
    T0 = (0.5 - torch.clamp(cap.C_om[..., 0], 0, 1)) * (cap.V > 0)
    return NavierStokesScalarCoupler(
        mom, cap, pt.make_diffusion_ops(cap), kappa=nu / Pr,
        scalar_source=lambda x, y, z, t: 0.0, bc_scalar=bc_T,
        bc_scalar_cut=pt.Dirichlet(0.0),
        strategy=PicardCoupling(tol_T=1e-6, tol_U=1e-6, maxiter=8),
        beta=1.0, gravity=(0.0, -1.0), T_ref=0.0, T0=(T0, T0))


def phase_ns_scalar(pt, ks, device, rows, n=HEAT_N, steps=HEAT_STEPS):
    log("== phase 18: the coupled scalar path on the card")
    from penguin_tpu_torch.solvers import (NavierStokesMono,
                                           NavierStokesScalarCoupler,
                                           PassiveCoupling, StreamVorticity)
    f64 = torch.float64
    reset_launches(ks)
    # (d) the differentially heated cavity by run_fast (pgmres), from the
    # linear start, cut to a few steps: Nu is reported, not gated
    c = heated_cavity(pt, n, device)
    dt = 0.05
    sync(device)
    t0 = time.perf_counter()
    c.run_fast(dt, (steps - 1) * dt, scheme="BE", picard_iters=2, tol=1e-6,
               method="pgmres")
    x_prev = c.x
    c.run_fast(dt, steps * dt, scheme="BE", picard_iters=2, tol=1e-6,
               method="pgmres")
    sync(device)
    wall = time.perf_counter() - t0
    du = max((a - b).abs().max().item() for a, b in zip(c.x, x_prev)) / dt
    d = 1.0 / n
    T = c.T[0]
    dTdx = (-1.5 * T[0, :] + 2.0 * T[1, :] - 0.5 * T[2, :]) / d
    nu_hot = float(torch.mean(-dTdx[1:-1]))
    log(f"differentially heated cavity Ra=1e3 {n}² f64, run_fast (2 Picard "
        f"sweeps of pgmres a step): {steps} steps to t = {c.time:.2f} in "
        f"{wall:.2f} s ({wall / steps * 1e3:.1f} ms per step); last step's "
        f"max|du/dt| {du:.2e} (steady below 2e-5); momentum pgmres "
        f"iterations (last sweep) "
        f"{c.krylov_iters_u.tolist()}, relres "
        f"{', '.join(f'{v:.2e}' for v in c.krylov_relres_u)} (maxiter 200), "
        f"scalar {c.krylov_iters_T.tolist()}; hot-wall Nu "
        f"{nu_hot:.4f} (de Vahl Davis 1.116 at steady)")
    finite = all(bool(torch.isfinite(t).all()) for t in c.x + c.T)
    log(f"heated cavity: gated on finite values only ({finite}); the Nu "
        f"gate needs the steady state, which {steps} steps do not reach "
        f"(cut for time)")
    if not finite:
        raise AssertionError("heated cavity: non-finite state")
    rows["heated"] = dict(coupler=c, wall=wall, steps=steps)
    # the JAX tests' gates at their sizes: buoyancy starts the circulation
    # (tests/test_streamvort_nsscalar.py:283), enstrophy decays under
    # stream-vorticity (:257)
    m = 16
    fl = stokes_fluid(pt, None, m, 1.0, f64, device, mu=1e-2)
    mom = NavierStokesMono(fl, (stokes_walls(pt), stokes_walls(pt)), None,
                           pt.Dirichlet(0.0))
    cap = fl.capacity_p
    T0 = torch.clamp(1.0 - cap.C_om[..., 0], 0.0, 1.0) * (cap.V > 0)
    cp = NavierStokesScalarCoupler(
        mom, cap, fl.operator_p, kappa=1e-2,
        scalar_source=lambda x, y, z, t: 0.0,
        bc_scalar=pt.BorderConditions({"left": pt.Dirichlet(1.0),
                                       "right": pt.Dirichlet(0.0)}),
        bc_scalar_cut=pt.Dirichlet(0.0), strategy=PassiveCoupling(),
        beta=10.0, T0=(T0, T0))
    cp.run(dt=0.01, t_end=0.05)
    uy = cp.x[2]
    left = uy[1:4, 1:m - 1].mean().item()
    right = uy[m - 4:m - 1, 1:m - 1].mean().item()
    log(f"buoyant cavity {m}² f64, passive coupling, 5 lstsq steps: mean "
        f"u_y near the hot wall {left:+.2e}, near the cold wall "
        f"{right:+.2e} (gate: up, down)")
    if not (left > 0 and right < 0 and uy.abs().max().item() > 1e-4):
        raise AssertionError("buoyant cavity: a gate failed")
    k = 24
    mesh = pt.Mesh((k, k), (1.0, 1.0), (0.0, 0.0))
    cap = pt.compute_capacity(pt.geometry.full_domain(2), mesh, p=4, s=1,
                              dtype=f64, device=device)
    C = cap.C_om
    w0 = torch.exp(-((C[..., 0] - 0.5) ** 2 + (C[..., 1] - 0.5) ** 2)
                   / 0.01) * (cap.V > 0)
    bords = stokes_walls(pt)
    sv = StreamVorticity(cap, 0.05, 1e-3, pt.make_diffusion_ops(cap),
                         bc_stream_border=bords, bc_vorticity_border=bords,
                         omega0=(w0, torch.zeros_like(w0)))
    e0 = float((w0 ** 2 * cap.V).sum())
    sv.run(4)
    e1 = float((sv.omega[0] ** 2 * cap.V).sum())
    log(f"stream-vorticity Gaussian {k}² f64, 4 direct steps: enstrophy "
        f"{e0:.4e} -> {e1:.4e} (gate: decays), max|u| "
        f"{sv.velocity[0].abs().max().item():.3e}")
    if not (0 < e1 < e0 and sv.velocity[0].abs().max().item() > 0):
        raise AssertionError("stream-vorticity: a gate failed")
    read_launches(ks, "the coupled scalar path (phase 18)")


def ns_cases(pt, device, fluids):
    """(label, run, gate) triples for the Navier-Stokes path's card-vs-CPU
    comparison in f64, with the gates of :func:`stokes_cases`: "eq" (1e-9
    of scale, equal counts) on the operators, diagnostics and the direct,
    Picard and Newton paths; "resid" (the card's solution in the CPU's
    system to 10x the tolerance) on the Krylov paths."""
    from penguin_tpu_torch.linsolve import _ravel
    from penguin_tpu_torch.solvers import (NavierStokesScalarCoupler,
                                           PicardCoupling, StreamVorticity)
    from penguin_tpu_torch.solvers.ns_scalar import (MonolithicCoupling,
                                                     PassiveCoupling)

    def relres(apply_fn, b):
        def fn(out):
            r = tuple(bb - aa for bb, aa in
                      zip(b, apply_fn(tuple(out[:len(b)]))))
            return (torch.linalg.vector_norm(_ravel(r)[0])
                    / torch.linalg.vector_norm(_ravel(b)[0])).item()
        return fn

    f64 = torch.float64
    g = torch.Generator().manual_seed(19)

    def seeded(s, amp=1.0):
        return tuple(amp * torch.randn(t.shape, generator=g,
                                       dtype=f64).to(device)
                     for t in s.zero_state())

    def chan():
        return dfg_solver(pt, None, f64, device, 0.3,
                          fluid=fluids["channel"])

    def cav():
        return ns_cavity(pt, 0, f64, device, 100.0, fluid=fluids["cavity"])

    base = chan()
    r, q = seeded(base), seeded(base, 0.5)
    cases = []

    def ops():
        s = base
        out = s.conv_vectors(r) + s.make_picard_apply(r)(q)
        out += s.nonlinear_residual(r, s.rhs_steady())
        out += s._picard_rows(r, 0.01, 0.5)(q)
        out += s.make_unsteady_rhs(0.01, 0.5)(
            r, 0.1, 0.11, extra_mom=tuple(-c for c in s.conv_vectors(q)))
        return out, None

    cases.append(("conv_vectors, Picard applies, residual, AB2 rhs", ops,
                  "eq"))

    def diagnostics():
        s = base
        box = (0.1, 0.4, 0.08, 0.33)
        x = tuple(0.1 * t for t in q)
        out = (s.make_pressure_probe(DFG_PROBES)(x),)
        out += s.make_control_volume_recorder(box)(x)
        out += tuple(torch.tensor(v, dtype=f64) for v in
                     s.control_volume_force(box, x=x)
                     + tuple(s.pressure_probe(DFG_PROBES, x=x)))
        return out, None

    cases.append(("control-volume force (host, recorder), LSQ probes",
                  diagnostics, "eq"))

    def picard_steady():
        s = cav()
        s.solve_steady(max_iter=3, tol=1e-12)
        return s.x, [len(s.residual_history)]

    def newton():
        s = cav()
        s.solve_steady_newton(max_iter=3, tol=1e-11, picard_warmup=1)
        return s.x, [len(s.residual_history)]

    cases.append(("solve_steady lstsq, 3 sweeps", picard_steady, "eq"))
    cases.append(("solve_steady_newton (jacfwd)", newton, "eq"))

    def unsteady(method):
        def run():
            s = chan()
            x0 = tuple(0.1 * t for t in r)
            rec = s.make_pressure_probe(DFG_PROBES) if method == "direct" \
                else None
            t_end = 3 * 0.01 if method == "direct" else 0.01
            s.solve_unsteady(0.01, t_end, scheme="CN", method=method, x0=x0,
                             tol=1e-10, record=rec)
            out = s.x + s.conv_prev_out
            if rec is not None:
                out += (torch.as_tensor(s.record_log),)
            conv = s.conv_vectors(x0)
            b = s.make_unsteady_rhs(0.01, 0.5)(
                x0, 0.0, 0.01, extra_mom=tuple(-c for c in conv))
            return (out, getattr(s, "krylov_iters", np.zeros(0)).tolist(),
                    relres(s.make_unsteady_apply(0.01, 0.5), b))
        return run

    cases.append(("solve_unsteady AB2/CN direct, 3 steps with a record",
                  unsteady("direct"), "eq"))
    for method in ("pbicgstab", "pgmres", "fgmres"):
        cases.append((f"solve_unsteady CN {method}, one step",
                      unsteady(method), "resid"))

    def picard(method):
        def run():
            s = chan()
            x0 = tuple(0.1 * t for t in r)
            if method == "lstsq":
                s = cav()
                x0 = tuple(0.1 * t for t in seeded(s))
                s.solve_unsteady_picard(0.01, 0.02, scheme="CN",
                                        picard_iters=2, x0=x0)
                return s.x, None, None
            s.solve_unsteady_picard(0.01, 0.01, scheme="CN", picard_iters=1,
                                    method="fgmres", tol=1e-10,
                                    maxiter=400, x0=x0)
            conv = s.conv_vectors(x0)
            b = s.make_unsteady_rhs(0.01, 0.5)(
                x0, 0.0, 0.01, extra_mom=tuple(-0.5 * c for c in conv))
            return (s.x, s.krylov_iters.tolist(),
                    relres(s._picard_rows(x0, 0.01, 0.5), b))
        return run

    cases.append(("solve_unsteady_picard lstsq, 2 steps",
                  picard("lstsq"), "eq"))
    cases.append(("solve_unsteady_picard fgmres, one sweep",
                  picard("fgmres"), "resid"))

    def jfnk():
        s = cav()
        s.solve_steady_newton_krylov(max_iter=12, tol=1e-5)
        b = s.rhs_steady()
        return (s.x, None,
                lambda out: float(torch.sqrt(sum(torch.sum(a * a) for a in
                                                 s.nonlinear_residual(
                                                     tuple(out), b)))))

    cases.append(("solve_steady_newton_krylov (fgmres), |R| (gate 1e-4)",
                  jfnk, "resid", 1e-4))

    def streamvort():
        cap = fluids["cavity"].capacity_p
        C = cap.C_om
        w0 = torch.exp(-((C[..., 0] - 0.45) ** 2 + (C[..., 1] - 0.5) ** 2)
                       / 0.02) * (cap.V > 0)
        sv = StreamVorticity(cap, 0.05, 1e-2, pt.make_diffusion_ops(cap),
                             bc_stream_border=stokes_walls(pt),
                             bc_vorticity_border=stokes_walls(pt),
                             omega0=(w0, torch.zeros_like(w0)))
        sv.run(2, scheme="CN")
        return sv.omega + sv.psi + sv.velocity, None

    cases.append(("StreamVorticity, 2 CN steps", streamvort, "eq"))

    def coupler(strategy):
        fl = fluids["cavity"]
        mom = ns_cavity(pt, 0, f64, device, 100.0, fluid=fl)
        cap = fl.capacity_p
        T0 = torch.clamp(1.0 - cap.C_om[..., 0], 0.0, 1.0) * (cap.V > 0)
        return NavierStokesScalarCoupler(
            mom, cap, fl.operator_p, kappa=1e-2,
            scalar_source=lambda x, y, z, t: 0.0,
            bc_scalar=pt.BorderConditions({
                "bottom": pt.Dirichlet(1.0), "top": pt.Dirichlet(0.0),
                "left": pt.Neumann(0.0), "right": pt.Neumann(0.0)}),
            bc_scalar_cut=pt.Dirichlet(0.0), strategy=strategy, beta=10.0,
            T_ref=0.5, T0=(T0, T0))

    def steps(strategy, n_steps):
        def run():
            c = coupler(strategy)
            for _ in range(n_steps):
                c.step(0.01)
            return c.x + c.T, None
        return run

    cases.append(("coupler passive, 2 lstsq steps",
                  steps(PassiveCoupling(), 2), "eq"))
    cases.append(("coupler Picard, 1 step of 2 sweeps",
                  steps(PicardCoupling(tol_T=0.0, tol_U=0.0, maxiter=2), 1),
                  "eq"))
    cases.append(("coupler monolithic Newton (jacfwd), 1 step",
                  steps(MonolithicCoupling(tol=1e-11, maxiter=3), 1), "eq"))

    def fast():
        c = coupler(PicardCoupling())
        x0, T0 = c.x, c.T
        c.run_fast(0.01, 0.01, picard_iters=1, tol=1e-12, method="pgmres")
        mom = c.momentum
        conv = mom.conv_vectors(x0)
        b = mom.make_unsteady_rhs(0.01, 1.0)(
            x0, 0.0, 0.01, extra_mom=tuple(c._mom_extra(conv[d], T0[0], d)
                                           for d in range(2)))
        res_u = relres(mom.make_unsteady_apply(0.01, 1.0), b)
        af, bf, _ = c._scalar_system(0.01, "BE", c.x)
        res_T = relres(af, bf(T0, 0.0))
        n_x = len(c.x)

        def res(out):
            # the momentum and the scalar solves, each in its own system
            # (pgmres' tolerance is on the Jacobi/M-scaled residual)
            return max(res_u(out[:n_x]), res_T(out[n_x:]))

        return (c.x + c.T, [c.krylov_iters_u.tolist(),
                            c.krylov_iters_T.tolist()], res)

    cases.append(("coupler run_fast pgmres, one step", fast, "resid"))
    return cases


def phase_ns_card_vs_cpu(pt, ks, device, n=NS_CVC_N):
    log(f"== phase 19: the Navier-Stokes path, card against the CPU path "
        f"(f64, {n}² and {CVC_CHANNEL[0]} × {CVC_CHANNEL[1]})")
    f64 = torch.float64
    cpu = torch.device("cpu")
    reset_launches(ks)
    # the capacities are built on the card and copied (as in phase 16)
    channel = dfg_solver(pt, CVC_CHANNEL, f64, device, umax=0.3).fluid
    card = {
        "channel": channel,
        "cavity": stokes_fluid(pt, None, n, 1.0, f64, device, mu=0.01),
    }
    host = {k: fluid_to(pt, v, cpu) for k, v in card.items()}
    compare_cases(ns_cases(pt, device, card), ns_cases(pt, cpu, host))
    read_launches(ks, "the Navier-Stokes card-vs-CPU runs (phase 19)")


def dct2_fft(x):
    """Orthonormal DCT-II along the last axis by one FFT of the even-odd
    reordering (Makhoul 1980): timed against the matmul DCT, not used."""
    n = x.shape[-1]
    v = torch.cat([x[..., ::2], x[..., 1::2].flip(-1)], dim=-1)
    k = torch.arange(n, dtype=x.dtype, device=x.device)
    w = torch.exp(-1j * math.pi * k / (2 * n)).to(torch.complex64
                                                 if x.dtype == torch.float32
                                                 else torch.complex128)
    X = 2.0 * (torch.fft.fft(v, dim=-1) * w).real
    scale = torch.full((n,), math.sqrt(1.0 / (2 * n)), dtype=x.dtype,
                       device=x.device)
    scale[0] = math.sqrt(1.0 / (4 * n))
    return X * scale


def stokes_times(pt, rows, smi, device):
    """The Stokes path on the card: the f32 annulus solve per GMRES
    iteration, one M application split into its momentum and Schur solves,
    the apply, kernels, host syncs, busy share and peak memory of GMRES
    iterations; ms per step of the 1024² cavity; the 256² moving slab split
    into its system build (capacities) and solve; the matmul DCT against an
    FFT DCT-II."""
    from penguin_tpu_torch.linsolve import CHUNK, pbicgstab, pgmres
    from penguin_tpu_torch.solvers.stokes import _along
    fmt = lambda v: ", ".join(f"{m:.2f}" for m in v)  # noqa: E731
    cf = rows["couette_f32"]
    s, n = cf["solver"], cf["n"]
    x = s.x
    ms_apply = [cuda_ms(lambda: s.apply_steady(x), 5) for _ in range(3)]
    ms_build = [cuda_ms(lambda: s.make_block_preconditioner(), 1)
                for _ in range(2)]
    M = s.make_block_preconditioner()
    N = s.N
    rws, rp = x[0:2 * N:2], x[2 * N]
    ms_M = [cuda_ms(lambda: M(x), 5) for _ in range(3)]
    ms_mom = [cuda_ms(lambda: [M.mom_solve(d, rws[d]) for d in range(N)], 5)
              for _ in range(3)]
    ms_schur = [cuda_ms(lambda: M.schur_solve(rp), 5) for _ in range(3)]
    b = s.rhs_steady()

    def gmres(its):
        # one restart cycle of exactly ``its`` Arnoldi steps (maxiter bounds
        # whole cycles only)
        return lambda: pgmres(s.apply_steady, b, s.zero_state(), Minv=M,
                              tol=1e-30, maxiter=its, restart=its)

    # the profiler's event processing grows with the events: it sees 2
    # iterations, the timings 8
    its = 8
    ms_20 = [cuda_ms(gmres(its), 1) for _ in range(3)]
    n_kernels, busy = _profile_kernels(gmres(2))
    syncs = count_syncs(gmres(its))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    gmres(its)()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    log(f"Stokes annulus {n}² f32, schur_gmres (Chebyshev depth "
        f"{s._schur_bounds[2]}): phase 14's solve {cf['wall']:.2f} s for "
        f"{s.krylov_iters} iterations ({cf['wall'] / s.krylov_iters * 1e3:.1f}"
        f" ms per iteration with the set-up); {its} iterations alone, ms, 3 "
        f"repeats: {fmt(ms_20)} ({min(ms_20) / its:.2f} ms per iteration); "
        f"one M {fmt(ms_M)} ms, of which the momentum (Jacobi) solves "
        f"{fmt(ms_mom)} and the Chebyshev Schur solve {fmt(ms_schur)}; "
        f"apply_steady {fmt(ms_apply)} ms; building M (power iteration, one "
        f"read) {fmt(ms_build)} ms; per iteration {n_kernels / 2:.0f} "
        f"kernels (over 2), {syncs / its:.1f} host syncs; device busy "
        f"{busy / 2 / (min(ms_20) / its):.1%} ({busy / 2:.2f} ms of kernels "
        f"an iteration); peak memory above the solver's state: the phase-14 "
        f"solve (GMRES(100)) {cf['peak']:.0f} MiB, {its} iterations of "
        f"GMRES({its}) {peak:.0f} MiB [{smi}]")
    cav = rows["cavity"]
    sc = cav["solver"]
    dt = CAVITY_DT
    apply_c = sc.make_unsteady_apply(dt, 1.0)
    b_c = sc.make_unsteady_rhs(dt, 1.0)(sc.x, 0.0, dt)
    M_c = sc.make_block_preconditioner(dt=dt, theta=1.0)
    its_c = CHUNK

    def bicg():
        return pbicgstab(apply_c, b_c, sc.x, Minv=M_c, tol=1e-30,
                         maxiter=its_c)

    ms_bicg = [cuda_ms(bicg, 1) for _ in range(3)]
    syncs = count_syncs(bicg)
    n_kernels, busy = _profile_kernels(bicg)
    log(f"lid cavity {sc.fluid.mesh_p.n[0]}² f32 BE: phase 14's "
        f"{len(cav['its'])} steps in {cav['wall']:.2f} s with set-up "
        f"({cav['wall'] / len(cav['its']) * 1e3:.1f} ms per step at "
        f"{np.mean(cav['its']):.1f} BiCGStab iterations a step, stalled); "
        f"{its_c} BiCGStab iterations alone, ms: {fmt(ms_bicg)} "
        f"({min(ms_bicg) / its_c:.2f} ms per iteration, "
        f"{n_kernels / its_c:.0f} kernels and {syncs / its_c:.2f} host syncs "
        f"per iteration, busy {busy / min(ms_bicg):.1%}) [{smi}]")
    mv = rows["moving_stokes"]
    sm, dtm, xm = mv["solver"], mv["dt"], mv["x0"]
    state = {}

    def build():
        state["sys"] = sm._slab_system(galilean_body, 0.0, dtm, 1.0, "BE", 4,
                                       1, xm, dtm)

    def solve():
        from penguin_tpu_torch.linsolve import fgmres
        apply_fn, rhs_fn = state["sys"]
        state["out"] = fgmres(apply_fn, rhs_fn(), xm, Minv=state["M"],
                              tol=MOVING_STOKES_TOL, maxiter=2000,
                              restart=60)

    from penguin_tpu_torch.solvers import StokesMono
    ref = StokesMono(sm.fluid, sm.bc_u, None, sm.bc_cut, cut_flux="centroid")
    state["M"] = ref.make_block_preconditioner(dt=dtm, theta=1.0,
                                               schur="dct_cg",
                                               schur_cg_iters=8)
    ms_b = [cuda_ms(build, 1) for _ in range(2)]
    ms_s = [cuda_ms(solve, 1) for _ in range(2)]
    kb, busy_b = _profile_kernels(build)
    log(f"moving Stokes slab {mv['n']}² f32 (Galilean Couette, moment): "
        f"slab system build (three slab capacities with cut moments, "
        f"cross-moment weights) ms {fmt(ms_b)} ({kb} kernels, busy "
        f"{busy_b / min(ms_b):.1%}); fgmres solve ms {fmt(ms_s)} "
        f"({state['out'][1]} iterations, relres {state['out'][2]:.2e}) "
        f"[{smi}]")
    nc = s.fluid.mesh_p.n[0]
    g = torch.Generator(device=device).manual_seed(1)
    xs = torch.randn((nc, nc), generator=g, device=device,
                     dtype=torch.float32)
    jj = np.arange(nc)
    Cd = np.cos(np.pi * (jj[None, :] + 0.5) * jj[:, None] / nc) \
        * np.sqrt(2.0 / nc)
    Cd[0] *= np.sqrt(0.5)
    Cm = torch.as_tensor(Cd, dtype=torch.float32, device=device)

    def dct_mm():
        return _along(Cm, _along(Cm, xs, 0), 1)

    def dct_fft():
        return dct2_fft(dct2_fft(xs).T).T

    err = (dct_mm() - dct_fft()).abs().max().item() / \
        dct_mm().abs().max().item()
    mm = [cuda_ms(dct_mm, 20) * 1e3 for _ in range(3)]
    ff = [cuda_ms(dct_fft, 20) * 1e3 for _ in range(3)]
    log(f"2D DCT-II of {nc}² f32 (the dct_cg Schur's transform): matmul "
        f"{', '.join(f'{v:.1f}' for v in mm)} µs, FFT (Makhoul) "
        f"{', '.join(f'{v:.1f}' for v in ff)} µs; they agree to {err:.1e} "
        f"of scale; recorded only, the port keeps the matmul [{smi}]")


def ns_times(pt, rows, smi, device):
    """The Navier-Stokes path on the card: the DFG 2D-1 JFNK per Newton
    step and per fgmres iteration, split into the jvp of the residual
    (with the Picard apply alone beside it) and M, with kernels, host
    syncs, busy share and peak memory per iteration; the DFG 2D-2 implicit
    Picard step, whole and per fgmres iteration, likewise; ms per step of
    the heated cavity's run_fast."""
    from penguin_tpu_torch.linsolve import fgmres
    fmt = lambda v: ", ".join(f"{m:.2f}" for m in v)  # noqa: E731

    def per_iteration(solve, its):
        """(ms per iteration over 3 repeats, kernels and busy ms per
        iteration over 2, host syncs per iteration, peak MiB)."""
        ms = [cuda_ms(solve(its), 1) / its for _ in range(3)]
        n_kernels, busy = _profile_kernels(solve(2))
        syncs = count_syncs(solve(its))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        solve(its)()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        return ms, n_kernels / 2, busy / 2, syncs / its, peak

    r1 = rows["dfg1"]
    s = r1["solver"]
    x = s.x
    b = s.rhs_steady()

    def R(v):
        return s.nonlinear_residual(v, b)

    r = R(x)
    zeros = tuple(torch.zeros_like(a) for a in x)
    M = s.make_block_preconditioner(dt=None, theta=1.0, schur="dct_cg")

    def Jv(v):
        return torch.func.jvp(R, (x,), (v,))[1]

    ms_jvp = [cuda_ms(lambda: Jv(r), 5) for _ in range(3)]
    ms_apply = [cuda_ms(lambda: s.make_picard_apply(x)(r), 5)
                for _ in range(3)]
    ms_M = [cuda_ms(lambda: M(r), 5) for _ in range(3)]

    def jfnk(its):
        return lambda: fgmres(Jv, r, zeros, Minv=M, tol=1e-30, maxiter=its,
                              restart=its)

    ms, kern, busy, syncs, peak = per_iteration(jfnk, 8)
    nx, ny = s.fluid.mesh_p.n
    log(f"DFG 2D-1 {nx}×{ny} f32, JFNK: phase 17's {r1['steps']} Newton "
        f"steps in {r1['wall']:.2f} s ({r1['wall'] / max(r1['steps'], 1):.2f}"
        f" s per Newton step, {r1['wall'] / max(r1['its'], 1) * 1e3:.1f} ms "
        f"per fgmres iteration with the line search and set-up); 8 fgmres "
        f"iterations alone, ms per iteration, 3 repeats: {fmt(ms)}; one jvp "
        f"of the residual {fmt(ms_jvp)} ms (the Picard apply alone "
        f"{fmt(ms_apply)}), one M (DCT-CG Schur, 25 inner) {fmt(ms_M)} ms; "
        f"per iteration {kern:.0f} kernels, {syncs:.2f} host syncs, device "
        f"busy {busy / min(ms):.1%}; peak memory above the state {peak:.0f} "
        f"MiB [{smi}]")
    r2 = rows["dfg2"]
    s2 = r2["solver"]
    x2 = s2.x
    dt = DFG2_DT
    t_now = r2["steps"] * dt
    theta = 0.5

    M2 = s2.make_block_preconditioner(dt=dt, theta=theta, schur="dct_cg",
                                      schur_cg_iters=8)
    conv = s2.conv_vectors(x2)
    b2 = s2.make_unsteady_rhs(dt, theta)(
        x2, t_now, t_now + dt, extra_mom=tuple(-0.5 * c for c in conv))
    apply2 = s2._picard_rows(x2, dt, theta)

    def picard(its):
        return lambda: fgmres(apply2, b2, x2, Minv=M2, tol=1e-30,
                              maxiter=its, restart=its)

    ms2, kern2, busy2, syncs2, peak2 = per_iteration(picard, 8)
    ms_M2 = [cuda_ms(lambda: M2(b2), 5) for _ in range(3)]
    ms_a2 = [cuda_ms(lambda: apply2(x2), 5) for _ in range(3)]
    log(f"DFG 2D-2 {nx}×{ny} f32, CN implicit Picard: phase 17's "
        f"{r2['steps']} steps {r2['wall'] / r2['steps'] * 1e3:.1f} ms per "
        f"step with the record (mean {r2['its'].mean():.1f} fgmres "
        f"iterations in the last sweep); 8 fgmres iterations alone, ms per "
        f"iteration: {fmt(ms2)}, of which "
        f"one apply {fmt(ms_a2)} and one M (DCT-CG Schur, 8 inner) "
        f"{fmt(ms_M2)}; per iteration {kern2:.0f} kernels, {syncs2:.2f} host"
        f" syncs, busy {busy2 / min(ms2):.1%}; peak memory {peak2:.0f} MiB "
        f"[{smi}]")
    h = rows["heated"]
    log(f"heated cavity {h['coupler'].cap_T.mesh.n[0]}² f64, run_fast: "
        f"{h['wall'] / h['steps'] * 1e3:.1f} ms per step over phase 18's "
        f"{h['steps']} steps (two Picard sweeps of momentum and scalar "
        f"pgmres) [{smi}]")


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
    took = {}
    for name, fn, args in (("general", general_times, (pt, rows, smi)),
                           ("moving", moving_times, (pt, rows, smi, device)),
                           ("stefan", stefan_times, (pt, rows, smi, device)),
                           ("stokes", stokes_times, (pt, rows, smi, device)),
                           ("navier-stokes", ns_times,
                            (pt, rows, smi, device))):
        t0 = time.perf_counter()
        fn(*args)
        took[name] = round(time.perf_counter() - t0, 1)
    log(f"phase 7 seconds per path: {took}")
    return kernel_times(ks, device, smi)


def kernel_times(ks, device, smi):
    """Each stencil kernel at the main path's shape: the bare launch, the
    wrapper and the plain version back to back, and the bare launch with
    the L2 flushed before it."""
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
        # back-to-back launches find the inputs in the 50 MB L2 (stencil5's
        # 29 MB fit): time each launch alone after writing 128 MB, which
        # evicts the L2, so the kernel reads from HBM as a solver's would
        flush = torch.empty(32 * 2 ** 20, dtype=torch.float32, device=device)
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(50)]
        bare()
        for a, e in ev:
            flush.fill_(1.0)
            a.record()
            bare()
            e.record()
        torch.cuda.synchronize()
        cold = [a.elapsed_time(e) for a, e in ev]
        t_cold = float(np.median(cold))
        del flush
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
            f"({nbytes / t_p / 1e6:.0f} GB/s); with the L2 flushed before "
            f"each launch, median of 50: {t_cold * 1e3:.2f} µs (min "
            f"{min(cold) * 1e3:.2f}, {bound / t_cold:.0%} of the bound) "
            f"[{smi}]")
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
    # the moving, phase-change, Stokes and Navier-Stokes paths launch
    # neither kernel (nor do the JAX package's): their counts are those of
    # phase 3
    timed_phase("8", phase_moving, pt, device, rows)
    timed_phase("9", phase_front, pt, device, rows)
    timed_phase("10", phase_moving_card_vs_cpu, pt, device)
    timed_phase("11", phase_stefan, pt, ks, device, rows)
    timed_phase("12", phase_stefan_more, pt, device, rows)
    timed_phase("13", phase_stefan_card_vs_cpu, pt, device)
    timed_phase("14", phase_stokes, pt, ks, device, rows)
    timed_phase("15", phase_moving_stokes, pt, ks, device, rows)
    timed_phase("16", phase_stokes_card_vs_cpu, pt, device)
    timed_phase("17", phase_navier_stokes, pt, ks, device, rows)
    timed_phase("18", phase_ns_scalar, pt, ks, device, rows)
    timed_phase("19", phase_ns_card_vs_cpu, pt, ks, device)
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
