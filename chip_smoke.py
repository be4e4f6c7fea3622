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
gates, compares it with the CPU path in f64, and times the steps and the
kernels with CUDA events.  Every phase raises on failure, so the exit code
is 0 only if all passed.  Without a CUDA device it exits with an error
before doing anything.

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


def log(msg):
    print(msg, flush=True)


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


def general_times(pt, rows, smi):
    """Set-up time, ms/step, Krylov iterations/step, host syncs/step, peak
    memory and the device's busy share of the general path's BE steps at
    the bench size, per method."""
    from torch.profiler import ProfilerActivity, profile
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
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
        log(f"general {n}² f32 BE {method}: set-up {t_setup:.2f} s "
            f"({setup_syncs} host syncs); ms/step over 1+{GEN_STEPS} solves,"
            f" 3 repeats: {', '.join(f'{m:.2f}' for m in ms)}; Krylov "
            f"iterations/step {np.mean(its):.2f} {its}; host syncs/step "
            f"{syncs / solves:.1f}; peak memory above the capacity "
            f"{peak:.0f} MiB; profiler: {len(kernels) / solves:.0f} kernels/"
            f"step, {busy_ms / solves:.3f} ms of device time/step, so the "
            f"device is busy {busy_ms / solves / min(ms):.1%} of the fastest "
            f"step [{smi}]")


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
    smi = phase_environment(build)
    errs = phase_kernels(ks, device)
    rows, launches = phase_main_path(pt, FastHeatBE, ks, device)
    phase_card_vs_cpu(pt, FastHeatBE, device, rows)
    phase_general(pt, device, rows)
    phase_general_card_vs_cpu(pt, device)
    timed = phase_times(pt, ks, rows, device, smi)
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
        f"{smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
