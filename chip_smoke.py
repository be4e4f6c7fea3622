#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``penguin_tpu_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

It builds the hand-written CUDA stencil kernels from ``penguin_tpu_torch/
csrc`` with nvcc, checks each against its plain PyTorch version on the card,
runs the benchmark slice (1024² cut-cell backward-Euler heat step, f32, at
the easy dt = 0.25 h² and the stiff dt = 100 h²) plus its 3D counterpart
(128³ sphere, the 7-point kernel) through the solver's entry points, checks
the results, compares the card with the port's CPU path, and times the
steps and the kernels with CUDA events.  Every phase raises on failure, so
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


def phase_times(ks, rows, device):
    log("== phase 5: times on the card (CUDA events)")
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
            f"span last={int(last)} max={int(mx)}{mean}")
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
        log(f"{name} {shape} f32, {nbytes / 1e6:.1f} MB per call: kernel "
            f"{t_k * 1e3:.2f} µs ({nbytes / t_k / 1e6:.0f} GB/s effective), "
            f"through the wrapper {t_w * 1e3:.2f} µs, plain torch "
            f"{t_p * 1e3:.2f} µs ({nbytes / t_p / 1e6:.0f} GB/s)")
        kernels.append(dict(name=name, ms=t_k, plain_ms=t_p))
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
    timed = phase_times(ks, rows, device)
    replaces = {"stencil5_matvec": "penguin_tpu/pallas_kernels/stencil.py:250",
                "stencil7_matvec": "penguin_tpu/pallas_kernels/stencil.py:220"}
    kernels = [dict(name=t["name"], route="cuda",
                    source="penguin_tpu_torch/csrc/stencil.cu",
                    replaces=replaces[t["name"]],
                    launches=launches[t["name"]],
                    max_abs_err=errs[t["name"]], ms=t["ms"],
                    plain_ms=t["plain_ms"]) for t in timed]
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s on "
        f"{smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
