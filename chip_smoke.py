#!/usr/bin/env python
"""GPU smoke test of cedar_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version, and drives the 2D V-cycle, line-xy and
F-cycle solves on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. device: the card's name and power limit;
2. build: the kernels from ``cedar_tpu_torch/csrc``, one nvcc per source,
   all started together;
3. kernel against plain version for the sweep (K1), restrict (K2),
   interp-add (K3), zebra line sweep (K4: x and y) and interp (K5) at
   (4096, 4096), (2049, 2049) and (2048, 2048) in float32 and (400, 400)
   and (1025, 771) in float64;
4. Cedar's 400² float64 residual history through the kernels;
4b. float64 gates of the line-xy and F-cycle paths: the 400² solves on the
   card against the same solves on the CPU (plain versions);
5. the main path: 2D Poisson 4096² float32, V(1,1), setup and a solve of
   four cycles, with every kernel's launch count; the convergence rate on
   A x = 0 from a random start; then the per-cycle time;
5b. the slice at full width: ``2d_fe_9pt_linexy_2048`` and
   ``2d_poisson_fcycle_4096`` (``bench.py``'s configurations), each with
   setup, a solve, launch counts, per-cycle time and peak memory;
6. per-kernel times at the main paths' shapes, kernel against plain.

It imports neither JAX nor cedar_tpu.  Without a CUDA device it exits
non-zero before printing any result.  The line before the last is the
kernel table as JSON; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cedar_tpu_torch import Config, FivePt, NinePt, Solver2, gallery
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import (
    cuda2, cuda_build, cuda_lines2, cuda_transfer2, interp2,
)
from cedar_tpu_torch.ops.stencil2 import offdiag_apply, residual
from cedar_tpu_torch.solver import cycle2

CEDAR_HISTORY = [
    0.388629, 0.0443548, 0.00494131, 0.000513399, 5.44908e-05,
    5.60612e-06, 5.86933e-07, 6.04942e-08, 6.30975e-09, 6.52713e-10,
]
CEDAR_ERROR = 2.04592e-05
# kernel against plain version: max |kernel - plain| <= TOL * max |plain|
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SHAPES = [((4096, 4096), torch.float32), ((2049, 2049), torch.float32),
          ((2048, 2048), torch.float32),
          ((400, 400), torch.float64), ((1025, 771), torch.float64)]
REPLACES = {
    "sweep2": "cedar_tpu/ops/pallas2.py:137",
    "restrict2": "cedar_tpu/ops/pallas_transfer2.py:126",
    "interp_add2": "cedar_tpu/ops/pallas_transfer2.py:256",
    "line2": "cedar_tpu/ops/pallas_lines2.py:142",
    "interp2": "cedar_tpu/ops/pallas_transfer2.py:817",
}
SOURCES = {
    "sweep2": "cedar_tpu_torch/csrc/sweep2.cu",
    "restrict2": "cedar_tpu_torch/csrc/transfer2.cu",
    "interp_add2": "cedar_tpu_torch/csrc/transfer2.cu",
    "line2": "cedar_tpu_torch/csrc/lines2.cu",
    "interp2": "cedar_tpu_torch/csrc/transfer2.cu",
}
KERNELS = tuple(REPLACES)
# full widths: the V-cycle main path and the F-cycle at N_MAIN², line-xy
# at N_LINES² (bench.py's configurations)
N_MAIN = 4096
N_LINES = 2048

DEV = torch.device("cuda", 0)


def counts() -> dict:
    return {
        "sweep2": cuda2.launches,
        "restrict2": cuda_transfer2.restrict_launches,
        "interp_add2": cuda_transfer2.interp_launches,
        "line2": cuda_lines2.launches,
        "interp2": cuda_transfer2.interp2_launches,
        "sweep2_plain": cuda2.plain_calls,
        "restrict2_plain": cuda_transfer2.restrict_plain_calls,
        "interp_add2_plain": cuda_transfer2.interp_plain_calls,
        "line2_plain": cuda_lines2.plain_calls,
        "interp2_plain": cuda_transfer2.interp2_plain_calls,
    }


def reset_counts() -> None:
    cuda2.launches = cuda2.plain_calls = 0
    cuda_transfer2.restrict_launches = cuda_transfer2.interp_launches = 0
    cuda_transfer2.restrict_plain_calls = 0
    cuda_transfer2.interp_plain_calls = 0
    cuda_transfer2.interp2_launches = cuda_transfer2.interp2_plain_calls = 0
    cuda_lines2.launches = cuda_lines2.plain_calls = 0


def require_launched(c: dict, names, what: str) -> None:
    """Each kernel of ``names`` launched, and no plain version ran."""
    for k in names:
        if c[k] <= 0:
            raise AssertionError(f"{what} did not launch {k}")
    for k in KERNELS:
        if c[k + "_plain"] != 0:
            raise AssertionError(f"{what} ran the plain version of {k}")


def random_problem(shape, nine: bool, dtype, seed: int):
    """A diagonally dominant random stencil (the layout of
    tests/test_kernels_2d.random_so) with random q and b, made on the card
    from ``seed``."""
    g = torch.Generator(device=DEV).manual_seed(seed)
    nx, ny = shape

    def u(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(s, generator=g, device=DEV,
                                           dtype=dtype)

    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    so = torch.zeros((kind.ndirs, nx, ny), dtype=dtype, device=DEV)
    so[1, 1:, :] = u(0.5, 1.5, nx - 1, ny)
    so[2, :, 1:] = u(0.5, 1.5, nx, ny - 1)
    if nine:
        so[3, 1:, 1:] = u(0.1, 0.5, nx - 1, ny - 1)
        so[4, 1:, 1:] = u(0.1, 0.5, nx - 1, ny - 1)
    so[0] = offdiag_apply(so, torch.ones(shape, dtype=dtype, device=DEV),
                          kind) + u(0.05, 0.2, nx, ny)
    q = torch.randn(shape, generator=g, device=DEV, dtype=dtype)
    b = torch.randn(shape, generator=g, device=DEV, dtype=dtype)
    return so, q, b, kind


def compare(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: shape {tuple(got.shape)} or "
                             "non-finite values")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = TOL[want.dtype] * scale
    print(f"  {what}: max_abs_err={err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{what}: kernel disagrees with plain version")
    return err


def phase_device() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[1] device: {name}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda_build.load_all()
    print(f"[2] build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, (secs, log) in cuda_build.build_log.items():
        print(f"  nvcc {name}: {secs:.2f} s", flush=True)
        entry = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line:
                print(f"    {entry}: {line.split(':', 1)[1].strip()}",
                      flush=True)


def phase_kernels() -> dict:
    print("[3] kernels against plain versions", flush=True)
    errs = dict.fromkeys(KERNELS, 0.0)
    for i, (shape, dtype) in enumerate(SHAPES):
        tag = f"{shape} {str(dtype).replace('torch.', '')}"
        odd = shape == (1025, 771)
        for nine in (False, True):
            so, q, b, kind = random_problem(shape, nine, dtype, 100 + i)
            pts = "9pt" if nine else "5pt"
            origins = [(0, 0), (1, 2)] if odd else [(0, 0)]
            for updown in ("down", "up"):
                for fuse in (False, True):
                    for origin in origins:
                        got = cuda2.sweep(so, q.clone(), b, kind, updown,
                                          fuse, origin)
                        want = cuda2.sweep_plain(so, q.clone(), b, kind,
                                                 updown, fuse, origin)
                        what = (f"K1 sweep2 {pts} {updown} fuse={int(fuse)}"
                                f" origin={origin} {tag}")
                        if fuse:
                            e = max(compare(what + " q", got[0], want[0]),
                                    compare(what + " res", got[1], want[1]))
                        else:
                            e = compare(what, got, want)
                        errs["sweep2"] = max(errs["sweep2"], e)
            ci = interp2.setup_interp(so, kind)
            nc = (ci.shape[1] - 1, ci.shape[2] - 1)
            g = torch.Generator(device=DEV).manual_seed(200 + i)
            qc = torch.randn(nc, generator=g, device=DEV, dtype=dtype)
            e = compare(f"K2 restrict2 {pts} {tag}",
                        cuda_transfer2.restrict(ci, b),
                        cuda_transfer2.restrict_plain(ci, b))
            errs["restrict2"] = max(errs["restrict2"], e)
            e = compare(f"K3 interp_add2 {pts} {tag}",
                        cuda_transfer2.interp_add(ci, so, qc, b, q.clone()),
                        cuda_transfer2.interp_add_plain(ci, so, qc, b,
                                                        q.clone()))
            errs["interp_add2"] = max(errs["interp_add2"], e)
            e = compare(f"K5 interp2 {pts} {tag}",
                        cuda_transfer2.interp(ci, qc, shape),
                        cuda_transfer2.interp_plain(ci, qc, shape))
            errs["interp2"] = max(errs["interp2"], e)
            for axis in ("x", "y"):
                kernel = cuda_lines2.line_x if axis == "x" else cuda_lines2.line_y
                plain = (cuda_lines2.line_x_plain if axis == "x"
                         else cuda_lines2.line_y_plain)
                for updown in ("down", "up"):
                    e = compare(f"K4 line2 {axis} {pts} {updown} {tag}",
                                kernel(so, q.clone(), b, kind, updown),
                                plain(so, q.clone(), b, kind, updown))
                    errs["line2"] = max(errs["line2"], e)
    return errs


def phase_cedar_gate() -> None:
    print("[4] Cedar 400^2 float64 history through the kernels", flush=True)
    reset_counts()
    conf = Config({"log": [], "solver": {
        "num-levels": 7, "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-10, "max-iter": 10}})
    so = gallery.poisson(400, 400, torch.float64, DEV)
    b = gallery.poisson_rhs(400, 400, torch.float64, DEV)
    s = Solver2(so, FivePt, conf)
    x = s.solve(b)
    err = float((x - gallery.poisson_solution(400, 400, torch.float64,
                                              DEV)).abs().max())
    c = counts()
    print(f"  history: {' '.join(f'{h:g}' for h in s.history)}", flush=True)
    print(f"  solution error: {err:g}; counts: {c}", flush=True)
    np.testing.assert_allclose(s.history, CEDAR_HISTORY, rtol=2e-5)
    np.testing.assert_allclose(err, CEDAR_ERROR, rtol=1e-4)
    require_launched(c, ("sweep2", "restrict2", "interp_add2"), "Cedar gate")


def gate_solve(dev, so, kind, conf, b):
    """Setup and solve on ``dev``; returns (solver, x, counts)."""
    reset_counts()
    s = Solver2(so.to(dev), kind, conf)
    x = s.solve(b.to(dev))
    return s, x, counts()


def phase_f64_gates() -> None:
    """The line-xy and F-cycle paths in float64: on the card through the
    kernels, and on the CPU through the plain versions."""
    print("[4b] float64 line-xy and F-cycle gates, card against CPU",
          flush=True)
    n = 400
    cpu = torch.device("cpu")
    conf = Config({"log": [], "solver": {
        "relaxation": "line-xy", "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-10, "max-iter": 10}})
    so = gallery.fe(n, n, torch.float64)
    b = gallery.poisson_rhs(n, n, torch.float64)
    s, x, c = gate_solve(DEV, so, NinePt, conf, b)
    sc, xc, _ = gate_solve(cpu, so, NinePt, conf, b)
    print(f"  fe {n}^2 line-xy V(1,1): card {' '.join(f'{h:.6g}' for h in s.history)}",
          flush=True)
    print(f"  CPU: {' '.join(f'{h:.6g}' for h in sc.history)}; counts {c}",
          flush=True)
    # rtol 1e-9 holds while the residual is well above its rounding floor;
    # near 1e-10 relative, b - A x keeps only a few digits on either
    # device (setup and coarse solve sum in another order on the card),
    # hence the absolute floor of 1e-14 in relative-residual units
    np.testing.assert_allclose(s.history, sc.history, rtol=1e-9, atol=1e-14)
    if not s.history[-1] < 1e-9:
        raise AssertionError("line-xy gate did not converge")
    require_launched(c, ("line2", "restrict2", "interp_add2"), "line-xy gate")

    conf = Config({"log": [], "solver": {
        "cycle": {"type": "f", "nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-10, "max-iter": 3}})
    so = gallery.poisson(n, n, torch.float64)
    b = gallery.poisson_rhs(n, n, torch.float64)
    s, x, c = gate_solve(DEV, so, FivePt, conf, b)
    sc, _, _ = gate_solve(cpu, so, FivePt, conf, b)
    err = float((x - gallery.poisson_solution(n, n, torch.float64,
                                              DEV)).abs().max())
    print(f"  Poisson {n}^2 F-cycle: card {' '.join(f'{h:.9g}' for h in s.history)}"
          f"; CPU {' '.join(f'{h:.9g}' for h in sc.history)}", flush=True)
    print(f"  solution error {err:g}; counts {c}", flush=True)
    if len(set(s.history)) != 1:
        raise AssertionError("F-cycle history is not constant")
    np.testing.assert_allclose(s.history, sc.history, rtol=1e-9, atol=1e-14)
    if not err < 1e-3:
        raise AssertionError("F-cycle error above discretisation accuracy")
    require_launched(c, ("sweep2", "restrict2", "interp_add2", "interp2"),
                     "F-cycle gate")


def time_cycles(s, b, x, ncycles=25):
    """CUDA-event time of each of ``ncycles`` cycles as the solve runs them
    (the cycle and the convergence residual, fused where the solve fuses
    it; no readback), after three warm-up cycles; prints the median, min,
    max and host clock."""
    def one(x):
        return cycle2.cycle_residual(s.levels, s.kinds, x, b, s.settings)[0]

    for _ in range(3):
        x = one(x)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(ncycles)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for e0, e1 in ev:
        e0.record()
        x = one(x)
        e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / ncycles
    cyc = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
    ms = statistics.median(cyc)
    print(f"  cycle ms: median {ms:.4f}, min {cyc[0]:.4f}, max {cyc[-1]:.4f}"
          f" (host clock {host_ms:.4f} ms/cycle)", flush=True)
    return ms


def phase_main_path() -> dict:
    n = N_MAIN
    print(f"[5] main path: Poisson {n}^2 float32 V(1,1)", flush=True)
    conf = Config({"log": [], "solver": {
        "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "tol": 1e-7, "max-iter": 4}})
    so = gallery.poisson(n, n, torch.float32, DEV)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = Solver2(so, FivePt, conf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = s.solve(b)
    torch.cuda.synchronize()
    launches = counts()
    print(f"  levels {s.nlevels}: {s.shapes[0]} .. {s.shapes[-1]}; "
          f"setup {setup_s:.3f} s", flush=True)
    print(f"  history: {' '.join(f'{h:.6g}' for h in s.history)}", flush=True)
    print(f"  counts: {launches}", flush=True)
    if not torch.isfinite(x).all() or tuple(x.shape) != (n, n):
        raise AssertionError("main path: bad solution")
    # At this size the first cycle leaves |b - A x| / |b| near 1 (0.34 at
    # 256^2, 0.62 at 1024^2, in both packages and in float64 too), and in
    # float32 the later cycles stop near eps * cond(A), about 2e-2: four
    # cycles must still cut the residual >= 5x overall
    if not s.history[-1] < s.history[0] / 5:
        raise AssertionError("main path: the solve did not converge")
    require_launched(launches, ("sweep2", "restrict2", "interp_add2"),
                     "main path")

    # the convergence rate, free of that floor: A x = 0 from a random x0
    # (the error itself is what shrinks); each of 4 cycles must cut >= 5x
    g = torch.Generator(device=DEV).manual_seed(11)
    x0 = torch.randn((n, n), generator=g, device=DEV, dtype=torch.float32)
    s.solve(torch.zeros_like(b), x0)
    h = [1.0] + s.history
    print(f"  A x = 0 from random x0: {' '.join(f'{v:.6g}' for v in h[1:])}",
          flush=True)
    if len(h) < 5 or any(h[i + 1] > h[i] / 5 for i in range(4)):
        raise AssertionError("main path: a cycle cut the residual < 5x")

    ms = time_cycles(s, b, x)
    peak = torch.cuda.max_memory_allocated()
    print(f"  DOF/s: {n * n / (ms * 1e-3):.4e}; peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    return launches


def phase_linexy_2048() -> dict:
    """``2d_fe_9pt_linexy_2048`` (bench.py:139-149) on the port."""
    name, n = "2d_fe_9pt_linexy_2048", N_LINES
    print(f"[5b] {name}: fe {n}^2 9-pt float32, line-xy V(1,1)", flush=True)
    conf = Config({"log": [], "solver": {
        "relaxation": "line-xy", "cycle": {"nrelax-pre": 1, "nrelax-post": 1},
        "max-iter": 4, "tol": 1e-6}})
    so = gallery.fe(n, n, torch.float32, DEV)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = Solver2(so, NinePt, conf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = s.solve(b)
    torch.cuda.synchronize()
    launches = counts()
    print(f"  {name}: levels {s.nlevels}: {s.shapes[0]} .. {s.shapes[-1]}; "
          f"setup {setup_s:.3f} s", flush=True)
    print(f"  {name}: history {' '.join(f'{h:.6g}' for h in s.history)}",
          flush=True)
    print(f"  {name}: counts {launches}", flush=True)
    if not torch.isfinite(x).all() or tuple(x.shape) != (n, n):
        raise AssertionError(f"{name}: bad solution")
    if not s.history[-1] < s.history[0] / 5:
        raise AssertionError(f"{name}: the solve did not converge")
    require_launched(launches, ("line2", "restrict2", "interp_add2"), name)

    # the convergence rate on A x = 0 from a random x0, cycle by cycle as
    # the solve loop runs them (a tolerance would stop it at the f32 floor)
    g = torch.Generator(device=DEV).manual_seed(12)
    xr = torch.randn((n, n), generator=g, device=DEV, dtype=torch.float32)
    zero = torch.zeros_like(b)
    fine = s.levels[0]
    r0 = float(residual(fine.so, xr, zero, NinePt).norm())
    h = [1.0]
    for _ in range(4):
        xr = cycle2.run_cycle(s.levels, s.kinds, xr, zero, s.settings)
        h.append(float(residual(fine.so, xr, zero, NinePt).norm()) / r0)
    print(f"  {name}: A x = 0 from random x0: "
          f"{' '.join(f'{v:.6g}' for v in h[1:])}", flush=True)
    if any(not h[i + 1] <= h[i] / 5 for i in range(4)):
        raise AssertionError(f"{name}: a cycle cut the residual < 5x")

    ms = time_cycles(s, b, x)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {name}: DOF/s {n * n / (ms * 1e-3):.4e}; peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    return launches


def phase_fcycle_4096() -> dict:
    """``2d_poisson_fcycle_4096`` (bench.py:151-160) on the port."""
    name, n = "2d_poisson_fcycle_4096", N_MAIN
    print(f"[5b] {name}: Poisson {n}^2 float32, F-cycle, V(1,1) inside",
          flush=True)
    conf = Config({"log": [], "solver": {
        "cycle": {"type": "f", "nrelax-pre": 1, "nrelax-post": 1},
        "max-iter": 4, "tol": 1e-6}})
    so = gallery.poisson(n, n, torch.float32, DEV)
    b = gallery.poisson_rhs(n, n, torch.float32, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    s = Solver2(so, FivePt, conf)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    x = s.solve(b)
    torch.cuda.synchronize()
    launches = counts()
    err = float((x - gallery.poisson_solution(n, n, torch.float32,
                                              DEV)).abs().max())
    print(f"  {name}: levels {s.nlevels}; setup {setup_s:.3f} s", flush=True)
    print(f"  {name}: history {' '.join(f'{h:.9g}' for h in s.history)}; "
          f"solution error {err:g}", flush=True)
    print(f"  {name}: counts {launches}", flush=True)
    if not torch.isfinite(x).all() or tuple(x.shape) != (n, n):
        raise AssertionError(f"{name}: bad solution")
    # the F-cycle recomputes the same x each iteration (as cedar_tpu's);
    # one F-cycle reaches discretisation accuracy up to float32 rounding
    if len(set(s.history)) != 1 or not s.history[0] < 1:
        raise AssertionError(f"{name}: history not constant and < 1")
    if not err < 1e-2:
        raise AssertionError(f"{name}: solution error {err:g}")
    require_launched(launches, ("sweep2", "restrict2", "interp_add2",
                                "interp2"), name)
    ms = time_cycles(s, b, x)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {name}: DOF/s {n * n / (ms * 1e-3):.4e}; peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    return launches


def time_ms(fn, reps=20, warm=3) -> float:
    for _ in range(warm):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_times() -> dict:
    """Kernel against plain at the main paths' shapes (4096² f32; the line
    sweeps at 2048² 9-point f32), in turns (plain, kernel, kernel, plain)."""
    print("[6] per-kernel ms at 4096^2 float32, line sweeps at 2048^2 "
          "9-pt (plain, kernel, kernel, plain)", flush=True)
    n, n9 = N_MAIN, N_MAIN // 2 + 1
    so, q, b, kind = random_problem((n, n), False, torch.float32, 7)
    so9, q9, b9, kind9 = random_problem((n9, n9), True, torch.float32, 8)
    ci = interp2.setup_interp(so, kind)
    g = torch.Generator(device=DEV).manual_seed(9)
    qc = torch.randn((ci.shape[1] - 1, ci.shape[2] - 1), generator=g,
                     device=DEV, dtype=torch.float32)
    cases = {
        "sweep2": (lambda: cuda2.sweep_plain(so, q, b, kind, "down"),
                   lambda: cuda2.sweep(so, q, b, kind, "down")),
        "sweep2 +res": (
            lambda: cuda2.sweep_plain(so, q, b, kind, "down", True),
            lambda: cuda2.sweep(so, q, b, kind, "down", True)),
        "sweep2 9pt 2049^2": (
            lambda: cuda2.sweep_plain(so9, q9, b9, kind9, "down"),
            lambda: cuda2.sweep(so9, q9, b9, kind9, "down")),
        "restrict2": (lambda: cuda_transfer2.restrict_plain(ci, b),
                      lambda: cuda_transfer2.restrict(ci, b)),
        "interp_add2": (
            lambda: cuda_transfer2.interp_add_plain(ci, so, qc, b, q),
            lambda: cuda_transfer2.interp_add(ci, so, qc, b, q)),
        "interp2": (
            lambda: cuda_transfer2.interp_plain(ci, qc, (n, n)),
            lambda: cuda_transfer2.interp(ci, qc, (n, n))),
    }
    sl, ql, bl, kl = random_problem((N_LINES, N_LINES), True, torch.float32,
                                    10)
    lines = {
        "line2 x": (lambda: cuda_lines2.line_x_plain(sl, ql, bl, kl, "down"),
                    lambda: cuda_lines2.line_x(sl, ql, bl, kl, "down")),
        "line2 y": (lambda: cuda_lines2.line_y_plain(sl, ql, bl, kl, "down"),
                    lambda: cuda_lines2.line_y(sl, ql, bl, kl, "down")),
    }
    out = {}
    for name, (plain, kernel) in {**cases, **lines}.items():
        # the plain line sweep is a Python loop along the line: few reps
        pr, pw = (2, 1) if name in lines else (20, 3)
        p1, k1, k2, p2 = (time_ms(plain, pr, pw), time_ms(kernel),
                          time_ms(kernel), time_ms(plain, pr, pw))
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"  {name}: plain {p1:.4f} kernel {k1:.4f} kernel {k2:.4f} "
              f"plain {p2:.4f}", flush=True)
    # one entry per kernel: the line kernel's is the mean of its x and y
    # zebra sweeps
    out["line2"] = tuple((a + c) / 2 for a, c in zip(out["line2 x"],
                                                     out["line2 y"]))
    return out


def main() -> None:
    phase_device()
    phase_build()
    errs = phase_kernels()
    phase_cedar_gate()
    phase_f64_gates()
    launches = phase_main_path()
    launches["line2"] = phase_linexy_2048()["line2"]
    launches["interp2"] = phase_fcycle_4096()["interp2"]
    times = phase_times()
    table = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in KERNELS
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
