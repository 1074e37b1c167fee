#!/usr/bin/env python
"""GPU smoke test of cedar_tpu_torch: builds the CUDA kernels, holds each
against its plain PyTorch version, and drives the 2D V-cycle solve on the
card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. device: the card's name and power limit;
2. build: the kernels from ``cedar_tpu_torch/csrc`` with nvcc;
3. kernel against plain version for the sweep (K1), restrict (K2) and
   interp-add (K3) at (4096, 4096) and (2049, 2049) in float32 and
   (400, 400) and (1025, 771) in float64;
4. Cedar's 400² float64 residual history through the kernels;
5. the main path: 2D Poisson 4096² float32, V(1,1), setup and a solve of
   four cycles, with every kernel's launch count; the convergence rate on
   A x = 0 from a random start; then the per-cycle time;
6. per-kernel times at the 4096² main-path shapes, kernel against plain.

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

from cedar_tpu_torch import Config, FivePt, Solver2, gallery
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda2, cuda_build, cuda_transfer2, interp2
from cedar_tpu_torch.ops.stencil2 import offdiag_apply
from cedar_tpu_torch.solver import cycle2

CEDAR_HISTORY = [
    0.388629, 0.0443548, 0.00494131, 0.000513399, 5.44908e-05,
    5.60612e-06, 5.86933e-07, 6.04942e-08, 6.30975e-09, 6.52713e-10,
]
CEDAR_ERROR = 2.04592e-05
# kernel against plain version: max |kernel - plain| <= TOL * max |plain|
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
SHAPES = [((4096, 4096), torch.float32), ((2049, 2049), torch.float32),
          ((400, 400), torch.float64), ((1025, 771), torch.float64)]
REPLACES = {
    "sweep2": "cedar_tpu/ops/pallas2.py:137",
    "restrict2": "cedar_tpu/ops/pallas_transfer2.py:126",
    "interp_add2": "cedar_tpu/ops/pallas_transfer2.py:256",
}
SOURCES = {
    "sweep2": "cedar_tpu_torch/csrc/sweep2.cu",
    "restrict2": "cedar_tpu_torch/csrc/transfer2.cu",
    "interp_add2": "cedar_tpu_torch/csrc/transfer2.cu",
}

DEV = torch.device("cuda", 0)


def counts() -> dict:
    return {
        "sweep2": cuda2.launches,
        "restrict2": cuda_transfer2.restrict_launches,
        "interp_add2": cuda_transfer2.interp_launches,
        "sweep2_plain": cuda2.plain_calls,
        "restrict2_plain": cuda_transfer2.restrict_plain_calls,
        "interp_add2_plain": cuda_transfer2.interp_plain_calls,
    }


def reset_counts() -> None:
    cuda2.launches = cuda2.plain_calls = 0
    cuda_transfer2.restrict_launches = cuda_transfer2.interp_launches = 0
    cuda_transfer2.restrict_plain_calls = 0
    cuda_transfer2.interp_plain_calls = 0


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
    for name in ("sweep2", "transfer2"):
        cuda_build.load(name)
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
    errs = {"sweep2": 0.0, "restrict2": 0.0, "interp_add2": 0.0}
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
    for k in ("sweep2", "restrict2", "interp_add2"):
        if c[k] <= 0 or c[k + "_plain"] != 0:
            raise AssertionError(f"Cedar gate did not run {k} on the card")


def phase_main_path() -> dict:
    n = 4096
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
    for k in ("sweep2", "restrict2", "interp_add2"):
        if launches[k] <= 0 or launches[k + "_plain"] != 0:
            raise AssertionError(f"main path did not launch {k}")

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

    # per-cycle time: CUDA events around each cycle as the solve runs it
    # (fused convergence residual, no readback), median of 25
    for _ in range(3):
        x, _ = cycle2.ncycle(s.levels, s.kinds, 0, x, b, s.settings,
                             fuse_final_residual=True)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(25)]
    t0 = time.perf_counter()
    for e0, e1 in ev:
        e0.record()
        x, _ = cycle2.ncycle(s.levels, s.kinds, 0, x, b, s.settings,
                             fuse_final_residual=True)
        e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / len(ev)
    cyc = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
    ms = statistics.median(cyc)
    peak = torch.cuda.max_memory_allocated()
    print(f"  cycle ms: median {ms:.4f}, min {cyc[0]:.4f}, max {cyc[-1]:.4f}"
          f" (host clock {host_ms:.4f} ms/cycle)", flush=True)
    print(f"  DOF/s: {n * n / (ms * 1e-3):.4e}; peak memory "
          f"{peak / 2**20:.1f} MiB", flush=True)
    return launches


def time_ms(fn, reps=20) -> float:
    for _ in range(3):
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
    """Kernel against plain at the main path's 4096² shapes, in turns
    (plain, kernel, kernel, plain)."""
    print("[6] per-kernel ms at 4096^2 float32 (plain, kernel, kernel, "
          "plain)", flush=True)
    so, q, b, kind = random_problem((4096, 4096), False, torch.float32, 7)
    so9, q9, b9, kind9 = random_problem((2049, 2049), True, torch.float32, 8)
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
    }
    out = {}
    for name, (plain, kernel) in cases.items():
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                          time_ms(plain))
        out[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        print(f"  {name}: plain {p1:.4f} kernel {k1:.4f} kernel {k2:.4f} "
              f"plain {p2:.4f}", flush=True)
    return out


def main() -> None:
    phase_device()
    phase_build()
    errs = phase_kernels()
    phase_cedar_gate()
    launches = phase_main_path()
    times = phase_times()
    table = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in ("sweep2", "restrict2", "interp_add2")
    ]
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
