"""Time the line kernels K4 and K10 on the card over their tunables.

K4 (the zebra line sweep, ``ops/cuda_lines2.py``) runs on a 2048² 9-point
float32 grid, x- and y-lines, one zebra sweep (two launches) a call; K10
(the batched line-xy smooth, ``ops/cuda_planes2.py``) on a (64, 128, 128)
float32 batch, 5- and 9-point, two smooths and the residual a call: the
shapes of ``2d_fe_9pt_linexy_2048`` and ``3d_aniso_planexy_128``.  For each
PCR stride h (in place of ``ops/lines2.pcr_stride``'s choice for lines of
64 points or more), each shared-memory budget of a block's lines
(``ops/cuda_lines2.LINE_SMEM``) and each K4 block size in rows
(``ops/cuda_lines2.K4_ROWS``) it first holds the kernels against their
plain versions (bit-equal), then prints the mean ms of CUDA-event-timed
calls, with the card's name and power limit.

Run from the repository root on a machine with a CUDA device (without
arguments it times the defaults: ``pcr_stride``'s h, ``LINE_SMEM``,
``K4_ROWS``):

    python3 -m cedar_tpu_torch.tools.tune_lines [--h 16 32 64] \
        [--smem 128 192] [--rows 2048 4096 8192]
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, cuda_lines2, cuda_planes2, lines2
from cedar_tpu_torch.ops.stencil2 import offdiag_apply


def problem(shape, nine: bool, seed: int):
    """A diagonally dominant random float32 stencil with random q and b on
    the card; ``shape`` ``(nx, ny)`` or ``(B, nx, ny)``."""
    dev, dt = "cuda", torch.float32
    g = torch.Generator(device=dev).manual_seed(seed)
    *batch, nx, ny = shape

    def u(lo, hi, *s):
        return lo + (hi - lo) * torch.rand((*batch, *s), generator=g,
                                           device=dev, dtype=dt)

    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    so = torch.zeros((kind.ndirs, *shape), dtype=dt, device=dev)
    so[1, ..., 1:, :] = u(0.5, 1.5, nx - 1, ny)
    so[2, ..., :, 1:] = u(0.5, 1.5, nx, ny - 1)
    if nine:
        so[3, ..., 1:, 1:] = u(0.1, 0.5, nx - 1, ny - 1)
        so[4, ..., 1:, 1:] = u(0.1, 0.5, nx - 1, ny - 1)
    so[0] = offdiag_apply(so, torch.ones(shape, dtype=dt, device=dev),
                          kind) + u(0.05, 0.2, nx, ny)
    q = torch.randn(shape, generator=g, device=dev, dtype=dt)
    b = torch.randn(shape, generator=g, device=dev, dtype=dt)
    return so, q, b, kind


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
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


def exact(what: str, got, want) -> None:
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel differs from plain version")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--h", type=int, nargs="+", default=[0],
                    help="PCR strides (0: pcr_stride's own)")
    ap.add_argument("--smem", type=int, nargs="+",
                    default=[cuda_lines2.LINE_SMEM // 1024],
                    help="LINE_SMEM values, KB")
    ap.add_argument("--rows", type=int, nargs="+",
                    default=[cuda_lines2.K4_ROWS])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("tune_lines: no CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    cuda_build.load_all(["lines2", "planes2"])
    sl, ql, bl, kl = problem((2048, 2048), True, 10)
    planes = {pts: problem((64, 128, 128), pts == "9pt", 20 + i)
              for i, pts in enumerate(("5pt", "9pt"))}
    saved = (lines2.pcr_stride, cuda_lines2.LINE_SMEM, cuda_lines2.K4_ROWS)
    rule = saved[0]
    try:
        for h in args.h:
            lines2.pcr_stride = (
                (lambda n, full=False, h=h: h if rule(n) else 0) if h
                else rule)
            for kb in args.smem:
                cuda_lines2.LINE_SMEM = kb * 1024
                tag = f"h={h} smem={kb}K"
                for pts, args10 in planes.items():
                    time_k10(f"{tag} K10 {pts} (64, 128, 128) x2 +res",
                             *args10)
                for rows in args.rows:
                    cuda_lines2.K4_ROWS = rows
                    for axis in ("x", "y"):
                        time_k4(f"{tag} rows={rows} K4 {axis} 2048^2 9pt",
                                axis, sl, ql, bl, kl)
    finally:
        (lines2.pcr_stride, cuda_lines2.LINE_SMEM,
         cuda_lines2.K4_ROWS) = saved


def time_k10(what: str, so, q, b, kind) -> None:
    """K10, 2 DOWN smooths and the residual: bit-checked, then timed."""
    got = cuda_planes2.smooth(so, q.clone(), b, kind, "down", 2, True)
    want = cuda_planes2.smooth_plain(so, q.clone(), b, kind, "down", 2, True)
    exact(what, got[0], want[0])
    exact(what + " res", got[1], want[1])
    ms = time_ms(lambda: cuda_planes2.smooth(so, q, b, kind, "down", 2, True))
    print(f"{what}: {ms:.4f} ms", flush=True)


def time_k4(what: str, axis: str, so, q, b, kind) -> None:
    """K4, one DOWN zebra sweep: bit-checked, then timed."""
    x = axis == "x"
    kern = cuda_lines2.line_x if x else cuda_lines2.line_y
    plain = cuda_lines2.line_x_plain if x else cuda_lines2.line_y_plain
    exact(what, kern(so, q.clone(), b, kind, "down"),
          plain(so, q.clone(), b, kind, "down"))
    ms = time_ms(lambda: kern(so, q, b, kind, "down"))
    print(f"{what}: {ms:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
