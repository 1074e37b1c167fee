"""Time the 2D kernels of the fused cycle's row march, K12 (sweep +
residual + restriction) and K13 (interp-add + sweep), and the dense
levels' sweep K1 on the card, whole and by part.

K12 (``ops/cuda_fused2.sweep_restrict``, as the V-cycle calls it: DOWN, no
residual out) runs at the main path's fused levels, 4096² 5-point and
2048², 1024² and 512² 9-point float32; K13 (``interp_sweep``: UP, without
and with the convergence norm) at 4096² 5-point and 2048² 9-point; K1
(``ops/cuda2.sweep``: DOWN with the residual, UP without, as the dense
levels run it) at the main path's dense levels, 256² down to 8² 9-point
float32, on the regime its plan picks (``plan``) and on the tile kernel
at every level (``streamed``).  Each case is first held bit for bit against its plain version
(the norm partials' sum to 1e-5), then timed with CUDA events (back to
back calls: at the small levels the wrappers' host time bounds it) and by
the device time of its kernels under torch.profiler.  K12 and K13 are
timed with each build of ``--threads`` (threads a block, a strip of twice
as many region columns, ``-DCEDAR_FUSED2_THREADS``) and of ``--ahead``
(copies that many steps ahead of their first read,
``-DCEDAR_FUSED2_AHEAD``), each bit-checked too, and with each probe: builds of csrc/fused2.cu with
``-DCEDAR_FUSED2_PROBE=bits`` that skip the q_in / q_pre row copies (1),
the CI and qc copies (2), the stencil and b copies (4), the barriers (8),
the epilogue's residual (16) or K12's restriction sum (32), whose outputs
are wrong and whose times split a call among its parts.  ``--only`` keeps
the cases whose names hold one of its words (``K1``, ``K12``, ``K13``,
``9pt``, ...).  It prints the card's name and power limit first.

Run from the repository root on a machine with a CUDA device:

    python3 cedar_tpu_torch/tools/tune_fused2.py [--threads 64] \
        [--ahead 2] [--probe 1 2 4 8 16 32] [--only K12]

With ``--tree DIR`` it times the kernels of another checkout (for example
the parent commit, unpacked with ``git archive``) under the same case
names, and with ``--probe`` also copies of that checkout whose
csrc/fused2.cu is edited to skip parts of K12's tile design (the
`sweep_restrict_fused` of an older source; :data:`PROBES`, one bit a
copy):

    python3 cedar_tpu_torch/tools/tune_fused2.py --tree DIR \
        [--probe 1 4 8 16 32] [--only K12]

``--cycles`` times instead the fused 4096² V(1,1) cycle that runs K12,
K13 and K1 (the median of 25 CUDA-event-timed cycles, as the solve runs
them); with ``--tree DIR --pairs N`` it runs N pairs of processes, this
checkout and DIR, alternating which goes first, and prints the medians of
both.  Run it as a script path, not ``-m``, so that ``--tree`` wins.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tune_fused3 as t3  # noqa: E402  (the shared timing helpers)

#: Edits of K12's tile design in csrc/fused2.cu (a source whose
#: `sweep_restrict_fused` is K12) that skip a part, by probe bit: the
#: region load of q, the phases' stencil and b reads, the barriers, the
#: residual tile, the restriction sum.  Each text must occur as often as
#: given; the bits are meant one at a time.
PROBES = {
    1: [("  const int z0 = zt - H, w0 = wt - H;\n"
         "  load_region<T, RZ>(s, q_in, z0, w0, nx, ny);",
         "  const int z0 = zt - H, w0 = wt - H;", 1)],
    4: [("*qp = A::mul(A::add(b[i], offdiag_at<T, NINE>(so, P, z, w, nx, "
         "ny, qp,\n                                                    "
         "kRW)),\n                   A::div(T(1), so[i]));",
         "*qp = A::add(qp[1], qp[-1]);", 1)],
    8: [("    __syncthreads();\n  }\n}", "  }\n}", 1),
        ("  __syncthreads();\n  phases<T, NINE, RZ>(s, so, b, z0, w0, nx, "
         "ny, colors, ncolors, 0, 0, 1);",
         "  phases<T, NINE, RZ>(s, so, b, z0, w0, nx, ny, colors, ncolors, "
         "0, 0, 1);", 1),
        ("  }\n  __syncthreads();\n  for (int r = threadIdx.y; r < kTZ; "
         "r += kBlockY) {",
         "  }\n  for (int r = threadIdx.y; r < kTZ; r += kBlockY) {", 1)],
    16: [("? residual_at<T, NINE>(s, r + H - 1, c + H - 1, so, b, z, w, "
          "nx,\n                                 ny)",
          "? s[(r + H - 1) * kRW + c + H - 1]", 1)],
    32: [("cb[(long long)zc * nyc + wc] = restrict_value(ci, fine, zc, wc);",
          "cb[(long long)zc * nyc + wc] = fine(2 * zc, 2 * wc);", 1)],
}
#: the main path's fused levels (K12) and dense levels (K1): 4096² V(1,1)
FUSED_LEVELS = (4096, 2048, 1024, 512)
DENSE_LEVELS = (256, 128, 64, 32, 16, 8)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[],
                    help="K12/K13 threads a block (a strip of twice as many "
                         "region columns) to build and time beside the "
                         "default (-DCEDAR_FUSED2_THREADS)")
    ap.add_argument("--probe", type=int, nargs="+", default=[0],
                    help="probe bits: 1 q row copies, 2 CI and qc copies, "
                         "4 stencil and b copies, 8 barriers, 16 the "
                         "epilogue's residual, 32 K12's restriction")
    ap.add_argument("--ahead", type=int, nargs="+", default=[],
                    help="steps ahead of their use that copies are issued, "
                         "to build and time beside the default "
                         "(-DCEDAR_FUSED2_AHEAD)")
    ap.add_argument("--tree", help="time this checkout's kernels instead")
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--unchecked", action="store_true",
                    help="skip the bit checks (a --tree probe copy)")
    ap.add_argument("--cycles", action="store_true",
                    help="time the fused 4096^2 V(1,1) cycle instead")
    ap.add_argument("--pairs", type=int, default=0,
                    help="--cycles --tree: pairs of runs, alternating")
    ap.add_argument("--only", nargs="+",
                    help="time only the cases whose names hold one of these")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    args.probe = sorted({0, *args.probe})
    if args.cycles and args.pairs:
        return t3.cycle_pairs(__file__, args.tree, args.pairs)
    if args.tree and len(args.probe) > 1:
        return t3.run_trees(args, __file__, "fused2", PROBES)
    sys.path.insert(0, args.tree or str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        sys.exit("tune_fused2: no CUDA device")
    from cedar_tpu_torch.ops import cuda_build, cuda_fused2

    cuda_build.load_all(["fused2", "sweep2"])
    if args.build_only:
        return
    t3.print_card()
    print(f"kernels of {cuda_fused2.__file__}", flush=True)
    if args.cycles:
        return cycles()
    cases = {k: v for k, v in make_cases().items()
             if not args.only or any(o in k.split() for o in args.only)}
    libs = {"probe=0": cuda_build.load("fused2")}
    if hasattr(cuda_fused2, "_sweep_restrict"):
        variants = {f"probe={b}": (f"CEDAR_FUSED2_PROBE={b}",)
                    for b in args.probe if b}
        variants |= {f"threads={t}": (f"CEDAR_FUSED2_THREADS={t}",)
                     for t in args.threads}
        variants |= {f"ahead={a}": (f"CEDAR_FUSED2_AHEAD={a}",)
                     for a in args.ahead}
        cuda_build.build_variants("fused2", variants.values())
        libs.update({k: cuda_build.load_variant("fused2", d)
                     for k, d in variants.items()})
        for key, (secs, log) in cuda_build.build_log.items():
            print(f"ptxas {key} ({secs:.0f} s): "
                  + "; ".join(t3.ring_report(log)), flush=True)
    print(f"[{args.tree or 'this checkout'}]", flush=True)
    from cedar_tpu_torch.ops import cuda2

    # K1 on its plan, and streamed (the tile kernel) at every shape
    k1_opts = {"plan": None}
    if hasattr(cuda2, "_sweep"):
        k1_opts["streamed"] = cuda2.Plan(0)
    for name, (kernel, plain) in cases.items():
        opts = k1_opts if name.startswith("K1 ") else libs
        if not args.unchecked:
            for label, opt in opts.items():
                if not label.startswith("probe=") or label == "probe=0":
                    t3.check(f"{name} {label}", kernel(opt), plain())
        for label, opt in opts.items():
            ms = t3.time_ms(lambda: kernel(opt), args.reps)
            dms = t3.device_ms(lambda: kernel(opt), args.reps)
            print(f"{name} {label}: {ms:.4f} ms (device {dms:.4f} ms)",
                  flush=True)


def make_cases() -> dict:
    """name -> (kernel(option), plain()): K12 DOWN without the residual at
    the fused levels, K13 UP without and with the norm at 4096² 5-point and
    2048² 9-point, K1 at the dense levels (DOWN + res, UP), float32; the
    option is a library build of csrc/fused2.cu (K12, K13) or K1's plan
    (None: the one ``cuda2.plan`` picks).
    An older checkout's wrappers take their own library and plan."""
    import torch

    from cedar_tpu_torch.ops import cuda2
    from cedar_tpu_torch.ops import cuda_fused2 as cf
    from cedar_tpu_torch.ops import interp2

    def k12(lib, *a):
        return (cf._sweep_restrict(lib, *a) if hasattr(cf, "_sweep_restrict")
                else cf.sweep_restrict(*a))

    def k13(lib, *a):
        return (cf._interp_sweep(lib, *a) if hasattr(cf, "_interp_sweep")
                else cf.interp_sweep(*a))

    cases = {}
    for k, n in enumerate(FUSED_LEVELS):
        nine = n < 4096
        pts = "9pt" if nine else "5pt"
        so, q, b, kind = problem((n, n), nine, 50 + nine + 10 * k)
        ci = interp2.setup_interp(so, kind)
        a = (so, q, b, ci, kind, "down", False)
        cases[f"K12 {pts} {n}^2"] = (lambda lib, a=a: k12(lib, *a),
                                     lambda a=a: cf.sweep_restrict_plain(*a))
        if n >= 2048:
            g = torch.Generator(device="cuda").manual_seed(60 + nine)
            qc = torch.randn((ci.shape[1] - 1, ci.shape[2] - 1), generator=g,
                             device="cuda", dtype=torch.float32)
            for norm in (False, True):
                a = (ci, qc, so, b, q, kind, "up", False, norm)
                cases[f"K13 {pts} {n}^2" + (" +norm" if norm else "")] = (
                    lambda lib, a=a: k13(lib, *a),
                    lambda a=a: cf.interp_sweep_plain(*a))
    for k, n in enumerate(DENSE_LEVELS):
        so, q, b, kind = problem((n, n), True, 70 + k)
        for updown, fuse in (("down", True), ("up", False)):
            a = (so, q, b, kind, updown, fuse)
            cases[f"K1 9pt {n}^2 {updown}" + (" +res" if fuse else "")] = (
                lambda p, a=a: (cuda2.sweep(*a) if p is None
                                else cuda2._sweep(p, *a)),
                lambda a=a: cuda2.sweep_plain(*a))
    return cases


def problem(shape, nine: bool, seed: int):
    """A diagonally dominant random float32 2D stencil (chip_smoke.py's
    ``random_problem``) with random q and b on the card."""
    import torch

    from cedar_tpu_torch.core.types import StencilKind
    from cedar_tpu_torch.ops.stencil2 import offdiag_apply

    dev, dt = "cuda", torch.float32
    g = torch.Generator(device=dev).manual_seed(seed)
    nx, ny = shape

    def u(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(s, generator=g, device=dev,
                                           dtype=dt)

    kind = StencilKind.nine_pt if nine else StencilKind.five_pt
    so = torch.zeros((kind.ndirs, nx, ny), dtype=dt, device=dev)
    so[1, 1:, :] = u(0.5, 1.5, nx - 1, ny)
    so[2, :, 1:] = u(0.5, 1.5, nx, ny - 1)
    if nine:
        so[3, 1:, 1:] = u(0.1, 0.5, nx - 1, ny - 1)
        so[4, 1:, 1:] = u(0.1, 0.5, nx - 1, ny - 1)
    so[0] = offdiag_apply(so, torch.ones(shape, dtype=dt, device=dev),
                          kind) + u(0.05, 0.2, nx, ny)
    q = torch.randn(shape, generator=g, device=dev, dtype=dt)
    b = torch.randn(shape, generator=g, device=dev, dtype=dt)
    return so, q, b, kind


def cycles(ncycles: int = 25) -> None:
    """The median, min and max CUDA-event time of ``ncycles`` fused 4096²
    Poisson V(1,1) cycles, after three warm-up cycles, each as the solve
    runs it (with the convergence residual, no readback)."""
    import torch

    import cedar_tpu_torch as ct
    from cedar_tpu_torch.solver import cycle2

    n, dev = 4096, torch.device("cuda", 0)
    conf = ct.Config({"log": [], "solver": {"cycle": {
        "nrelax-pre": 1, "nrelax-post": 1}}})
    s = ct.Solver2(ct.gallery.poisson(n, n, torch.float32, dev), ct.FivePt,
                   conf)
    b = ct.gallery.poisson_rhs(n, n, torch.float32, dev)
    t3.time_cycles("2d_poisson_4096", lambda x: cycle2.cycle_residual(
        s.levels, s.kinds, x, b, s.settings)[0], torch.zeros_like(b),
        ncycles)


if __name__ == "__main__":
    main()
