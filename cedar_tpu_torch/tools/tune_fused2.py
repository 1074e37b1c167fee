"""Time the fused 2D kernel K13 (interp-add + sweep) on the card, whole and
by part.

K13 (``ops/cuda_fused2.interp_sweep``, as the V-cycle calls it: UP, without
and with the convergence norm) runs at 4096² 5-point and 2048² 9-point
float32, the fine level of the 2D main path and the first 9-point level
below it.  Each case is first held bit for bit against its plain version
(the norm partials' sum to 1e-5), then timed with CUDA events.  It is timed
with each build of ``--threads`` (threads a block, a strip of twice as many
region columns, ``-DCEDAR_FUSED2_THREADS``) and of ``--ahead`` (copies that
many steps ahead of their first read, ``-DCEDAR_FUSED2_AHEAD``), each
bit-checked too, and each probe: builds of csrc/fused2.cu with ``-DCEDAR_FUSED2_PROBE=bits``
that skip the q_pre row copies (1), the CI and qc copies (2), the stencil
and b copies (4), the barriers (8) or the residual of the norm (16), whose
outputs are wrong and whose times split a call among its parts.  It prints
the card's name and power limit first.

Run from the repository root on a machine with a CUDA device:

    python3 cedar_tpu_torch/tools/tune_fused2.py [--threads 64] \
        [--ahead 2] [--probe 1 2 4 8 16]

With ``--tree DIR`` it times the kernels of another checkout (for example
the parent commit, unpacked with ``git archive``), and with ``--probe``
also copies of that checkout whose csrc/fused2.cu is edited to skip the
same parts of its tile design (:data:`PROBES`):

    python3 cedar_tpu_torch/tools/tune_fused2.py --tree DIR \
        [--probe 1 2 4 8 16]

``--cycles`` times instead the fused 4096² V(1,1) cycle that runs K12 and
K13 (the median of 25 CUDA-event-timed cycles, as the solve runs them);
with ``--tree DIR --pairs N`` it runs N pairs of processes, this checkout
and DIR, alternating which goes first, and prints the medians of both.
Run it as a script path, not ``-m``, so that ``--tree`` wins.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import tune_fused3 as t3  # noqa: E402  (the shared timing helpers)

#: Edits of the tile design of K13 in csrc/fused2.cu (an older source's
#: `interp_sweep_fused`) that skip a part, by probe bit: the region load
#: of q_pre, the interpolation's CI and qc loads, the phases' stencil and
#: b reads, the barriers, the norm's residual.  Each text must occur as
#: often as given.
PROBES = {
    1: [("load_region<T, RZ>(s_pre, q_in, z0, w0, nx, ny);", "", 1)],
    2: [("T v = interp_value(ci, qc, z, w, nxc, nyc);", "T v = T(0);", 1)],
    4: [("*qp = A::mul(A::add(b[i], offdiag_at<T, NINE>(so, P, z, w, nx, "
         "ny, qp,\n                                                    "
         "kRW)),\n                   A::div(T(1), so[i]));",
         "*qp = A::add(qp[1], qp[-1]);", 1)],
    8: [("    __syncthreads();\n  }\n}", "  }\n}", 1),
        ("  __syncthreads();\n  // K3's expression", "  // K3's expression",
         1),
        ("  __syncthreads();\n  phases<T, NINE, RZ>(s, so, b, z0, w0, nx, "
         "ny, colors, ncolors, 0, 0, 2);",
         "  phases<T, NINE, RZ>(s, so, b, z0, w0, nx, ny, colors, ncolors, "
         "0, 0, 2);", 1)],
    16: [("const T rv = residual_at<T, NINE>(s, r, c, so, b, z, w, nx, ny);",
          "const T rv = s[r * kRW + c];", 1)],
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--threads", type=int, nargs="+", default=[],
                    help="threads a block (a strip of twice as many region "
                         "columns) to build and time beside the default "
                         "(-DCEDAR_FUSED2_THREADS)")
    ap.add_argument("--probe", type=int, nargs="+", default=[0],
                    help="probe bits: 1 q_pre copies, 2 CI and qc copies, "
                         "4 stencil and b copies, 8 barriers, 16 the norm")
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

    cuda_build.load_all(["fused2"])
    if args.build_only:
        return
    t3.print_card()
    print(f"kernels of {cuda_fused2.__file__}", flush=True)
    if args.cycles:
        return cycles()
    planned = hasattr(cuda_fused2, "plan")
    cases = {k: v for k, v in make_cases(planned).items()
             if not args.only or any(o in k for o in args.only)}
    libs = {"probe=0": cuda_build.load("fused2")}
    if planned:
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
    for name, (kernel, plain) in cases.items():
        if not args.unchecked:
            for label, lib in libs.items():
                if not label.startswith("probe=") or label == "probe=0":
                    t3.check(f"{name} {label}", kernel(lib), plain())
        for label, lib in libs.items():
            ms = t3.time_ms(lambda: kernel(lib), args.reps)
            print(f"{name} {label}: {ms:.4f} ms", flush=True)


def make_cases(planned: bool) -> dict:
    """name -> (kernel(lib), plain()): K13 UP, without and with the norm,
    at 4096² 5-point and 2048² 9-point float32; an older checkout's kernel
    takes its own library and tiles (``planned`` false)."""
    import torch

    from cedar_tpu_torch.ops import cuda_fused2 as cf
    from cedar_tpu_torch.ops import interp2

    def k13(lib, *a):
        return cf._interp_sweep(lib, *a) if planned else cf.interp_sweep(*a)

    cases = {}
    for n, nine in ((4096, False), (2048, True)):
        so, q, b, kind = problem((n, n), nine, 50 + nine)
        ci = interp2.setup_interp(so, kind)
        g = torch.Generator(device="cuda").manual_seed(60 + nine)
        qc = torch.randn((ci.shape[1] - 1, ci.shape[2] - 1), generator=g,
                         device="cuda", dtype=torch.float32)
        pts = "9pt" if nine else "5pt"
        for norm in (False, True):
            a = (ci, qc, so, b, q, kind, "up", False, norm)
            cases[f"K13 {pts} {n}^2" + (" +norm" if norm else "")] = (
                lambda lib, a=a: k13(lib, *a),
                lambda a=a: cf.interp_sweep_plain(*a))
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
