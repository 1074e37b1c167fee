"""Time the 2D kernels of the fused cycle's row march, K12 (sweep +
residual + restriction) and K13 (interp-add + sweep), and the dense
levels' sweep K1 on the card, whole and by part.

K12 (``ops/cuda_fused2.sweep_restrict``, as the V-cycle calls it: DOWN, no
residual out) runs at the main path's fused levels, 4096² 5-point and
2048², 1024² and 512² 9-point float32; K13 (``interp_sweep``: UP, without
and with the convergence norm) at 4096² 5-point and 2048² 9-point; K11
(``sweep``: DOWN, and UP with the norm, as V(2,2) runs it) at 4096²
5-point; K1 (``ops/cuda2.sweep``: DOWN with the residual, UP without, as
the dense levels run it) at the main path's dense levels, 256² down to 8²
9-point float32, and at 4096² 5-point (the dense cycle's top level), on
the regime its plan picks (``plan``) and on the tile kernel at every level
(``streamed``).  Each case is first held bit for bit against its plain version
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

``--only K2 K3`` times the 2D transfers K2 (``ops/cuda_transfer2.restrict``)
and K3 (``interp_add``), float32, at the batched shapes of the plane-xy
cycle of ``3d_aniso_planexy_128`` (:func:`plane_transfer_shapes`: every
(B, n, n) batch of fine planes its embedded cycles restrict, with the
launches a cycle) and unbatched at 4096² (K2 4096² -> 2048², K3 4096²):
each bit-checked against its plain version, then timed by CUDA events
over back-to-back calls, and by the device time of its kernel under
torch.profiler, warm (back to back) and with the L2 flushed before each
launch (a 256 MB write between the calls, not counted), beside its bound
(bytes at 3.35 TB/s).  Last it sums the flushed device ms of K2 + K3 over
one plane-xy cycle, launches times ms a shape.

With ``--tree DIR`` it times the kernels of another checkout (for example
the parent commit, unpacked with ``git archive``) under the same case
names, and with ``--probe`` also copies of that checkout whose
csrc/fused2.cu is edited to skip parts of K12's tile design (the
`sweep_restrict_fused` of an older source; :data:`PROBES`, one bit a
copy):

    python3 cedar_tpu_torch/tools/tune_fused2.py --tree DIR \
        [--probe 1 4 8 16 32] [--only K12]

``--cycles`` times instead the cycles of the 2D cells (:data:`CELLS`):
the fused 4096² V(1,1) cycle that runs K12, K13 and K1, and the cells
whose cycles run K2 and K3 (the dense 4096² V(1,1), the fused V(2,2),
the 4096² F-cycle, ``2d_fe_9pt_linexy_2048``, ``3d_aniso_planexy_128``),
each the median of 25 CUDA-event-timed cycles as the solve runs them on
the card (replays of the solver's captured iteration);
``--only`` keeps the cells whose names hold one of its words; with
``--tree DIR --pairs N`` it runs N pairs of processes, this checkout and
DIR, alternating which goes first, and prints the medians of both.  Run it as a script path, not ``-m``, so that ``--tree`` wins.
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
        return t3.cycle_pairs(__file__, args.tree, args.pairs,
                              extra=["--only", *args.only] if args.only
                              else [])
    if args.tree and len(args.probe) > 1:
        return t3.run_trees(args, __file__, "fused2", PROBES)
    sys.path.insert(0, args.tree or str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        sys.exit("tune_fused2: no CUDA device")
    from cedar_tpu_torch.ops import cuda_build, cuda_fused2

    cuda_build.load_all(["fused2", "sweep2", "transfer2"])
    if args.build_only:
        return
    t3.print_card()
    print(f"kernels of {cuda_fused2.__file__}", flush=True)
    if args.cycles:
        return cycles(args.only)
    want = (lambda k: not args.only or any(o in k.split() for o in args.only))
    cases = {k: v for k, v in make_cases().items() if want(k)}
    transfers = {k: v for k, v in make_transfer_cases().items() if want(k)}
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
    if transfers:
        run_transfers(transfers, args.reps, not args.unchecked)
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
    so, q, b, kind = problem((4096, 4096), False, 66)
    for updown, norm in (("down", False), ("up", True)):
        a = (so, q, b, kind, updown, norm)
        cases[f"K11 5pt 4096^2 {updown}" + (" +norm" if norm else "")] = (
            lambda lib, a=a: cf.sweep(*a[:5], fuse_norm=a[5]),
            lambda a=a: cf.sweep_plain(*a[:5], fuse_norm=a[5]))
    for k, n in enumerate((4096, *DENSE_LEVELS)):
        nine = n < 4096
        so, q, b, kind = problem((n, n), nine, 70 + k)
        for updown, fuse in (("down", True), ("up", False)):
            a = (so, q, b, kind, updown, fuse)
            pts = "9pt" if nine else "5pt"
            cases[f"K1 {pts} {n}^2 {updown}" + (" +res" if fuse else "")] = (
                lambda p, a=a: (cuda2.sweep(*a) if p is None
                                else cuda2._sweep(p, *a)),
                lambda a=a: cuda2.sweep_plain(*a))
    return cases


def plane_transfer_shapes(n: int = 128) -> dict:
    """``(B, n1, n2)`` -> K2 launches (as many K3) a plane-xy V(1,1) cycle
    of an ``n``³ problem with the default settings: on each non-coarsest
    3D level, 2 plane relaxations of 2 colours, each one embedded V-cycle
    over the colour's planes with a K2 and a K3 on each non-coarsest plane
    level."""
    from cedar_tpu_torch.config import Config
    from cedar_tpu_torch.settings import MLSettings
    from cedar_tpu_torch.solver import solver2, solver3

    s = MLSettings.from_config(Config({"solver": {
        "relaxation": "plane-xy"}}))
    shapes3 = solver3.level_shapes(n, n, n, solver3.compute_num_levels(
        n, n, n, s.min_coarse))
    out = {}
    for nx, ny, nz in shapes3[:-1]:
        for c in (0, 1):
            nb = len(range(c, nz, 2))
            levels2 = solver2.level_shapes(nx, ny, solver2.compute_num_levels(
                nx, ny, s.plane_settings.min_coarse))
            for shape in levels2[:-1]:
                out[(nb, *shape)] = out.get((nb, *shape), 0) + 2
    return out


def make_transfer_cases() -> dict:
    """name -> (kernel, plain, bytes, plane-xy launches): K2 and K3 at the
    plane-xy cycle's batches and unbatched at 4096², float32, 5-point (K3
    updates its q in place, its plain version a copy)."""
    import torch

    from cedar_tpu_torch.ops import cuda_transfer2 as ct
    from cedar_tpu_torch.ops import interp2

    shapes = {**plane_transfer_shapes(), (1, 4096, 4096): 0}
    cases = {}
    for k, ((nb, nx, ny), launches) in enumerate(shapes.items()):
        so, q, b, kind = problem((nx, ny), False, 90 + k, nb)
        ci = interp2.setup_interp(so, kind)
        nxc, nyc = ci.shape[-2] - 1, ci.shape[-1] - 1
        g = torch.Generator(device="cuda").manual_seed(190 + k)
        qc = torch.randn(b.shape[:-2] + (nxc, nyc), generator=g,
                         device="cuda", dtype=torch.float32)
        tag = f"({nb}, {nx}^2)" if nb > 1 else f"{nx}^2"
        cw = 8 * nb * (nxc + 1) * (nyc + 1)
        cases[f"K2 {tag}"] = (
            lambda a=(ci, b): ct.restrict(*a),
            lambda a=(ci, b): ct.restrict_plain(*a),
            (cw + nb * nx * ny + nb * nxc * nyc) * 4, launches)
        cases[f"K3 {tag}"] = (
            lambda a=(ci, so, qc, b, q): ct.interp_add(*a),
            lambda a=(ci, so, qc, b, q): ct.interp_add_plain(
                *a[:4], a[4].clone()),
            (cw + nb * nxc * nyc + 4 * nb * nx * ny) * 4, launches)
    return cases


def run_transfers(cases: dict, reps: int, checked: bool) -> None:
    """Each K2/K3 case bit-checked (the plain version first: K3 updates q),
    then its event ms, warm and L2-flushed device ms and bound;
    then the flushed device ms of K2 + K3 summed over one plane-xy
    cycle."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    total = {"K2": 0.0, "K3": 0.0}
    for name, (kernel, plain, nbytes, launches) in cases.items():
        if checked:
            want = plain()
            t3.check(name, kernel(), want)
        ms = t3.time_ms(kernel, reps)
        warm = t3.device_ms(kernel, reps)
        cold = t3.device_ms(kernel, reps, between=flush.zero_,
                            only=("restrict_kernel", "interp_add_kernel"))
        print(f"{name}: {ms:.5f} ms (device {warm:.5f} ms warm, {cold:.5f} "
              f"ms L2 flushed; bound {nbytes / 3.35e12 * 1e3:.5f} ms; "
              f"{launches} a plane-xy cycle)", flush=True)
        total[name.split()[0]] += launches * cold
    if any(total.values()):
        print(f"plane-xy cycle: K2 {total['K2']:.4f} + K3 {total['K3']:.4f} "
              f"= {sum(total.values()):.4f} device ms (L2 flushed, "
              "launches x ms a shape)", flush=True)


def problem(shape, nine: bool, seed: int, nb: int = 1):
    """A diagonally dominant random float32 2D stencil (chip_smoke.py's
    ``random_problem``) with random q and b on the card; ``nb`` > 1: a
    ``(nb, nx, ny)`` batch of planes (stencil ``(ndir, nb, nx, ny)``)."""
    import torch

    from cedar_tpu_torch.core.types import StencilKind
    from cedar_tpu_torch.ops.stencil2 import offdiag_apply

    dev, dt = "cuda", torch.float32
    g = torch.Generator(device=dev).manual_seed(seed)
    nx, ny = shape
    batch = (nb,) if nb > 1 else ()
    shape = (*batch, nx, ny)

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


#: the 2D cells timed by --cycles: name -> (n, dimension, gallery
#: operator, stencil kind, solver settings, kernels settings)
CELLS = {
    "2d_poisson_4096": (4096, 2, "poisson", "FivePt", {}, {}),
    "2d_poisson_4096-dense": (4096, 2, "poisson", "FivePt", {},
                              {"fine-split": False}),
    "2d_poisson_4096_v22": (4096, 2, "poisson", "FivePt", {"cycle": {
        "nrelax-pre": 2, "nrelax-post": 2}}, {}),
    "2d_poisson_fcycle_4096": (4096, 2, "poisson", "FivePt", {"cycle": {
        "type": "f"}}, {}),
    "2d_fe_9pt_linexy_2048": (2048, 2, "fe", "NinePt", {
        "relaxation": "line-xy"}, {}),
    "3d_aniso_planexy_128": (128, 3, "diag_diffusion3", "SevenPt", {
        "relaxation": "plane-xy"}, {}),
}


def cycles(only=None, ncycles: int = 25) -> None:
    """The median, min and max CUDA-event time of ``ncycles`` cycles of
    each cell of :data:`CELLS` (or those whose names hold a word of
    ``only``), after three warm-up cycles, each as the solve runs it on the
    card (``tune_fused3.solve_iteration``: a replay of the captured
    iteration, with the convergence norm, no readback)."""
    import torch

    import cedar_tpu_torch as ct
    from cedar_tpu_torch.solver import cycle2, cycle3

    dev = torch.device("cuda", 0)
    for name, (n, dim, make, kind, solver, kernels) in CELLS.items():
        if only and not any(o in name for o in only):
            continue
        cyc = solver.get("cycle", {})
        conf = ct.Config({"log": [], "kernels": kernels, "solver": {
            **solver, "cycle": {"nrelax-pre": 1, "nrelax-post": 1, **cyc}}})
        shape = (n,) * dim
        if make == "diag_diffusion3":
            so = ct.gallery.diag_diffusion3(*shape, 1.0, 1.0, 1e-3,
                                            torch.float32, dev)
        else:
            so = getattr(ct.gallery, make)(*shape, torch.float32, dev)
        solver_cls, rhs, mod = ((ct.Solver2, ct.gallery.poisson_rhs, cycle2)
                                if dim == 2 else
                                (ct.Solver3, ct.gallery.poisson3_rhs, cycle3))
        s = solver_cls(so, getattr(ct, kind), conf)
        b = rhs(*shape, torch.float32, dev)
        pre, post = (cyc.get("nrelax-pre", 1), cyc.get("nrelax-post", 1))
        label = ("F" if cyc.get("type") == "f" else "V") + f"({pre},{post})"
        t3.time_cycles(name, t3.solve_iteration(s, b, mod),
                       torch.zeros_like(b), ncycles, label)
        del s, so, b


if __name__ == "__main__":
    main()
