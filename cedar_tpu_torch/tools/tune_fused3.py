"""Time the 3D sweep K6, the fused 3D kernels K14, K15 and K16 and the
27-point edge kernel on the card, whole and by part.

The 7-point K15 (sweep + residual + restriction,
``ops/cuda_fused3.sweep_restrict``, as the cycle calls it: no residual
out) and K16 (interp-add + sweep, ``interp_sweep``, without and with the
norm) run at 256³ float32, the shape of ``3d_poisson_7pt_256``, beside the
7-point K14 (``sweep`` at 256³: the ring design with the colour stages
only, without and with the residual and the norm), and a whole 27-point
K14 sweep at 128³ float32.  Each is first held bit for bit against its
plain version (the norm partials' sum to 1e-5), then timed with CUDA
events.  The 7-point K15 and K16 (the ring design) are timed for each
tile-row option that csrc/fused3.cu builds (``--rows``;
``cuda_fused3.RING_ROWS``) and each probe: builds of csrc/fused3.cu with
``-DCEDAR_FUSED3_PROBE=bits`` that skip the coarse side's copies (K15) or
L2 prefetch (K16) (1), the b and stencil copies (2), the colour phases (4)
or the barriers (8), whose outputs are wrong and whose times split a call
among its parts.  The 27-point K14 is timed with each build of ``--stages
M`` (its colours a march, ``-DCEDAR_K14_STAGES=M``, bit-checked too) and
each probe (8 the barriers, 16 the K14 stencil gathers, 32 its colour
stages); the 7-point K14 with each build of ``--rows14 T`` (its float32
tile rows, ``-DCEDAR_K14_ROWS=T``, bit-checked too) and each probe.

The 27-point K15 and K16 (K6's sweep with the edge kernel) run at 128³,
64³, 32³ and 16³ in float32 and float64 (:data:`EDGE_LEVELS`), beside the
dense sequences that compute the same functions (``D15``: K6 DOWN with the
residual, then K7; ``D16``: the residual launch, K8, then K6 UP), the
27-point K14 with the norm at 128³ float32, the edge kernel alone in each
mode (``E27``; with each build of ``--edge-probe bits``,
``-DCEDAR_EDGE3_PROBE``: 1 the stencil copies, 2 the residual, 4 the
restriction or the interpolation's coarse side, 8 the barriers skipped,
and of ``--edge-threads N``, ``-DCEDAR_EDGE3_THREADS``), and K6's 27-point
residual launch by each kernel (``R27``: the edge kernel's mode res, the
residual kernel of csrc/sweep3.cu), with CUDA-event times and the device
time of their kernels under torch.profiler.  K6 (``ops/cuda3.sweep``:
DOWN with the residual, UP without, as the dense levels run it) runs at
every level shape of the 3D paths and on both sides of its regimes' edges
(:data:`K6_LEVELS`) on its plan and forced onto each other regime
(``cuda3.Plan``: ``phases``, and K14's ``pass27`` or ``ring``), timed the
same way.  ``--only`` keeps the cases whose names hold one of its words
(``K6``, ``K14``, ``7pt``, ``E27``, ...).  It prints the card's name and
power limit first.

Run from the repository root on a machine with a CUDA device:

    python3 cedar_tpu_torch/tools/tune_fused3.py [--rows 12 10] \
        [--probe 1 2 4 8] [--stages 1 4] [--rows14 12] [--only E27] \
        [--edge-probe 1 2 4 8] [--edge-threads 256 1024]

With ``--tree DIR`` it times the kernels of another checkout of the
repository (for example the parent commit, unpacked with ``git archive``)
under the same case names, so that two designs compare in one call (an
older checkout without the edge kernel skips its cases).

``--cycles`` times instead the V(1,1) cycles that run these kernels,
``3d_poisson_7pt_256`` and ``3d_fe_27pt_128``, fused and dense
(:data:`CELLS`), as the solve runs them (the median of 25
CUDA-event-timed replays of the solver's captured iteration); with
``--tree`` those of the other checkout.
``--cycles --pairs N`` runs N processes, alternating whether the fused or
the dense cells go first, and counts the pairs in which each cell's fused
cycle is at or below its dense one; with ``--tree DIR`` N pairs of
processes, this checkout and DIR, alternating which runs first, with the
median of each side's medians too.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from pathlib import Path

#: the 27-point levels at which K15, K16 and the edge kernel are timed:
#: (n, itemsize)
EDGE_LEVELS = [(n, i) for i in (4, 8) for n in (128, 64, 32, 16)]
#: what a probe copy (:func:`probe_tree`) puts at the top of its source's
#: anonymous namespace, for edits that replace a call by ``probe_init``
_HELPER = ("namespace {\n\n"
           "template <class F>\n"
           "__device__ auto probe_init(const F& f) { return f(); }\n")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[0],
                    help="7-point tile rows (0: the plan's own)")
    ap.add_argument("--probe", type=int, nargs="+", default=[0],
                    help="probe bits: 1 coarse side, 2 b and stencil "
                         "copies, 4 colour phases, 8 barriers skipped; "
                         "27-point K14: 16 stencil gathers, 32 colour "
                         "stages")
    ap.add_argument("--stages", type=int, nargs="+", default=[],
                    help="27-point K14 colours a march to build and time "
                         "beside the default (-DCEDAR_K14_STAGES=M)")
    ap.add_argument("--rows14", type=int, nargs="+", default=[],
                    help="7-point K14 float32 tile rows to build and time "
                         "beside the default (-DCEDAR_K14_ROWS=T)")
    ap.add_argument("--edge-probe", type=int, nargs="+", default=[],
                    help="edge kernel probe bits: 1 stencil copies, 2 the "
                         "residual, 4 the restriction or the coarse side, "
                         "8 barriers skipped (-DCEDAR_EDGE3_PROBE)")
    ap.add_argument("--edge-threads", type=int, nargs="+", default=[],
                    help="edge kernel threads a block to build and time "
                         "beside the default (-DCEDAR_EDGE3_THREADS)")
    ap.add_argument("--tree", help="time this checkout's kernels instead")
    ap.add_argument("--build-only", action="store_true",
                    help="build the kernels and stop")
    ap.add_argument("--unchecked", action="store_true",
                    help="skip the bit checks (a --tree probe copy)")
    ap.add_argument("--cycles", action="store_true",
                    help="time the cells' fused cycles instead")
    ap.add_argument("--pairs", type=int, default=0,
                    help="--cycles: pairs of runs, alternating")
    ap.add_argument("--order", choices=("fused", "dense"), default="fused",
                    help="--cycles: which of a cell's cycles goes first")
    ap.add_argument("--only", nargs="+",
                    help="time only the cases whose names hold one of these")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    args.probe = sorted({0, *args.probe})
    if args.cycles and args.pairs:
        return cycle_pairs(__file__, args.tree, args.pairs, orders=True)
    sys.path.insert(0, args.tree or str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        sys.exit("tune_fused3: no CUDA device")
    from cedar_tpu_torch.ops import cuda_build, cuda_fused3

    edge = hasattr(cuda_fused3, "edge")
    cuda_build.load_all(["fused3", "sweep3", "transfer3"]
                        + (["edge3"] if edge else []))
    if args.build_only:
        return
    print_card()
    print(f"kernels of {cuda_fused3.__file__}", flush=True)
    if args.cycles:
        return cycles(args.order)
    tunable = hasattr(cuda_fused3, "_sweep_restrict")
    want = (lambda k: not args.only or any(o in k for o in args.only))
    cases = {k: v for k, v in make_cases(tunable).items() if want(k)}
    if not args.only or any(o.startswith("K6") for o in args.only):
        cases |= {k: v for k, v in make_k6_cases().items() if want(k)}
    if not tunable:
        run(cases, [0], {0: None}, args.reps, f"{args.tree} default build",
            not args.unchecked)
        return
    new = {k: v for k, v in make_edge_cases(edge).items() if want(k)}
    eprobes = {f"probe={b}": (f"CEDAR_EDGE3_PROBE={b}",)
               for b in args.edge_probe}
    eprobes |= {f"threads={t}": (f"CEDAR_EDGE3_THREADS={t}",)
                for t in args.edge_threads}
    if edge and eprobes:
        cuda_build.build_variants("edge3", list(eprobes.values()))
    elibs = {k: cuda_build.load_variant("edge3", d)
             for k, d in eprobes.items()} if edge else {}
    run_new(new, args.reps, elibs, not args.unchecked)
    probes = {b: (f"CEDAR_FUSED3_PROBE={b}",) for b in args.probe if b}
    stages = {m: (f"CEDAR_K14_STAGES={m}",) for m in args.stages}
    rows14 = {t: (f"CEDAR_K14_ROWS={t}",) for t in args.rows14}
    cuda_build.build_variants("fused3", [*probes.values(), *stages.values(),
                                         *rows14.values()])
    for key, (secs, log) in cuda_build.build_log.items():
        print(f"ptxas {key} ({secs:.0f} s): " + "; ".join(
            r for r in ring_report(log) if r.startswith("f ")), flush=True)
    libs = {b: cuda_build.load_variant("fused3", probes[b]) if b
            else cuda_build.load("fused3") for b in args.probe}
    libs27 = {"plan": libs[0]} | {
        f"stages={m}": cuda_build.load_variant("fused3", d)
        for m, d in stages.items()} | {
        f"probe={b}": lib for b, lib in libs.items() if b}
    libs14 = {"plan": libs[0]} | {
        f"rows14={t}": cuda_build.load_variant("fused3", d)
        for t, d in rows14.items()} | {
        f"probe={b}": lib for b, lib in libs.items() if b}
    run(cases, args.rows, libs, args.reps, "this checkout",
        not args.unchecked, libs27, libs14)


def run_trees(args, script: str, source: str, probes: dict) -> None:
    """--tree with --probe (tools/tune_fused2.py): the checkout and its
    probe copies (of csrc/<source>.cu, edited by ``probes``), built in
    parallel, then timed one after another by ``script``."""
    trees = {b: probe_tree(args.tree, b, source, probes) if b else args.tree
             for b in args.probe}
    me = os.path.abspath(script)
    jobs = [subprocess.Popen([sys.executable, me, "--tree", t,
                              "--build-only"]) for t in trees.values()]
    if any([j.wait() for j in jobs]):
        sys.exit(f"{Path(me).stem}: a build failed")
    only = ["--only", *args.only] if args.only else []
    for b, t in trees.items():
        print(f"[probe={b}]", flush=True)
        subprocess.run([sys.executable, me, "--tree", t, "--reps",
                        str(args.reps), *only]
                       + (["--unchecked"] if b else []), check=True)


def probe_tree(tree: str, bits: int, source: str, probes: dict) -> str:
    """A copy of ``tree``'s package under ``tree``/_archive/probe<bits>
    whose csrc/<source>.cu skips the parts of ``bits`` (``probes``: bit ->
    edits (old, new, times))."""
    dst = os.path.join(tree, "_archive", f"{source}-probe{bits}")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "cedar_tpu_torch"),
                    os.path.join(dst, "cedar_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(dst, "cedar_tpu_torch", "csrc", f"{source}.cu")
    with open(path) as f:
        src = f.read()
    assert src.count("namespace {\n\n") == 1
    src = src.replace("namespace {\n\n", _HELPER)
    for bit, edits in probes.items():
        for old, new, n in edits if bits & bit else ():
            if src.count(old) != n:
                raise ValueError(f"probe {bit}: {old!r} occurs "
                                 f"{src.count(old)} times, not {n}")
            src = src.replace(old, new)
    with open(path, "w") as f:
        f.write(src)
    return dst


#: the cells whose cycles run K6 and K14-K16: (n, gallery operator,
#: stencil kind, the fused cycle)
CELLS = {"3d_poisson_7pt_256": (256, "poisson3", "SevenPt", True),
         "3d_fe_27pt_128": (128, "fe3", "TwentySevenPt", True),
         "3d_poisson_7pt_256-dense": (256, "poisson3", "SevenPt", False),
         "3d_fe_27pt_128-dense": (128, "fe3", "TwentySevenPt", False)}


def cycles(order: str = "fused", ncycles: int = 25) -> None:
    """The median, min and max CUDA-event time of ``ncycles`` V(1,1)
    cycles of each cell, after three warm-up cycles, each cycle as the
    solve runs it on the card (a replay of the solver's captured
    iteration, with the convergence norm, no readback; in a checkout from
    before the captured solve, the eager iteration); each configuration's
    fused and dense cells one after the other, ``order`` first."""
    import torch

    import cedar_tpu_torch as ct
    from cedar_tpu_torch.solver import cycle3

    dev = torch.device("cuda", 0)
    names = sorted(CELLS, key=lambda c: (c.replace("-dense", ""),
                                         CELLS[c][3] != (order == "fused")))
    for name in names:
        n, make, kind, fused = CELLS[name]
        conf = ct.Config({"log": [], "kernels": {"fine-split": fused},
                          "solver": {"cycle": {
                              "nrelax-pre": 1, "nrelax-post": 1}}})
        s = ct.Solver3(getattr(ct.gallery, make)(n, n, n, torch.float32,
                                                 dev),
                       getattr(ct, kind), conf)
        b = ct.gallery.poisson3_rhs(n, n, n, torch.float32, dev)
        time_cycles(name, solve_iteration(s, b, cycle3), torch.zeros_like(b),
                    ncycles)
        del s, b


def solve_iteration(s, b, cycle):
    """One iteration of the solver ``s``'s solve on the card (``x`` ->
    ``x``): a replay of its captured iteration (cycle and norm) over its
    static buffers, ``b`` copied in; in a checkout from before the
    captured solve, ``cycle.cycle_residual`` eagerly."""
    if not hasattr(s, "graphs"):
        return lambda x: cycle.cycle_residual(s.levels, s.kinds, x, b,
                                              s.settings)[0]
    g = s.graphs.graph("solve", b)
    g.b.copy_(b)

    def one(x):
        g.replay()
        return x

    return one


def time_cycles(name: str, one, x, ncycles: int,
                label: str = "V(1,1)") -> None:
    """Prints the median, min and max CUDA-event ms of ``ncycles`` calls of
    ``one`` (x -> x), after three warm-up calls; ``label`` names the
    cycle."""
    import statistics

    import torch

    for _ in range(3):
        x = one(x)
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(ncycles)]
    torch.cuda.synchronize()
    for e0, e1 in ev:
        e0.record()
        x = one(x)
        e1.record()
    torch.cuda.synchronize()
    ms = sorted(e0.elapsed_time(e1) for e0, e1 in ev)
    print(f"{name} {label} cycle ms: median "
          f"{statistics.median(ms):.4f}, min {ms[0]:.4f}, "
          f"max {ms[-1]:.4f}", flush=True)


def cycle_pairs(script: str, tree: str | None, pairs: int,
                orders: bool = False, extra=()) -> None:
    """``pairs`` pairs of ``script --cycles`` processes, this checkout's
    and ``tree``'s, alternating which runs first (hosts differ between
    runs), or without ``tree`` ``pairs`` processes of this checkout;
    ``orders``: alternating too whether a configuration's fused or dense
    cell goes first (``--order``).  Then, per cell, the median of each
    side's medians and how often this checkout was faster; per side and
    configuration, in how many pairs the fused cycle was at or below the
    dense one."""
    import re
    import statistics

    me = os.path.abspath(script)
    runs = {"this": [], "tree": []}
    for k in range(pairs):
        sides = ("this",) if tree is None else (
            ("this", "tree") if k % 2 == 0 else ("tree", "this"))
        for side in sides:
            cmd = [sys.executable, me, "--cycles", *extra] + (
                ["--tree", tree] if side == "tree" else []) + (
                ["--order", ("fused", "dense")[k % 2]] if orders else [])
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 check=True).stdout
            print(f"[pair {k} {side}]\n{out}", end="", flush=True)
            runs[side].append(dict(re.findall(
                r"(\S+) [VF]\(\d,\d\) cycle ms: median ([\d.]+)", out)))
    for side in ("this", "tree"):
        for cell in runs[side][0] if runs[side] else ():
            if cell + "-dense" not in runs[side][0]:
                continue
            f = [float(r[cell]) for r in runs[side]]
            d = [float(r[cell + "-dense"]) for r in runs[side]]
            wins = sum(a <= b for a, b in zip(f, d))
            print(f"{side} {cell}: fused median of medians "
                  f"{statistics.median(f):.4f} against dense "
                  f"{statistics.median(d):.4f}; fused at or below dense in "
                  f"{wins} of {len(f)} pairs", flush=True)
    if tree is None:
        return
    for cell in runs["this"][0]:
        mine = [float(r[cell]) for r in runs["this"]]
        theirs = [float(r[cell]) for r in runs["tree"]]
        wins = sum(a < b for a, b in zip(mine, theirs))
        print(f"{cell}: median of medians {statistics.median(mine):.4f} "
              f"(this) against {statistics.median(theirs):.4f} ({tree}); "
              f"this faster in {wins} of {pairs} pairs", flush=True)


def print_card() -> None:
    """The card's name and power limit, as nvidia-smi gives them."""
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(),
        flush=True)


def ring_report(log: str):
    """'f ring3<0,1,12>: 96 regs, 0 spill' for each kernel of the ring
    designs (ring3: 7-point K14-K16, interp, epilogue, tile rows; pass27:
    the 27-point K14; ring2: K13, nine, epilogue) and of K6's resident
    regime (sweep_resident: 27-point) in nvcc's ptxas report ``log``."""
    import re

    name = spill = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(ring3|pass27|ring2"
                      r"|sweep_resident|edge3)"
                      r"I([fd])((?:L[bi]\d+E)*)", line)
        if m:
            kern, t, rest = m.groups()
            args = ",".join(re.findall(r"L[bi](\d+)E", rest))
            name = f"{t} {kern}<{args}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if name and m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if name and m:
            yield f"{name}: {m.group(1)} regs, {spill} spill"
            name = None


#: K6's shapes: every level of the 3D paths (256³ 7-point and its 27-point
#: levels, 128³ 27-point's, float32; Cedar's 200³ float64 test's), and
#: shapes between them on both sides of each regime's edge: (n, 27-point,
#: itemsize)
K6_LEVELS = ([(n, False, 4) for n in (256, 200, 128, 64, 16)]
             + [(n, True, 4) for n in (128, 96, 64, 32, 16, 14, 12, 8)]
             + [(n, False, 8) for n in (200, 64)]
             + [(n, True, 8) for n in (128, 100, 64, 50, 25, 13, 12, 7)])


def make_k6_cases() -> dict:
    """name -> (kernel(plan or None, q), plain(q), q, opts): K6 DOWN with
    the residual and UP without at :data:`K6_LEVELS`; ``plan`` forces this
    checkout's regime (``cuda3.Plan``), ``opts`` the regimes to force there
    (an older checkout's K6 updates q in place, so the check gives it a
    copy)."""
    import torch

    from cedar_tpu_torch.ops import cuda3

    cases = {}
    for n, ts, itemsize in K6_LEVELS:
        dt = torch.float32 if itemsize == 4 else torch.float64
        so, q, b, kind = problem((n,) * 3, ts, 50 + n, dt)
        opts = {"plan": None}
        if hasattr(cuda3, "_sweep"):
            mine = cuda3.plan(itemsize, ts, (n,) * 3).route
            forced = {"phases": cuda3.Plan("phases"),
                      "K14": cuda3.Plan("pass27" if ts else "ring")}
            opts |= {k: p for k, p in forced.items() if p.route != mine}
        tag = f"{'27pt' if ts else '7pt'} {n}^3 f{8 * itemsize}"
        for updown, fuse in (("down", True), ("up", False)):
            a = (b, kind, updown, fuse)
            cases[f"K6 {tag} {updown}" + (" +res" if fuse else "")] = (
                lambda p, q, so=so, a=a: (
                    cuda3.sweep(so, q, *a) if p is None
                    else cuda3._sweep(p, so, q, *a)),
                lambda q, so=so, a=a: cuda3.sweep_plain(so, q, *a),
                q, opts)
    return cases


def make_cases(tunable: bool) -> dict:
    """name -> (kernel(lib, ty), plain()): the 7-point K14-K16 at 256³ and
    a whole 27-point K14 sweep at 128³, float32; an older checkout's kernel
    takes its own library and plan (``tunable`` false); K14 takes the tile
    rows of its library."""
    import torch

    from cedar_tpu_torch.ops import cuda_fused3 as cf
    from cedar_tpu_torch.ops import interp3

    def k15(lib, ty, *a):
        return (cf._sweep_restrict(lib, ty, *a) if tunable
                else cf.sweep_restrict(*a))

    def k16(lib, ty, *a):
        return (cf._interp_sweep(lib, ty, *a) if tunable
                else cf.interp_sweep(*a))

    def k14(lib, ty, *a):
        # a whole sweep: K14 launches only
        return cf._sweep(lib, *a) if hasattr(cf, "_sweep") else cf.sweep(*a)

    cases = {}
    for n, ts in ((256, False), (128, True)):
        so, q, b, kind = problem((n,) * 3, ts, 30 + ts)
        pts = "27pt" if ts else "7pt"
        if ts:
            # a whole sweep (the 27-point K15 and K16: make_edge_cases)
            a14 = (so, q, b, kind, "down", False, (0, 0, 0), False)
            cases[f"K14 {pts} {n}^3"] = (
                lambda lib, ty, a=a14: k14(lib, ty, *a),
                lambda a=a14: cf.sweep_plain(*a))
            continue
        ci = interp3.setup_interp(so, kind)
        g = torch.Generator(device="cuda").manual_seed(40 + ts)
        qc = torch.randn(tuple(m - 1 for m in ci.shape[1:]), generator=g,
                         device="cuda", dtype=torch.float32)
        # without and with the residual and the norm (the cycle's K14: an
        # extra sweep, the last one)
        for res, norm in ((False, False), (True, False), (False, True)):
            a14 = (so, q, b, kind, "down", res, (0, 0, 0), norm)
            cases[f"K14 {pts} {n}^3" + (" +res" if res else "")
                  + (" +norm" if norm else "")] = (
                lambda lib, ty, a=a14: k14(lib, ty, *a),
                lambda a=a14: cf.sweep_plain(*a))
        a15 = (so, q, b, ci, kind, "down", False)
        cases[f"K15 {pts} {n}^3"] = (
            lambda lib, ty, a=a15: k15(lib, ty, *a),
            lambda a=a15: cf.sweep_restrict_plain(*a))
        for norm in (False, True):
            a16 = (ci, qc, so, b, q, kind, "up", False, norm)
            cases[f"K16 {pts} {n}^3" + (" +norm" if norm else "")] = (
                lambda lib, ty, a=a16: k16(lib, ty, *a),
                lambda a=a16: cf.interp_sweep_plain(*a))
    return cases


def make_edge_cases(edge: bool) -> dict:
    """name -> (kernel(lib, timed), plain()) at :data:`EDGE_LEVELS`
    (27-point): K15 (DOWN, no residual out) and K16 (UP) as the cycle calls
    them, and the dense sequences that compute the same functions (``D15``:
    K6 DOWN with the residual, then K7; ``D16``: the residual launch, K8
    (in place: on a copy of q when checked, on a buffer that drifts when
    ``timed``), then K6 UP); the 27-point K14 with the norm at 128³
    float32; with the edge kernel (``edge``: not in an older checkout) the
    edge kernel alone in each mode (``E27``, on the build ``lib``: None the
    default one) and K6's 27-point residual launch by each kernel
    (``R27``)."""
    import torch

    from cedar_tpu_torch.ops import (
        cuda3, cuda_build, cuda_transfer3, interp3, stencil3,
    )
    from cedar_tpu_torch.ops import cuda_fused3 as cf

    cases = {}
    for n, itemsize in EDGE_LEVELS:
        dt = torch.float32 if itemsize == 4 else torch.float64
        so, q, b, kind = problem((n,) * 3, True, 60 + n + itemsize, dt)
        ci = interp3.setup_interp(so, kind)
        g = torch.Generator(device="cuda").manual_seed(70 + n)
        qc = torch.randn(tuple(m - 1 for m in ci.shape[1:]), generator=g,
                         device="cuda", dtype=dt)
        code = cuda_build.check_operands(so, q, b)
        qd = q.clone()
        tag = f"27pt {n}^3 f{8 * itemsize}"
        a15 = (so, q, b, ci, kind, "down", False)
        cases[f"K15 {tag}"] = (lambda lib, t, a=a15: cf.sweep_restrict(*a),
                               lambda a=a15: cf.sweep_restrict_plain(*a))
        a16 = (ci, qc, so, b, q, kind, "up")
        cases[f"K16 {tag}"] = (lambda lib, t, a=a16: cf.interp_sweep(*a),
                               lambda a=a16: cf.interp_sweep_plain(*a))

        def d15(lib, t, so=so, q=q, b=b, ci=ci, kind=kind):
            qn, res = cuda3.sweep(so, q, b, kind, "down", True)
            return qn, None, cuda_transfer3.restrict(ci, res)

        # the residual launch that K6 runs at this shape (an older
        # checkout: its own)
        edge_res = (hasattr(cuda3, "EDGE_RESIDUAL")
                    and cuda3.plan(itemsize, True, (n,) * 3).route
                    in cuda3.EDGE_RESIDUAL)

        def d16(lib, t, so=so, q=q, b=b, ci=ci, qc=qc, kind=kind, qd=qd,
                code=code, edge_res=edge_res):
            res = (cuda3._residual(code, so, q, b, kind, True) if edge_res
                   else cuda3._residual(code, so, q, b, kind))
            mid = cuda_transfer3.interp_add(ci, so, qc, res,
                                            qd if t else q.clone())
            return cuda3.sweep(so, mid, b, kind, "up")

        cases[f"D15 {tag}"] = (d15, lambda a=a15: cf.sweep_restrict_plain(*a))
        cases[f"D16 {tag}"] = (d16, lambda a=a16: cf.interp_sweep_plain(*a))
        if n == 128 and itemsize == 4:
            a14 = (so, q, b, kind, "up", False, (0, 0, 0), True)
            cases[f"K14 {tag} +norm"] = (
                lambda lib, t, a=a14: cf.sweep(*a),
                lambda a=a14: cf.sweep_plain(*a))
        if not edge:
            continue
        for mode in cf.EDGE_MODES:
            cases[f"E27 {mode} {tag}"] = (
                lambda lib, t, m=cf.EDGE_MODES[mode], so=so, q=q, b=b, ci=ci,
                qc=qc, code=code: cf.launch_edge(code, m, so, q, b, ci, qc,
                                                 lib=lib),
                lambda mode=mode, so=so, q=q, b=b, ci=ci, qc=qc:
                    cf.edge_plain(so, q, b, mode, ci, qc))
        for kernel in ("edge", "sweep3"):
            def r27(lib, t, kernel=kernel, so=so, q=q, b=b, kind=kind,
                    code=code):
                return cuda3._residual(code, so, q, b, kind,
                                       kernel == "edge")

            cases[f"R27 {kernel} {tag}"] = (
                r27, lambda so=so, q=q, b=b, kind=kind:
                    stencil3.residual(so, q, b, kind))
    return cases


def run_new(cases: dict, reps: int, elibs: dict, checked: bool) -> None:
    """The cases of :func:`make_edge_cases`, each held to its plain version
    (unless not ``checked``), then timed: CUDA-event ms a call and the
    device ms of its kernels; the edge kernel's (``E27``) also on each
    build of ``elibs`` (label -> library: probes unchecked, other threads
    checked)."""
    for name, (kernel, plain) in cases.items():
        if checked:
            check_new(name, kernel(None, False), plain())
        builds = {"plan": None}
        if name.startswith("E27"):
            builds |= elibs
        for label, lib in builds.items():
            if checked and label.startswith("threads="):
                check_new(f"{name} {label}", kernel(lib, False), plain())
            ms = time_ms(lambda: kernel(lib, True), reps)
            dms = device_ms(lambda: kernel(lib, True), reps)
            print(f"{name} {label}: {ms:.4f} ms (device {dms:.4f} ms)",
                  flush=True)


def check_new(what: str, got, want) -> None:
    """Outputs bit-equal; a norm's partials (``norm`` in ``what``: the
    outputs of different sizes) summing to within 1e-5 (float32) or 1e-12
    of the plain version's."""
    import torch

    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        if "norm" in what and g.numel() != w.numel():
            n, r = float(g.sum()), float(w.sum())
            tol = 1e-5 if g.dtype == torch.float32 else 1e-12
            if not abs(n - r) <= tol * r:
                raise AssertionError(f"{what}: norm {n} against {r}")
        elif not torch.equal(g, w):
            raise AssertionError(f"{what}: output {k} differs from the "
                                 "plain version")
    print(f"{what}: equal to the plain version", flush=True)


def run(cases: dict, rows_opts, libs: dict, reps: int, what: str,
        checked: bool = True, libs27=None, libs14=None) -> None:
    """Each case bit-checked with the probe-0 library (unless not
    ``checked``), then timed; the 7-point ones over the tile rows and the
    probes' libraries (the 7-point K14 over ``libs14``: label -> library,
    its builds of other tile rows bit-checked too), the 27-point ones over
    the colours a K14 march of ``libs27`` (label -> library; each
    bit-checked too)."""
    from cedar_tpu_torch.ops import cuda_fused3

    print(f"[{what}]", flush=True)
    for name, case in cases.items():
        if name.startswith("K6 "):
            run_k6(name, *case, reps, checked)
            continue
        kernel, plain = case
        if checked:
            check(name, kernel(libs[0], None), plain())
        if name.startswith("K14 7pt") and libs14:
            for label, lib in libs14.items():
                if checked and label.startswith("rows14="):
                    check(f"{name} {label}", kernel(lib, None), plain())
                ms = time_ms(lambda: kernel(lib, None), reps)
                dms = device_ms(lambda: kernel(lib, None), reps)
                print(f"{name} {label}: {ms:.4f} ms (device {dms:.4f} ms)",
                      flush=True)
            continue
        ring = name.split()[1] == "7pt"
        if not ring and libs27:
            for label, lib in libs27.items():
                if checked and label.startswith("stages="):
                    check(f"{name} {label}", kernel(lib, None), plain())
                ms = time_ms(lambda: kernel(lib, None), reps)
                print(f"{name} {label}: {ms:.4f} ms", flush=True)
            continue
        for rows in rows_opts if ring else [0]:
            if rows and rows not in cuda_fused3.RING_ROWS[4]:
                continue
            if rows and not fits(name, rows):
                print(f"{name} rows={rows}: does not fit a block")
                continue
            for probe, lib in libs.items() if ring else [(0, libs[0])]:
                ms = time_ms(lambda: kernel(lib, rows or None), reps)
                print(f"{name} rows={rows or 'plan'} probe={probe}: "
                      f"{ms:.4f} ms", flush=True)


def run_k6(name: str, kernel, plain, q, opts: dict, reps: int,
           checked: bool) -> None:
    """A K6 case on its plan and forced onto each regime of ``opts``; an
    older checkout's K6 on its own launches.  Timed on q itself (an older
    K6 sweeps it in place, again and again)."""
    for label, opt in opts.items():
        if checked:
            check(f"{name} {label}", kernel(opt, q.clone()),
                  plain(q.clone()))
        ms = time_ms(lambda: kernel(opt, q), reps)
        dms = device_ms(lambda: kernel(opt, q), reps)
        print(f"{name} {label}: {ms:.4f} ms (device {dms:.4f} ms)",
              flush=True)


def device_ms(fn, reps: int = 20, between=None, only=()) -> float:
    """The device time of the kernels that ``fn`` launches, ms a call: the
    sum over ``reps`` calls under torch.profiler.  Beside the CUDA-event
    time of back-to-back calls, which a wrapper's host time bounds at the
    small levels.  ``between``: called before each call (an L2 flush), its
    kernels not counted when ``only`` names the kernels to count (parts of
    their names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if between is not None:
                between()
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if only and not any(o in evt.key for o in only):
            continue
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            # the attribute's name changed across PyTorch releases
            us += next((float(getattr(evt, k)) for k in (
                "self_device_time_total", "self_cuda_time_total")
                if hasattr(evt, k)), 0.0)
    return us / 1e3 / reps


def fits(name: str, rows: int) -> bool:
    """Whether 7-point case ``name`` with ``rows`` tile rows fits a
    block's shared memory (float32)."""
    from cedar_tpu_torch.ops import cuda_fused3 as cf

    interp = name.startswith("K16")
    mode = ((cf._NORM if "+norm" in name else cf._NONE) if interp
            else cf._RESTRICT)
    return cf.ring_words(4, interp, mode, rows) * 4 <= cf.BLOCK_SMEM


def problem(shape, ts: bool, seed: int, dt=None):
    """A diagonally dominant random 3D stencil of dtype ``dt`` (default
    float32; chip_smoke.py's ``random_problem3``) with random q and b on
    the card."""
    import torch

    from cedar_tpu_torch.core.types import Dir3, StencilKind
    from cedar_tpu_torch.ops import stencil3

    dev, dt = "cuda", dt or torch.float32
    g = torch.Generator(device=dev).manual_seed(seed)
    nx, ny, nz = shape

    def u(lo, hi, *s):
        return lo + (hi - lo) * torch.rand(s, generator=g, device=dev,
                                           dtype=dt)

    kind = StencilKind.twenty_seven_pt if ts else StencilKind.seven_pt
    so = torch.zeros((kind.ndirs, nx, ny, nz), dtype=dt, device=dev)
    so[Dir3.PW, 1:] = u(0.5, 1.5, nx - 1, ny, nz)
    so[Dir3.PS, :, 1:] = u(0.5, 1.5, nx, ny - 1, nz)
    so[Dir3.B, :, :, 1:] = u(0.5, 1.5, nx, ny, nz - 1)
    if ts:
        for d in (Dir3.PSW, Dir3.PNW):
            so[d, 1:, 1:] = u(0.1, 0.4, nx - 1, ny - 1, nz)
        for d in (Dir3.BW, Dir3.BE):
            so[d, 1:, :, 1:] = u(0.1, 0.4, nx - 1, ny, nz - 1)
        for d in (Dir3.BS, Dir3.BN):
            so[d, :, 1:, 1:] = u(0.1, 0.4, nx, ny - 1, nz - 1)
        for d in (Dir3.BSW, Dir3.BNW, Dir3.BNE, Dir3.BSE):
            so[d, 1:, 1:, 1:] = u(0.05, 0.2, nx - 1, ny - 1, nz - 1)
    so[Dir3.P] = stencil3.offdiag_apply(
        so, torch.ones(shape, dtype=dt, device=dev), kind) + u(
            0.05, 0.2, nx, ny, nz)
    q = torch.randn(shape, generator=g, device=dev, dtype=dt)
    b = torch.randn(shape, generator=g, device=dev, dtype=dt)
    return so, q, b, kind


def check(what: str, got, want) -> None:
    """Outputs bit-equal, a norm's partials summing to within 1e-5."""
    import torch

    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for k, (g, w) in enumerate(zip(got, want)):
        if g is None and w is None:
            continue
        if "+norm" in what and k == 1:
            n, r = float(g.sum()), float(w.sum())
            if not abs(n - r) <= 1e-5 * r:
                raise AssertionError(f"{what}: norm {n} against {r}")
        elif not torch.equal(g, w):
            raise AssertionError(f"{what}: output {k} differs from the "
                                 "plain version")
    print(f"{what}: equal to the plain version", flush=True)


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    import torch

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


if __name__ == "__main__":
    main()
