"""Where the time of one 2D or 3D cycle goes on the card.

Builds one of eighteen float32 configurations — ``vcycle`` (default: Poisson
4096², V(1,1), the fused fine-level cycle that the solver runs on the card
by default), ``vcycle-dense`` (the same with ``kernels.fine-split`` false:
the dense cycle), ``linexy`` (9-point ``gallery.fe`` 2048², line-xy V(1,1)),
``fcycle`` (Poisson 4096², F-cycle), ``vcycle3`` (7-point Poisson 256³,
V(1,1), fused on the top four levels, ``kernels.fine-split`` true:
``3d_poisson_7pt_256``), ``vcycle3-dense`` (the same, dense), ``fe27``
(27-point ``gallery.fe3`` 128³, V(1,1), fused: ``3d_fe_27pt_128``),
``fe27-dense`` (the same, dense), ``fcycle3`` (7-point Poisson 256³,
F-cycle) or ``planexy`` (7-point ``diag_diffusion3(1, 1, 1e-3)`` 128³,
plane-xy V(1,1) with the
default plane-config: ``3d_aniso_planexy_128``) or ``vcycle-periodic``
(Poisson 4096² periodic in x, V(1,1): the dense cycle with K1-K3 in their
periodic modes) or ``vcycle3-periodic`` (7-point Poisson 256³ periodic in
x, V(1,1): the dense cycle with K6-K8 in their periodic modes), or the
configurations of the inner multigrid coarse solve and of the
plane-configs beyond line-xy V-cycles: ``planexy-point``,
``planexy-linex``, ``planexy-fcycle`` (``3d_aniso_planexy_128`` with one
embedded point V(2,1), line-x V(2,1) or line-xy F-cycle a colour: the
batched K1, K4 (K10's one-direction mode) and K5), ``planexy-cedar``
(line-xy with ``cg-solver: cedar``, plane min-coarse 16, the inner solve
of 10 steps), ``vcycle-cedar`` (Poisson 4096², V(1,1), ``num-levels: 3``,
``cg-solver: cedar`` with a cg-config of tol 1e-4 and 10 steps) and
``vcycle3-cedar`` (7-point Poisson 256³, the same) — runs a few warm-up
cycles, then traces ten cycles with ``torch.profiler``, twice: eagerly
(``[eager]``, each iteration as the CPU's solve loop runs it, one launch
at a time) and as replays of the solver's captured CUDA graph
(``[graph]``, as its ``solve`` runs on the card), and prints for each:

* wall ms per cycle (CUDA events, without and under the profiler) and
  the device's busy and idle share (summed kernel time over the wall
  time under the profiler);
* device time per kernel name, per cycle;
* device time and launches of the 2D transfers K2 and K3 per cycle
  (csrc/transfer2.cu ``restrict_kernel``, ``interp_add_kernel``; the 3D
  kernels of those names, with six int parameters, not counted);
* host time per profiler scope ("relaxation", "restrict", …), per cycle
  (with plane relaxation the embedded 2D cycles' scopes run inside the
  outer "relaxation" and count in both; a replay runs no scope).

With an inner coarse solve it then traces the solve alone (the outer
coarsest level's, or the first plane hierarchy's: a batch of planes) as
replays of a graph of its own (``[inner graph]``, ms per solve), and
prints how many of its steps were active in one eager cycle.

Where the profiler reports no device time for the replays, it says so
and gives their CUDA-event wall time alone.

Run from the repository root on a machine with a CUDA device:

    python3 -m cedar_tpu_torch.tools.profile_cycle \
        [vcycle|vcycle-dense|linexy|fcycle|vcycle3|vcycle3-dense|fe27|
         fe27-dense|fcycle3|planexy|vcycle-periodic|vcycle3-periodic|
         planexy-point|planexy-linex|planexy-fcycle|planexy-cedar|
         vcycle-cedar|vcycle3-cedar]

To profile another checkout (for example the parent commit, unpacked with
``git archive`` into DIR), run the script by path with that checkout
first on the path: ``PYTHONPATH=DIR python3
cedar_tpu_torch/tools/profile_cycle.py planexy``.
"""

from __future__ import annotations

import re
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from cedar_tpu_torch import (
    Config, FivePt, NinePt, SevenPt, Solver2, Solver3, TwentySevenPt,
    gallery,
)
from cedar_tpu_torch.solver import cycle2, cycle3, graph, inner


CYCLES = 10
SCOPES = ("relaxation", "relaxation-residual-fused",
          "relaxation-residual-restrict-fused", "interp-add-relax-fused",
          "restrict", "interp-add", "interp", "coarse-solve", "residual")
def _aniso3(nx, ny, nz, dtype, dev):
    return gallery.diag_diffusion3(nx, ny, nz, 1.0, 1.0, 1e-3, dtype, dev)


#: the inner coarse solve's cg-config at full width
CG = {"solver": {"tol": 1e-4, "max-iter": 10}}


def _plane(psolver: dict, cg: dict | None = None) -> dict:
    """A plane-config of one embedded cycle a colour (as the default),
    with ``psolver``'s solver keys (and a cg-config)."""
    out = {"plane-config": {"solver": {"max-iter": 1, **psolver}}}
    if cg is not None:
        out["plane-config"]["cg-config"] = cg
    return out


def _periodic_x(make):
    """``make``'s 2D operator periodic along x: the W couplings of row 0,
    which the wrap reads, copied from row 1."""
    def periodic(nx, ny, dtype, dev):
        so = make(nx, ny, dtype, dev)
        so[1, 0] = so[1, 1]
        return so
    return periodic


def _periodic3_x(make):
    """``make``'s 3D operator periodic along x (gallery.periodic3)."""
    def periodic(nx, ny, nz, dtype, dev):
        return gallery.periodic3(make(nx, ny, nz, dtype, dev),
                                 (True, False, False))
    return periodic


# name -> (dimension, n, gallery operator, kind, solver settings[, kernels
# settings[, grid settings]])
CONFIGS = {
    "vcycle": (2, 4096, gallery.poisson, FivePt, {}),
    "vcycle-dense": (2, 4096, gallery.poisson, FivePt, {},
                     {"fine-split": False}),
    "linexy": (2, 2048, gallery.fe, NinePt, {"relaxation": "line-xy"}),
    "fcycle": (2, 4096, gallery.poisson, FivePt, {"cycle": {"type": "f"}}),
    "vcycle3": (3, 256, gallery.poisson3, SevenPt, {},
                {"fine-split": True}),
    "vcycle3-dense": (3, 256, gallery.poisson3, SevenPt, {},
                      {"fine-split": False}),
    "fe27": (3, 128, gallery.fe3, TwentySevenPt, {},
             {"fine-split": True}),
    "fe27-dense": (3, 128, gallery.fe3, TwentySevenPt, {},
                   {"fine-split": False}),
    "fcycle3": (3, 256, gallery.poisson3, SevenPt, {"cycle": {"type": "f"}}),
    "planexy": (3, 128, _aniso3, SevenPt, {"relaxation": "plane-xy"}),
    "vcycle-periodic": (2, 4096, _periodic_x(gallery.poisson), FivePt, {},
                        {}, {"periodic": [True, False]}),
    "vcycle3-periodic": (3, 256, _periodic3_x(gallery.poisson3), SevenPt, {},
                         {}, {"periodic": [True, False, False]}),
    "planexy-point": (3, 128, _aniso3, SevenPt, {"relaxation": "plane-xy"},
                      {}, {}, _plane({"relaxation": "point"})),
    "planexy-linex": (3, 128, _aniso3, SevenPt, {"relaxation": "plane-xy"},
                      {}, {}, _plane({"relaxation": "line-x"})),
    "planexy-fcycle": (3, 128, _aniso3, SevenPt, {"relaxation": "plane-xy"},
                       {}, {}, _plane({"relaxation": "line-xy",
                                       "cycle": {"type": "f"}})),
    "planexy-cedar": (3, 128, _aniso3, SevenPt, {"relaxation": "plane-xy"},
                      {}, {}, _plane({"relaxation": "line-xy",
                                      "cg-solver": "cedar",
                                      "min-coarse": 16}, CG)),
    "vcycle-cedar": (2, 4096, gallery.poisson, FivePt, {
        "num-levels": 3, "cg-solver": "cedar"}, {}, {}, {"cg-config": CG}),
    "vcycle3-cedar": (3, 256, gallery.poisson3, SevenPt, {
        "num-levels": 3, "cg-solver": "cedar"}, {}, {}, {"cg-config": CG}),
}


def _device_us(evt) -> float:
    # the attribute's name changed across PyTorch releases
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def transfer2(key: str) -> str | None:
    """"K2" or "K3" for a profiler key of the 2D restrict or interp-add
    kernel (five int parameters; those of csrc/transfer3.cu have six),
    else None."""
    for kernel, label in (("restrict_kernel<", "K2"),
                          ("interp_add_kernel<", "K3")):
        if kernel in key:
            params = key.split(kernel, 1)[1]
            return label if len(re.findall(r"\bint\b", params)) == 5 else None
    return None


def profile_cycles(label: str, cycle) -> None:
    """Time ``CYCLES`` calls of ``cycle`` by CUDA events, then trace as
    many, and print the report (module docstring) under ``label``."""
    for _ in range(3):
        cycle()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(CYCLES):
        cycle()
    e1.record()
    torch.cuda.synchronize()
    print(f"[{label}] wall ms/cycle (CUDA events, no profiler): "
          f"{e0.elapsed_time(e1) / CYCLES:.4f}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        e0.record()
        for _ in range(CYCLES):
            cycle()
        e1.record()
        torch.cuda.synchronize()
    wall_ms = e0.elapsed_time(e1) / CYCLES

    dev_ms = {}
    host_ms = {}
    k23 = {"K2": [0.0, 0], "K3": [0.0, 0]}
    for evt in prof.key_averages():
        if evt.key in SCOPES:
            # a scope's device-side copy repeats its kernels' time: take
            # the host-side range only
            if evt.device_type == torch.autograd.DeviceType.CPU:
                host_ms[evt.key] = evt.cpu_time_total / 1e3 / CYCLES
            continue
        d = _device_us(evt)
        if d > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            dev_ms[evt.key] = d / 1e3 / CYCLES
            label2 = transfer2(evt.key)
            if label2:
                k23[label2][0] += d / 1e3 / CYCLES
                k23[label2][1] += evt.count / CYCLES
    busy = sum(dev_ms.values())
    print(f"[{label}] wall ms/cycle (CUDA events, under the profiler): "
          f"{wall_ms:.4f}")
    if not dev_ms:
        print(f"[{label}] the profiler saw no device time: wall ms only")
        return
    print(f"[{label}] device busy ms/cycle: {busy:.4f} "
          f"(busy share {busy / wall_ms:.3f}, idle share "
          f"{1 - busy / wall_ms:.3f}); {len(dev_ms)} kernel names")
    print(f"[{label}] device ms/cycle by kernel:")
    for k, v in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {v:9.4f}  {k[:100]}")
    (k2, n2), (k3, n3) = k23["K2"], k23["K3"]
    print(f"[{label}] K2 + K3 device ms/cycle: {k2:.4f} ({n2:g} launches) "
          f"+ {k3:.4f} ({n3:g}) = {k2 + k3:.4f}")
    if host_ms:
        print(f"[{label}] host ms/cycle by scope (inclusive):")
        for k, v in sorted(host_ms.items(), key=lambda kv: -kv[1]):
            print(f"  {v:9.4f}  {k}")


def main(name: str = "vcycle") -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_cycle: no CUDA device")
    dev = torch.device("cuda", 0)
    dim, n, make, kind, solver, *more = CONFIGS[name]
    kernels, grid, extra = (*more, {}, {}, {})[:3]
    conf = Config({"log": [], "kernels": kernels, "grid": grid, **extra,
                   "solver": {**solver, "cycle": {
                       "nrelax-pre": 1, "nrelax-post": 1,
                       **solver.get("cycle", {})}}})
    shape = (n,) * dim
    solver_cls, rhs, cyc = ((Solver2, gallery.poisson_rhs, cycle2) if dim == 2
                            else (Solver3, gallery.poisson3_rhs, cycle3))
    s = solver_cls(make(*shape, torch.float32, dev), kind, conf)
    b = rhs(*shape, torch.float32, dev)
    x = torch.zeros_like(b)
    print(f"device: {torch.cuda.get_device_name(0)}; {name}: {n}^{dim} "
          f"float32, {s.nlevels} levels")

    # the cycles' own keywords (the periodic axes), where the solver has
    # them
    kw = getattr(getattr(s, "graphs", None), "cycle_kw", {})

    def eager():
        # one iteration as the CPU's solve loop runs it, without the
        # norm's readback
        nonlocal x
        x = cyc.cycle_residual(s.levels, s.kinds, x, b, s.settings, **kw)[0]

    profile_cycles("eager", eager)
    if not hasattr(s, "graphs"):
        return   # a checkout from before the captured solve
    # the solver's own captured iteration, as its solve replays it on the
    # card (without the norm's readback)
    g = s.graphs.graph("solve", b)
    g.b.copy_(b)
    profile_cycles("graph", g.replay)
    found = inner_of(s, cyc)
    if found is None:
        return
    inner.record_active = steps = []
    cyc.cycle_residual(s.levels, s.kinds, torch.zeros_like(b), b, s.settings,
                       **kw)
    torch.cuda.synchronize()
    inner.record_active = None
    useful = sum(bool(a.any()) for a in steps)
    print(f"[inner] one eager cycle: {len(steps)} inner steps run, {useful} "
          "with a plane (or the grid) still active")
    coarse, settings, icyc = found
    gen = torch.Generator(device=dev).manual_seed(40)
    cb = torch.randn(tuple(coarse.so.shape[1:]), generator=gen, device=dev,
                     dtype=coarse.so.dtype)
    out = torch.empty_like(cb)

    def solve_once():
        out.copy_(icyc.coarse_solve(coarse, cb, settings))

    backend = graph.CudaGraphs(dev)
    backend.warm(solve_once)
    gi = backend.capture(solve_once)
    print(f"[inner graph] the inner solve alone on {tuple(cb.shape)}, "
          f"{settings.cg_settings.maxiter} steps a solve")
    profile_cycles("inner graph", lambda: backend.replay(gi))


def inner_of(s, cyc):
    """``(coarsest level, settings, cycle module)`` of the solver's inner
    coarse solve, or else of the first plane hierarchy's; None where there
    is none."""
    if s.levels[-1].inner is not None:
        return s.levels[-1], s.settings, cyc
    for lev in s.levels:
        for hiers in (lev.planes or {}).values():
            for h in hiers:
                if h is not None and h[-1].inner is not None:
                    return h[-1], s.settings.plane_settings, cycle2
    return None


if __name__ == "__main__":
    main(*sys.argv[1:])
