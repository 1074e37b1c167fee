"""3D multilevel BoxMG solver.

PyTorch counterpart of :mod:`cedar_tpu.solver.solver3` (reference:
include/cedar/3d/solver.h:17-130, include/cedar/multilevel.h:26-318) for
point and plane relaxation, V-, W- and F-cycles, the direct (LU) coarse
solve and the inner multigrid coarse solve (``cg-solver: cedar``, or
``redist``, which cedar_tpu runs as the same inner solve on a serial grid;
a 27-point point-relaxation hierarchy, nested to any depth), serial, on
grids with or without periodic axes (``grid.periodic``,
any subset of x, y and z; the triply periodic singular case with
``solver.definite: false``).  Tensors stay on the device of the
operator given: on the card the sweeps, line-xy smooths and grid transfers
run the hand-written CUDA kernels, on the CPU their plain torch versions.

* **setup** — per level: operator-induced interpolation, Galerkin coarse
  operator (27-point on every coarse level), 1/diag for point relaxation;
  coarsest: dense inverse (multilevel.h:243-265) or the inner solver's
  hierarchy (``Level.inner``, ``cg-solver: cedar``); for plane relaxation,
  the batched 2D plane hierarchies (:func:`cedar_tpu_torch.ops.planes3.
  setup_planes`) of every relaxation and cycle that ``plane-config`` asks
  for, with an inner hierarchy of their own under its ``cg-solver:
  cedar``.
* **solve** — residual-norm-controlled cycle iteration (multilevel.h:278-298)
  as a Python loop that reads the convergence norm back once per cycle;
  ``history`` holds the reference's per-iteration "relative l2 norm" lines.
  On the card each cycle, with its norm, is one replay of a captured CUDA
  graph (:mod:`cedar_tpu_torch.solver.graph`, the counterpart of the JAX
  package's compiled solve), and ``vcycle`` replays a graph of its own.
  The graphs read the hierarchy by address: assigning ``levels`` drops
  them, and the next call captures anew.  On the CPU the same iteration
  runs eagerly.

``kernels.fine-split`` (default false on both devices: on the H100 the
fused cycle measured slower than the dense one, and both give the same
values bit for bit) selects the fused fine-level V-cycle
(:func:`cycle3.ncycle_split`, kernels K14-K16 and the 27-point edge
kernel on the card) on the top ``kernels.split-levels`` levels (default
4); periodic grids run the dense cycle whatever it says, as in cedar_tpu.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch import schema
from cedar_tpu_torch.config import Config
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import backend, cg, planes3
from cedar_tpu_torch.ops.galerkin3 import coarsen_op
from cedar_tpu_torch.ops.interp3 import setup_interp
from cedar_tpu_torch.ops.relax3 import setup_recip
from cedar_tpu_torch.ops.stencil3 import residual
from cedar_tpu_torch.settings import CGType, MLSettings, RelaxType
from cedar_tpu_torch.solver import cycle3, graph
from cedar_tpu_torch.solver.level import Level
from cedar_tpu_torch.solver.solver2 import _l2
from cedar_tpu_torch.utils import log
from cedar_tpu_torch.utils.timing import TimeLog


def compute_num_levels(nx: int, ny: int, nz: int, min_coarse: int) -> int:
    """Halve until below min_coarse (reference: 3d/solver.h:68-84)."""
    ng = 0
    while True:
        ng += 1
        nc = [(n - 1) // (1 << ng) + 1 for n in (nx, ny, nz)]
        if min(nc) < min_coarse:
            return ng


def level_shapes(nx: int, ny: int, nz: int,
                 nlevels: int) -> list[tuple[int, int, int]]:
    """Per-level interior shapes, nc = (n-1)/2 + 1 per axis."""
    shapes = [(nx, ny, nz)]
    for _ in range(nlevels - 1):
        nx, ny, nz = ((n - 1) // 2 + 1 for n in (nx, ny, nz))
        shapes.append((nx, ny, nz))
    return shapes


def setup_hierarchy(so_fine: torch.Tensor, fine_kind: StencilKind,
                    nlevels: int, settings: MLSettings | None = None,
                    indefinite: bool = False,
                    periodic=(False, False, False)) -> tuple:
    """Build the level hierarchy (reference: multilevel.h:243-265);
    ``settings`` (default: Cedar's defaults, point relaxation) decides
    whether the levels carry 1/diag, which only point relaxation reads
    (cedar_tpu/solver/solver3.py:84,159), and the coarse solve: LU, or for
    a coarse solver other than LU on two levels or more an inner hierarchy
    on the coarsest level (:func:`setup_inner`).  On
    ``periodic`` axes the interpolation, the Galerkin product and the
    coarse matrix wrap around (cedar_tpu/solver/solver3.py:63-81,
    172-184)."""
    point = settings is None or settings.relaxation == RelaxType.point
    levels = []
    so, kind, ci = so_fine.contiguous(), fine_kind, None
    for _ in range(nlevels - 1):
        ci_next = setup_interp(so, kind, periodic)
        levels.append(Level(so=so, recip=setup_recip(so) if point else None,
                            ci=ci))
        so = coarsen_op(ci_next, so, kind, periodic).contiguous()
        kind, ci = StencilKind.twenty_seven_pt, ci_next
    if (settings is not None and settings.coarse_solver != CGType.lu
            and nlevels > 1):
        levels.append(Level(so=so, ci=ci, inner=setup_inner(
            so, settings, indefinite, periodic)))
    else:
        levels.append(Level(so=so, ci=ci, ainv=cg.setup_cg_lu(
            so, kind, indefinite, periodic)))
    return tuple(levels)


def setup_inner(so: torch.Tensor, settings: MLSettings, indefinite: bool,
                periodic=(False, False, False)) -> tuple:
    """The inner solver's hierarchy on the 27-point coarsest operator
    ``so``, from ``settings.cg_settings``: ``compute_num_levels`` of the
    coarsest grid by its ``min-coarse``, capped by its ``num-levels``,
    with the outer solve's periodic axes and definiteness
    (cedar_tpu/solver/solver3.py:164-178).  Its levels get no plane
    hierarchies (cedar_tpu runs ``setup_planes`` on the outer levels only,
    solver3.py:286-288), so an inner solver of two levels or more relaxes
    by points; cedar_tpu fails on any other relaxation there, and so is it
    refused here."""
    ist = settings.cg_settings
    nlev = compute_num_levels(*so.shape[-3:], ist.min_coarse)
    if ist.num_levels > 0:
        nlev = min(nlev, ist.num_levels)
    if nlev > 1 and ist.relaxation != RelaxType.point:
        raise NotImplementedError(
            f"cedar_tpu_torch: cg-config relaxation {ist.relaxation.value} "
            "on a 3D inner solver: cedar_tpu builds no plane solvers for "
            "its inner hierarchy (setup_planes runs on the outer levels "
            "only) and cannot run it")
    return setup_hierarchy(so, StencilKind.twenty_seven_pt, nlev, ist,
                           indefinite, periodic)


def unsupported_planes(settings: MLSettings) -> str | None:
    """The first plane-config feature outside this package, or None: the
    embedded plane solvers run batched point, line-x, line-y or line-xy
    V- or F-cycles with an LU or inner multigrid coarse solve."""
    ps = settings.plane_settings
    if ps.relaxation not in planes3.PLANE_RELAX:
        return (f"plane-config relaxation {ps.relaxation.value} (the "
                "embedded plane solvers are 2D)")
    # the plane-config's own grid.periodic is accepted and ignored: the
    # JAX package builds its plane solvers non-periodic whatever it says
    # (cedar_tpu/ops/planes3.py:131-176)
    return None


def _unsupported(conf: Config, settings: MLSettings, so, kind) -> str | None:
    """The first configured feature outside this package, or None."""
    if so.ndim != 4 or kind.ndim != 3:
        return "2D operators: use Solver2"
    if settings.relaxation in planes3.ORIENTS_OF:
        missing = unsupported_planes(settings)
        if missing is not None:
            return missing
    elif settings.relaxation != RelaxType.point:
        return (f"relaxation {settings.relaxation.value} in 3D (cedar_tpu "
                "relaxes 3D grids by points or planes)")
    # grid.np is accepted and ignored on a serial solver, as in cedar_tpu
    return None


class Solver3:
    """3D BoxMG solver over interior-only tensors.

    Parameters
    ----------
    so : (ndir, nx, ny, nz) stencil operator (SevenPt: [P, PW, PS, B];
         TwentySevenPt: all 14 planes) on the device the solve runs on
    kind : StencilKind of the fine operator
    conf : Config | dict | None — Cedar-compatible configuration

    Raises ``NotImplementedError`` for configurations outside the 3D point
    or plane relaxation V- or F-cycle with a direct or inner multigrid
    coarse solve (plane relaxation: embedded point, line-x, line-y or
    line-xy V- or F-cycles, with either coarse solve).
    With point relaxation and ``kernels.fine-split: true`` the V-cycle,
    and the F-cycle's inner V-cycles, run the fused top levels.

    On the card ``solve`` and ``vcycle`` replay CUDA graphs captured at
    their first call (``graphs``) that read the hierarchy ``levels`` (and
    its plane hierarchies) by address.  Assigning ``levels`` drops the
    graphs and releases their memory pool; the next call captures over the
    new hierarchy.  Do not change its tensors in place after a capture.
    """

    def __init__(self, so: torch.Tensor,
                 kind: StencilKind = StencilKind.seven_pt,
                 conf: Config | dict | None = None):
        if not isinstance(conf, Config):
            conf = Config(conf)
        schema.validate(conf)
        self.conf = conf
        self.settings = MLSettings.from_config(conf)
        missing = _unsupported(conf, self.settings, so, kind)
        if missing is not None:
            raise NotImplementedError(f"cedar_tpu_torch: {missing}")
        # the fused fine-level cycle: off unless asked for.  cedar_tpu
        # turns it on wherever its Pallas kernels run
        # (cedar_tpu/solver/solver3.py:234-236); on the H100 the fused
        # 3D cycle measured slower than the dense one in alternating pairs
        # (3d_poisson_7pt_256 and 3d_fe_27pt_128, PERF.md §6), and
        # the two give the same values bit for bit.  The gates on the
        # cycle and relaxation are cycle3.fine_split_ok's
        self.settings.fine_split = bool(conf.get("kernels.fine-split",
                                                 False))
        self.settings.split_levels = int(conf.get("kernels.split-levels", 4))
        # kernels.backend: the kernels on the card unless "xla"; a
        # plane-config that pins its own holds for the plane solves
        # (ops/backend.py; cedar_tpu/solver/solver3.py:221-256)
        backend.resolve(self.settings, conf, so.is_cuda)
        log.set_enabled(conf.get("log", ["status", "error"]))
        self.kind = kind
        # grid.periodic padded to three axes (cedar_tpu/solver/
        # solver3.py:255-258)
        per = list(conf.get("grid.periodic", [False, False, False]))
        per += [False] * (3 - len(per))
        self.periodic = tuple(bool(p) for p in per[:3])
        self.indefinite = not conf.get("solver.definite", True)

        nx, ny, nz = so.shape[1], so.shape[2], so.shape[3]
        nlevels = compute_num_levels(nx, ny, nz, self.settings.min_coarse)
        if self.settings.num_levels > 0:
            if self.settings.num_levels > nlevels:
                raise ValueError("too many levels specified")
            nlevels = self.settings.num_levels
        self.nlevels = nlevels
        self.shapes = level_shapes(nx, ny, nz, nlevels)
        self.kinds = [kind] + [StencilKind.twenty_seven_pt] * (nlevels - 1)
        log.debug(f"Using a {nlevels} level hierarchy")

        self.timelog = TimeLog()
        self.timelog.begin("setup")
        with backend.using(self.settings.kernel_backend):
            levels = setup_hierarchy(so, kind, nlevels, self.settings,
                                     self.indefinite, self.periodic)
            if self.settings.relaxation in planes3.ORIENTS_OF:
                levels = planes3.setup_planes(levels, self.kinds,
                                              self.settings)
        self.levels = levels
        self.timelog.end("setup", force=self.levels)

    @property
    def levels(self) -> tuple:
        """The hierarchy; assigning another drops the captured graphs."""
        return self._levels

    @levels.setter
    def levels(self, levels) -> None:
        self._levels = levels
        # the captured iterations of solve and vcycle on the card, over
        # this hierarchy, captured at their first call
        self.graphs = graph.CycleGraphs(cycle3, levels, self.kinds,
                                        self.settings, periodic=self.periodic)

    def vcycle(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One cycle (reference: multilevel::vcycle); ``x`` is not modified.
        On the card it replays the solver's captured cycle
        (:class:`~cedar_tpu_torch.solver.graph.CycleGraphs`)."""
        with backend.using(self.settings.kernel_backend):
            if b.is_cuda:
                return self.graphs.vcycle(x, b)
            return cycle3.run_cycle(self.levels, self.kinds, x.clone(), b,
                                    self.settings, self.periodic)

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None):
        """Iterate cycles until the relative residual drops below ``tol`` or
        ``max-iter`` cycles ran; ``x0`` (default zeros) is not modified.
        On the card each cycle is one replay of the captured iteration
        (:class:`~cedar_tpu_torch.solver.graph.CycleGraphs`), on the CPU
        the same iteration runs eagerly."""
        settings = self.settings
        fine = self.levels[0]
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        self.timelog.begin("solve")
        r0 = residual(fine.so, x, b, self.kinds[0], self.periodic)
        # floor protects the b = 0 (already-converged) edge case
        res0 = max(float(_l2(r0)), torch.finfo(b.dtype).tiny)
        with backend.using(settings.kernel_backend):
            if b.is_cuda:
                x, hist = self.graphs.solve(x, b, res0)
            else:
                def step():
                    nonlocal x
                    x, rnorm = cycle3.cycle_residual(self.levels, self.kinds,
                                                      x, b, settings,
                                                      self.periodic)
                    return rnorm

                hist = graph.iterate(step, res0, settings)
        self.timelog.end("solve", force=x)
        log.info(f"Initial residual l2 norm: {res0:g}")
        for i, rel in enumerate(hist):
            log.status(f"Iteration {i} relative l2 norm: {rel:g}")
        self.history = hist
        self.res0 = res0
        return x

    def save_timings(self, fname: str = "timings.json"):
        """Write the hierarchical timer report (reference: timings.json)."""
        self.timelog.save(fname)
        if log.enabled("timer"):
            import json as _json

            log.timer(_json.dumps(self.timelog.todict(), indent=2))

    @property
    def coarse_shape(self):
        return self.shapes[-1]
