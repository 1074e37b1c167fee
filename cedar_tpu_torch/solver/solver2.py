"""2D multilevel BoxMG solver.

PyTorch counterpart of :mod:`cedar_tpu.solver.solver2` (reference:
include/cedar/2d/solver.h:21-122, include/cedar/multilevel.h:26-318) for
point and line relaxation, V-, W- and F-cycles, the direct (LU) coarse
solve and the inner multigrid coarse solve (``cg-solver: cedar``, or
``redist``, which cedar_tpu runs as the same inner solve on a serial grid;
configured by ``cg-config``, nested to any depth), on grids with or
without periodic axes (``grid.periodic``; the doubly periodic singular
case with ``solver.definite: false``).
:func:`setup_hierarchy` also builds the batched hierarchies of 3D plane
relaxation's embedded solvers.
Tensors stay on the device of the operator given: on the card the sweeps
and grid transfers run the hand-written CUDA kernels, on the CPU their
plain torch versions.

* **setup** — per level: operator-induced interpolation, Galerkin coarse
  operator, 1/diag; coarsest: dense inverse (multilevel.h:243-265), or
  under ``cg-solver: cedar`` the inner solver's own hierarchy
  (``Level.inner``; reference: setup_cg_solve, 2d/mpi/solver.h:97-139).
* **solve** — residual-norm-controlled cycle iteration (multilevel.h:278-298)
  as a Python loop that reads the convergence norm back once per cycle;
  ``history`` holds the reference's per-iteration "relative l2 norm" lines.
  On the card each cycle, with its norm, is one replay of a captured CUDA
  graph (:mod:`cedar_tpu_torch.solver.graph`, the counterpart of the JAX
  package's compiled solve), and ``vcycle`` replays a graph of its own.
  The graphs read the hierarchy by address: assigning ``levels`` drops
  them, and the next call captures anew over the new hierarchy (the JAX
  package passes its hierarchy to the compiled programs at every call).
  On the CPU the same iteration runs eagerly.

``kernels.fine-split`` (default: true on the card, false on the CPU, as
cedar_tpu turns it on wherever its Pallas kernels run) selects the fused
fine-level V-cycle (:func:`cycle2.ncycle_split`) on the top
``kernels.split-levels`` levels (default 4); periodic grids run the dense
cycle whatever it says, as in cedar_tpu.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch import schema
from cedar_tpu_torch.config import Config
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cg
from cedar_tpu_torch.ops.galerkin2 import coarsen_op
from cedar_tpu_torch.ops.interp2 import setup_interp
from cedar_tpu_torch.ops.lines2 import setup_lines
from cedar_tpu_torch.ops.relax2 import setup_recip
from cedar_tpu_torch.ops.stencil2 import residual
from cedar_tpu_torch.settings import CGType, MLSettings, RelaxType
from cedar_tpu_torch.solver import cycle2, graph
from cedar_tpu_torch.solver.level import Level
from cedar_tpu_torch.utils import log
from cedar_tpu_torch.utils.timing import TimeLog


def compute_num_levels(nx: int, ny: int, min_coarse: int) -> int:
    """Halve until below min_coarse (reference: 2d/solver.h:57-73)."""
    ng = 0
    while True:
        ng += 1
        nxc = (nx - 1) // (1 << ng) + 1
        nyc = (ny - 1) // (1 << ng) + 1
        if min(nxc, nyc) < min_coarse:
            return ng


def level_shapes(nx: int, ny: int, nlevels: int) -> list[tuple[int, int]]:
    """Per-level interior shapes, nxc = (nx-1)/2 + 1 (2d/solver.h:75-116)."""
    shapes = [(nx, ny)]
    for _ in range(nlevels - 1):
        nx = (nx - 1) // 2 + 1
        ny = (ny - 1) // 2 + 1
        shapes.append((nx, ny))
    return shapes


def setup_level_workspace(so: torch.Tensor, kind: StencilKind,
                          settings: MLSettings,
                          periodic=(False, False)) -> tuple:
    """``(recip, sor_x, sor_y)`` of one level (or of a batch of planes,
    ``so`` ``(ndir, B, nx, ny)``): 1/diag for point relaxation, the LDLᵀ
    factors of the configured line axes (cedar_tpu/solver/
    solver2.py:87-127).  On CUDA tensors the line kernel factors on the fly,
    so no line factors are set up there, as the JAX package skips them
    where its setup-free fused kernel runs; nor along a periodic axis, whose
    cyclic lines factor their modified matrix on the fly on both devices."""
    rt = settings.relaxation
    recip = setup_recip(so) if rt == RelaxType.point else None
    factor = not so.is_cuda
    sor_x = (setup_lines(so, kind, "x")
             if factor and not periodic[0]
             and rt in (RelaxType.line_x, RelaxType.line_xy)
             else None)
    sor_y = (setup_lines(so, kind, "y")
             if factor and not periodic[1]
             and rt in (RelaxType.line_y, RelaxType.line_xy)
             else None)
    return recip, sor_x, sor_y


def setup_hierarchy(so_fine: torch.Tensor, fine_kind: StencilKind,
                    nlevels: int, settings: MLSettings | None = None,
                    indefinite: bool = False,
                    periodic=(False, False)) -> tuple:
    """Build the level hierarchy (reference: multilevel.h:243-265);
    ``settings`` (default: Cedar's defaults, point relaxation) picks the
    relaxation workspace and the coarse solve: LU, or for a coarse solver
    other than LU on two levels or more an inner hierarchy on the coarsest
    level (:func:`setup_inner`).  A batched ``so_fine`` ``(ndir, B, nx,
    ny)`` (plane relaxation's planes) gives a hierarchy of batched levels,
    plane by plane the hierarchy of each plane.  On ``periodic`` axes the
    interpolation, the Galerkin product and the coarse matrix wrap
    around."""
    if settings is None:
        settings = MLSettings()
    levels = []
    so, kind, ci = so_fine.contiguous(), fine_kind, None
    for _ in range(nlevels - 1):
        ci_next = setup_interp(so, kind, periodic)
        recip, sor_x, sor_y = setup_level_workspace(so, kind, settings,
                                                    periodic)
        levels.append(Level(so=so, recip=recip, ci=ci, sor_x=sor_x,
                            sor_y=sor_y))
        so = coarsen_op(ci_next, so, kind, periodic).contiguous()
        kind, ci = StencilKind.nine_pt, ci_next
    if settings.coarse_solver != CGType.lu and nlevels > 1:
        # cg-solver cedar or redist: on a serial grid cedar_tpu runs both
        # as the inner multigrid solve (cedar_tpu/solver/solver2.py:208-223)
        levels.append(Level(so=so, ci=ci, inner=setup_inner(
            so, settings, indefinite, periodic)))
    else:
        levels.append(Level(so=so, ci=ci, ainv=cg.setup_cg_lu(
            so, kind, indefinite, periodic)))
    return tuple(levels)


def setup_inner(so: torch.Tensor, settings: MLSettings, indefinite: bool,
                periodic=(False, False)) -> tuple:
    """The inner solver's hierarchy on the coarsest operator ``so``
    (9-point; batched for plane relaxation's planes), from
    ``settings.cg_settings``: ``compute_num_levels`` of the coarsest grid
    by its ``min-coarse``, capped by its ``num-levels``, with the outer
    solve's periodic axes and definiteness, as cedar_tpu builds it
    (cedar_tpu/solver/solver2.py:207-223)."""
    ist = settings.cg_settings
    nlev = compute_num_levels(so.shape[-2], so.shape[-1], ist.min_coarse)
    if ist.num_levels > 0:
        nlev = min(nlev, ist.num_levels)
    if nlev > 1 and ist.relaxation not in _RELAX_2D:
        # cedar_tpu's 2D cycle has no such smoother (cycle2._smooth raises)
        raise NotImplementedError(
            f"cedar_tpu_torch: cg-config relaxation {ist.relaxation.value} "
            "on a 2D inner solver (cedar_tpu cannot run it either)")
    return setup_hierarchy(so, StencilKind.nine_pt, nlev, ist, indefinite,
                           periodic)


def _l2(r: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(r * r))


_RELAX_2D = (RelaxType.point, RelaxType.line_x, RelaxType.line_y,
             RelaxType.line_xy)


def _unsupported(conf: Config, settings: MLSettings, so, kind) -> str | None:
    """The first configured feature outside this package, or None.
    ``grid.np`` (a process grid) is accepted and ignored on a serial
    solver, as cedar_tpu ignores it; the distributed solvers take a mesh
    (:mod:`cedar_tpu_torch.parallel`)."""
    if so.ndim != 3 or kind.ndim != 2:
        return "3D operators: use Solver3"
    if settings.relaxation not in _RELAX_2D:
        return (f"relaxation {settings.relaxation.value} in 2D (plane "
                "relaxation is 3D: use Solver3)")
    if conf.get("kernels.backend", "auto") == "xla":
        return ("kernels.backend xla (the device decides: kernels on CUDA, "
                "torch ops on the CPU)")
    return None


class Solver2:
    """2D BoxMG solver over interior-only tensors.

    Parameters
    ----------
    so : (ndir, nx, ny) stencil operator (FivePt: [O,W,S]; NinePt adds SW,NW)
         on the device the solve runs on
    kind : StencilKind of the fine operator
    conf : Config | dict | None — Cedar-compatible configuration

    Raises ``NotImplementedError`` for configurations outside the 2D point
    or line relaxation V- or F-cycle with a direct or inner multigrid
    (``cg-solver: cedar`` or ``redist``) coarse solve.

    On the card ``solve`` and ``vcycle`` replay CUDA graphs captured at
    their first call (``graphs``) that read the hierarchy ``levels`` by
    address.  Assigning ``levels`` (a hierarchy of the same shapes, e.g.
    one carried across with ``levels_from_numpy``) drops the graphs and
    releases their memory pool; the next call captures over the new one.
    Do not change the hierarchy's tensors in place after a capture.
    """

    def __init__(self, so: torch.Tensor,
                 kind: StencilKind = StencilKind.five_pt,
                 conf: Config | dict | None = None):
        if not isinstance(conf, Config):
            conf = Config(conf)
        schema.validate(conf)
        self.conf = conf
        self.settings = MLSettings.from_config(conf)
        missing = _unsupported(conf, self.settings, so, kind)
        if missing is not None:
            raise NotImplementedError(f"cedar_tpu_torch: {missing}")
        # the fused fine-level cycle: on by default wherever the kernels
        # run, as cedar_tpu turns it on with its Pallas kernels
        # (cedar_tpu/solver/solver2.py:277-282); the gates on the cycle
        # and relaxation are cycle2.fine_split_ok's
        self.settings.fine_split = bool(conf.get("kernels.fine-split",
                                                 so.is_cuda))
        self.settings.split_levels = int(conf.get("kernels.split-levels", 4))
        log.set_enabled(conf.get("log", ["status", "error"]))
        self.kind = kind
        per = conf.get("grid.periodic", [False, False])
        self.periodic = (bool(per[0]), bool(per[1]))
        self.indefinite = not conf.get("solver.definite", True)

        nx, ny = so.shape[1], so.shape[2]
        nlevels = compute_num_levels(nx, ny, self.settings.min_coarse)
        if self.settings.num_levels > 0:
            if self.settings.num_levels > nlevels:
                raise ValueError("too many levels specified")
            nlevels = self.settings.num_levels
        self.nlevels = nlevels
        self.shapes = level_shapes(nx, ny, nlevels)
        self.kinds = [kind] + [StencilKind.nine_pt] * (nlevels - 1)
        log.debug(f"Using a {nlevels} level hierarchy")

        self.timelog = TimeLog()
        self.timelog.begin("setup")
        self.levels = setup_hierarchy(so, kind, nlevels, self.settings,
                                      self.indefinite, self.periodic)
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
        self.graphs = graph.CycleGraphs(cycle2, levels, self.kinds,
                                        self.settings, periodic=self.periodic)

    def vcycle(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One cycle (reference: multilevel::vcycle); ``x`` is not modified.
        On the card it replays the solver's captured cycle
        (:class:`~cedar_tpu_torch.solver.graph.CycleGraphs`)."""
        if b.is_cuda:
            return self.graphs.vcycle(x, b)
        return cycle2.run_cycle(self.levels, self.kinds, x.clone(), b,
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
        if b.is_cuda:
            x, hist = self.graphs.solve(x, b, res0)
        else:
            def step():
                nonlocal x
                x, rnorm = cycle2.cycle_residual(self.levels, self.kinds,
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
