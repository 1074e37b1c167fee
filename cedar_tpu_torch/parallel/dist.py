"""Distributed BoxMG solvers over ``torch.distributed``: ``DistSolver2``
and ``DistSolver3``, point, (2D) line and (3D) plane relaxation,
periodic axes.

PyTorch counterpart of :mod:`cedar_tpu.parallel.dist` (reference:
include/cedar/2d/mpi/solver.h, 3d/mpi/solver.h).  One process a rank,
each on its own device, each holding its blocks of every level:

* every rank passes the same global operator on its own device; the
  solver keeps this rank's block of the fine level and builds the
  hierarchy level by level on the blocks (:func:`cedar_tpu_torch.
  parallel.halo.setup_level`), as cedar_tpu's setup runs sharded
  (cedar_tpu/parallel/dist.py:22-24);
* the partition of each level comes from
  :func:`cedar_tpu_torch.parallel.policy.level_specs` (``redist.search.
  strategy`` coarsen, manual or astar; ``redist.min-local``); the
  coarsest level is replicated and every rank solves it redundantly (LU,
  or the inner hierarchy of ``cg-solver: cedar`` or ``redist``,
  cedar_tpu/parallel/dist.py:68-73);
* extents that do not divide over the mesh are padded with inert rows
  (unit diagonal, zero couplings, zero rhs) to a multiple of
  ``2^L * mesh_dim``, the level count pinned to the one of the true
  extents, and results cut back (cedar_tpu/parallel/dist.py:163-237);
* a periodic axis (``grid.periodic``) takes no pad: a level partitions it
  only where its blocks are even and replicates it otherwise
  (:func:`periodic_specs`); the halos carry the wrap
  (:mod:`cedar_tpu_torch.parallel.halo`).  A doubly or triply periodic
  indefinite solve (``solver.definite: false``) keeps the replicated
  coarse LU with its null-space handling;
* line relaxation (2D: line-x, line-y, line-xy, with or without
  ``solver.ml-relax.enabled``): per level and axis the distributed SPIKE
  solve (:mod:`cedar_tpu_torch.parallel.lines`) where cedar_tpu chooses it
  (cedar_tpu/parallel/dist.py:292-322: not under ml-relax, an eligible
  partitioned line axis), else the gather of whole lines and the serial
  sweep (K4 on the card) on them (:meth:`cedar_tpu_torch.parallel.halo.
  DistContext.line_relax`);
* plane relaxation (3D: plane-xy, plane-xz, plane-yz, plane-xyz, with
  every plane-config the serial solver runs): per level and orientation
  the rank's planes gathered whole in-plane and relaxed by the serial
  batched plane cycles (K10, K1, K4 or K5 and K2/K3 on the card), their
  colour hierarchies set up on the rank's planes or cut from a carried
  global hierarchy (:mod:`cedar_tpu_torch.parallel.planes`); cedar_tpu
  pins its distributed plane cycles to XLA for a TPU reason
  (cedar_tpu/parallel/dist.py:369), the port runs its kernels under
  ``kernels.backend: auto`` and a plane-config that pins its own backend
  keeps it;
* ``kernels.backend: xla`` runs the plain versions of the kernels
  (:mod:`cedar_tpu_torch.ops.backend`);
* ``solve`` and ``vcycle`` run the port's cycle (``cycleN.ncycle``,
  ``fmg_cycle``, ``cycle_residual``) with the distributed ops of
  :class:`cedar_tpu_torch.parallel.halo.DistContext` on this rank's
  blocks, one all-reduce of the norm a cycle (inside the iteration), one
  readback of it a cycle, and return the global x on every rank (one
  all-gather, after the loop).  On the card each iteration is a replay of
  the solver's recorded iteration (:class:`cedar_tpu_torch.solver.graph.
  RecordedIteration`, the counterpart of cedar_tpu's ``jax.jit`` of its
  distributed solve and cycle, cedar_tpu/parallel/dist.py:289-290): one
  CUDA graph under NCCL, its collectives inside; under gloo, whose
  messages are staged through the host, captured segments with the calls
  run between them.  A capture or a replay that fails raises; the CPU
  runs the same iteration eagerly.  The fused fine-level cycle
  (``kernels.fine-split``) stays off under a mesh, as in cedar_tpu
  (cedar_tpu/solver/cycle2.py:170-176).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cedar_tpu_torch import schema
from cedar_tpu_torch.config import Config
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import backend, cg, planes3
from cedar_tpu_torch.parallel import halo, shard_relax
from cedar_tpu_torch.parallel.halo import Layout
from cedar_tpu_torch.parallel.policy import level_specs
from cedar_tpu_torch.parallel.topo import make_mesh
from cedar_tpu_torch.settings import CGType, MLSettings, RelaxType
from cedar_tpu_torch.solver import graph
from cedar_tpu_torch.solver.level import Level
from cedar_tpu_torch.utils import log
from cedar_tpu_torch.utils.timing import TimeLog

# relaxation -> the line axes it sweeps
_LINE_AXES = {RelaxType.line_x: ("x",), RelaxType.line_y: ("y",),
              RelaxType.line_xy: ("x", "y")}


def layouts(shapes, specs, mesh, periodic=None) -> list:
    """Each level's :class:`~cedar_tpu_torch.parallel.halo.Layout` on this
    rank."""
    return [Layout.of(shape, spec, mesh, periodic)
            for shape, spec in zip(shapes, specs)]


def periodic_specs(specs, shapes, mesh, periodic) -> list:
    """``specs`` with each periodic axis replicated on the levels where
    its blocks would be odd or uneven (cedar_tpu/parallel/dist.py:58-63,
    :181-198: an odd periodic extent replicates): a partitioned periodic
    axis needs an even block, so that a window from an even index reaches
    the wrap in whole coarse cells."""
    per = tuple(periodic or ())
    out = []
    for spec, shape in zip(specs, shapes):
        spec = list(spec)
        for d, ax in enumerate(spec):
            if (ax is not None and d < len(per) and per[d]
                    and shape[d] % (2 * mesh.shape[ax])):
                spec[d] = None
        out.append(tuple(spec))
    return out


def local_levels(levels, mesh, specs, periodic=None) -> tuple:
    """This rank's blocks of a global hierarchy (e.g. ``levels_from_numpy``
    of cedar_tpu's, or a serial solver's ``levels``) under ``specs``: each
    level's stencil block, the CI entries its transfers read, its plane
    hierarchies cut to the block's planes of each colour, and the
    coarsest level's ``ainv`` or ``inner`` (replicated), the layout the
    distributed solvers set up (``periodic``: the grid's periodic
    axes)."""
    lays = layouts([lev.so.shape[1:] for lev in levels], specs, mesh,
                   periodic)
    return tuple(halo.cut_level(lev, lay, lays[i - 1] if i else None)
                 for i, (lev, lay) in enumerate(zip(levels, lays)))


def pad_operator(so: torch.Tensor, mesh_dims, min_local: int = 8,
                 periodic=None):
    """``(so_padded, pads)``: axes that do not divide over the mesh padded
    with inert rows (unit diagonal, zero couplings) to a multiple of
    ``2^L * mesh_dim``, L the deepest level whose local extent still
    clears ``min_local`` (cedar_tpu/parallel/dist.py:163-220: the pad is
    less than one block of the coarsest partitioned level).  A periodic
    axis takes no pad (it would sit between the wrap's neighbours): it is
    replicated instead (:func:`periodic_specs`)."""
    dims = tuple(so.shape[1:])
    per = tuple(periodic or ()) + (False,) * len(dims)
    pads = []
    for d, n in enumerate(dims):
        nd = mesh_dims[d]
        if nd > 1 and n % nd and not per[d]:
            L = 1
            while n >= 2 ** (L + 1) * nd * max(min_local, 1):
                L += 1
            m = 2 ** L * nd
            pads.append(-(-n // m) * m - n)
        else:
            pads.append(0)
    if not any(pads):
        return so, pads
    pad = []
    for p in reversed(pads):
        pad += [0, p]
    sop = F.pad(so, pad)
    for d, p in enumerate(pads):
        if p:
            sop[0].narrow(d, dims[d], p).fill_(1.0)   # the diagonal
    return sop, pads


class _DistSolver:
    """The distributed solve shared by the 2D and 3D solvers."""

    _ndim = 2

    def __init__(self, so: torch.Tensor, kind: StencilKind, conf, mesh):
        if not isinstance(conf, Config):
            conf = Config(conf)
        schema.validate(conf)
        settings = MLSettings.from_config(conf)
        self._refuse(conf, settings, so, kind)
        self.mesh = mesh if mesh is not None else make_mesh(self._ndim)
        if len(self.mesh.axis_names) != self._ndim:
            raise ValueError(f"need a {self._ndim}-axis mesh, got "
                             f"{self.mesh.axis_names}")
        log.set_enabled(conf.get("log", ["status", "error"]))
        per = list(conf.get("grid.periodic", []))
        per += [False] * (self._ndim - len(per))
        self.periodic = tuple(bool(p) for p in per[:self._ndim])
        so = so.to(self.mesh.device)
        so = self._pad_operator(so, conf)
        self.conf = conf
        self.settings = MLSettings.from_config(conf)
        self.settings.fine_split = False
        # kernels.backend, "auto" by the mesh's device
        # (cedar_tpu/parallel/dist.py:134-144)
        backend.resolve(self.settings, conf, self.mesh.device.type == "cuda")
        self.kind = kind
        self.indefinite = not conf.get("solver.definite", True)
        sm = self._solver_module()
        dims = tuple(so.shape[1:])
        nlevels = sm.compute_num_levels(*dims, self.settings.min_coarse)
        if self.settings.num_levels > 0:
            if self.settings.num_levels > nlevels:
                raise ValueError("too many levels specified")
            nlevels = self.settings.num_levels
        self.nlevels = nlevels
        self.shapes = sm.level_shapes(*dims, nlevels)
        coarse_kind = (StencilKind.nine_pt if self._ndim == 2
                       else StencilKind.twenty_seven_pt)
        self.kinds = [kind] + [coarse_kind] * (nlevels - 1)
        strategy = conf.get("redist.search.strategy", "coarsen")
        machine = None
        if strategy == "astar":
            from cedar_tpu_torch.perf import MachineParams

            machine = MachineParams.from_config(conf)
        self.specs = level_specs(
            self.shapes, self.mesh, min_local=conf.get("redist.min-local", 8),
            strategy=strategy, path=conf.get("redist.search.path", None),
            machine_params=machine)
        # the coarsest level is replicated: a redundant coarse solve
        self.specs[-1] = (None,) * self._ndim
        self.specs = periodic_specs(self.specs, self.shapes, self.mesh,
                                    self.periodic)
        self.layouts = layouts(self.shapes, self.specs, self.mesh,
                               self.periodic)
        supported = (shard_relax.supported2 if self._ndim == 2
                     else shard_relax.supported3)
        if not supported(self.shapes[0], so.dtype, kind,
                         self.layouts[0].names, self.mesh):
            raise NotImplementedError(
                f"cedar_tpu_torch: no distributed sweep of a {kind.name} "
                f"{so.dtype} operator")
        self.timelog = TimeLog()
        self.timelog.begin("setup")
        with backend.using(self.settings.kernel_backend):
            self.levels = self._setup(halo._cut(so, self.layouts[0].lo,
                                                self.layouts[0].hi, lead=1))
        self.timelog.end("setup", force=self.levels)

    # -- configuration -----------------------------------------------------
    def _refuse(self, conf, settings, so, kind):
        if so.ndim != self._ndim + 1 or kind.ndim != self._ndim:
            raise NotImplementedError(
                f"cedar_tpu_torch: a {self._ndim}D distributed solver needs "
                f"a {self._ndim}D operator")
        rt = settings.relaxation
        if rt in _LINE_AXES and self._ndim != 2:
            raise NotImplementedError(
                f"cedar_tpu_torch: {rt.value} is a 2D relaxation")
        if rt in planes3.ORIENTS_OF:
            if self._ndim != 3:
                raise NotImplementedError(
                    f"cedar_tpu_torch: {rt.value} is a 3D relaxation")
            from cedar_tpu_torch.solver.solver3 import unsupported_planes

            missing = unsupported_planes(settings)
            if missing is not None:
                raise NotImplementedError(f"cedar_tpu_torch: {missing}")

    def _pad_operator(self, so, conf):
        """The operator padded by :func:`pad_operator`; with a pad, the
        level count pinned to the one of the true extents (unless
        ``solver.num-levels`` is set)."""
        self._true_dims = tuple(so.shape[1:])
        sop, pads = pad_operator(so, self.mesh.dims,
                                 conf.get("redist.min-local", 8),
                                 self.periodic)
        if any(pads):
            st = MLSettings.from_config(conf)
            if st.num_levels <= 0:
                conf.set("solver.num-levels", self._solver_module()
                         .compute_num_levels(*self._true_dims,
                                             st.min_coarse))
        return sop

    def _pad_func(self, a):
        a = a.to(self.mesh.device)
        if tuple(a.shape) == tuple(self.shapes[0]):
            return a
        pad = []
        for n, p in reversed(list(zip(a.shape, self.shapes[0]))):
            pad += [0, p - n]
        return F.pad(a, pad)

    def _unpad_func(self, a):
        if tuple(a.shape) == self._true_dims:
            return a
        return a[tuple(slice(0, n) for n in self._true_dims)]

    def _block(self, a):
        # a copy: plane relaxation updates its iterate in place
        lay = self.layouts[0]
        return halo._cut(self._pad_func(a), lay.lo, lay.hi).clone(
            memory_format=torch.contiguous_format)

    # -- setup -------------------------------------------------------------
    def _setup(self, so_block) -> tuple:
        sm = self._solver_module()
        levels, so, ci = [], so_block.contiguous(), None
        for lvl in range(self.nlevels - 1):
            so_c, ci_c = halo.setup_level(so, self.kinds[lvl],
                                          self.layouts[lvl],
                                          self.layouts[lvl + 1], self.mesh)
            levels.append(Level(so=so, ci=ci))
            so, ci = so_c, ci_c
        if self.settings.coarse_solver != CGType.lu and self.nlevels > 1:
            levels.append(Level(so=so, ci=ci, inner=sm.setup_inner(
                so, self.settings, self.indefinite, self.periodic)))
        else:
            levels.append(Level(so=so, ci=ci, ainv=cg.setup_cg_lu(
                so, self.kinds[-1], self.indefinite, self.periodic)))
        return tuple(levels)

    @property
    def levels(self) -> tuple:
        """This rank's hierarchy; assigning another (e.g. one of
        :func:`local_levels`) rebuilds the distributed ops' workspace and
        drops the recorded iterations (the next ``solve`` records anew)."""
        return self._levels

    @levels.setter
    def levels(self, levels) -> None:
        self._levels = tuple(levels)
        rt = self.settings.relaxation
        with backend.using(self.settings.kernel_backend):
            self.dist = halo.DistContext(
                self._levels, self.layouts, self.mesh, self.kinds,
                _LINE_AXES.get(rt, ()),
                spike=not self.settings.ml_relax_enabled,
                plane_orients=planes3.ORIENTS_OF.get(rt, ()),
                plane_settings=self.settings.plane_settings)
        # the recorded iterations of solve and vcycle on the card, over
        # this hierarchy and workspace, recorded at their first call
        self.graphs = graph.CycleGraphs(
            self._cycle_module(), self._levels, self.kinds, self.settings,
            periodic=self.periodic, dist=self.dist)

    # -- solve -------------------------------------------------------------
    def vcycle(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One cycle from the global ``x`` and ``b``; the global result on
        every rank (``x`` is not modified).  On the card it replays the
        recorded cycle (:class:`~cedar_tpu_torch.solver.graph.
        CycleGraphs`)."""
        xb, bb = self._block(x), self._block(b)
        with backend.using(self.settings.kernel_backend):
            if bb.is_cuda:
                xb = self.graphs.vcycle(xb, bb)
            else:
                xb = self._cycle_module().run_cycle(
                    self.levels, self.kinds, xb, bb, self.settings,
                    self.periodic, dist=self.dist)
        return self._unpad_func(self.dist.gather(xb))

    def solve(self, b: torch.Tensor, x0: torch.Tensor | None = None):
        """Iterate cycles on the global ``b`` until the relative residual
        drops below ``tol`` or ``max-iter`` cycles ran; returns the global x
        on every rank (``x0`` is not modified).  ``history`` holds the
        relative norms.  On the card each cycle is one replay of the
        recorded iteration (:class:`~cedar_tpu_torch.solver.graph.
        CycleGraphs`), on the CPU the same iteration runs eagerly."""
        cyc, settings, dist = self._cycle_module(), self.settings, self.dist
        bb = self._block(b)
        x = torch.zeros_like(bb) if x0 is None else self._block(x0)
        self.timelog.begin("solve")
        r0 = dist.residual(0, self.kinds[0], x, bb)
        res0 = max(float(dist.norm(r0)), torch.finfo(bb.dtype).tiny)
        with backend.using(settings.kernel_backend):
            if bb.is_cuda:
                x, hist = self.graphs.solve(x, bb, res0)
            else:
                def step():
                    nonlocal x
                    x, rnorm = cyc.cycle_residual(self.levels, self.kinds, x,
                                                  bb, settings, self.periodic,
                                                  dist=dist)
                    return rnorm

                hist = graph.iterate(step, res0, settings)
        self.timelog.end("solve", force=x)
        log.info(f"Initial residual l2 norm: {res0:g}")
        for i, rel in enumerate(hist):
            log.status(f"Iteration {i} relative l2 norm: {rel:g}")
        self.history = hist
        self.res0 = res0
        return self._unpad_func(dist.gather(x))

    def save_timings(self, fname: str = "timings.json"):
        self.timelog.save(fname)

    @property
    def coarse_shape(self):
        return self.shapes[-1]


class DistSolver2(_DistSolver):
    """2D BoxMG block-partitioned over a 2-axis process mesh
    (:func:`cedar_tpu_torch.parallel.make_mesh`); point and line
    relaxation, periodic axes."""

    _ndim = 2

    def __init__(self, so, kind=StencilKind.five_pt, conf=None, mesh=None):
        super().__init__(so, kind, conf, mesh)

    @staticmethod
    def _solver_module():
        from cedar_tpu_torch.solver import solver2
        return solver2

    @staticmethod
    def _cycle_module():
        from cedar_tpu_torch.solver import cycle2
        return cycle2


class DistSolver3(_DistSolver):
    """3D BoxMG block-partitioned over a 3-axis process mesh; point and
    plane relaxation, periodic axes."""

    _ndim = 3

    def __init__(self, so, kind=StencilKind.seven_pt, conf=None, mesh=None):
        super().__init__(so, kind, conf, mesh)

    @staticmethod
    def _solver_module():
        from cedar_tpu_torch.solver import solver3
        return solver3

    @staticmethod
    def _cycle_module():
        from cedar_tpu_torch.solver import cycle3
        return cycle3
