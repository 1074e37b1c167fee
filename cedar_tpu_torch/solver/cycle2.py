"""2D V-, W- and F-cycles over a level hierarchy; point and line relaxation.

PyTorch counterpart of the dense path of :mod:`cedar_tpu.solver.cycle2`
(reference: include/cedar/cycle/vcycle.h:44-115,
include/cedar/cycle/fcycle.h:49-84).  The recursion runs eagerly in Python;
every sweep, restriction and interpolation dispatches by device inside the
ops (CUDA kernels on the card, torch ops on the CPU).

With point relaxation the last pre-sweep of each level emits the residual
that feeds the restriction, and with ``fuse_final_residual`` the last
post-sweep of the top level emits the convergence residual, as the Pallas
path does; line relaxation computes each residual separately.

A hierarchy whose levels hold a batch of planes (3D plane relaxation's
embedded cycles: ``so`` ``(ndir, B, nx, ny)``, ``x`` ``(B, nx, ny)``) runs
the same dense V- or F-cycle over the batch (:func:`_batched_smooth`):
point relaxation by the batched sweep (kernel K1, one launch a sweep of
every plane; the last pre-sweep emits the residual), line-x, line-y and
line-xy through :mod:`cedar_tpu_torch.ops.planes2` (kernel K10, in its
one-direction mode for line-x and line-y): all pre-smooths and the
residual that feeds the restriction in one call, as the JAX package does
under ``_line_fused_ok``, and all post-smooths in another.  The F-cycle's
level entry is the batched interpolation (K5).

The coarsest level solves by LU (``ainv``) or, under ``cg-solver:
cedar``, by the inner multigrid solve over its ``inner`` hierarchy
(:func:`coarse_solve`, :mod:`cedar_tpu_torch.solver.inner`: a masked loop
of ``max-iter`` inner cycles that the captured cycle holds whole), batched
planes included.

Each op returns the new iterate and the cycles rebind it.  Interpolation
and line smoothing update the iterate in place (a point sweep does not):
so ``ncycle`` and the dense ``run_cycle`` may overwrite the ``x`` they
are given, and their callers clone it first.

The fused fine-level V-cycle (:func:`ncycle_split`, the counterpart of the
JAX package's split-resident cycle, under ``kernels.fine-split`` on the
top ``kernels.split-levels`` levels) runs each level's last pre-sweep,
residual and restriction as one op and its interp-add and first
post-sweep as another (:mod:`cedar_tpu_torch.ops.fused2`: kernels K12 and
K13 on the card, K11 for the other sweeps); the last post-sweep of the
top level emits the convergence norm as partial sums.  It keeps the dense
layout.  Its ops work OUT of place: each returns a new iterate and
``ncycle_split`` hands the buffers on.  The ``q`` that the fused
pre-sweep returns is the ``q_pre`` from which the fused interp-add
recomputes the restricted residual, the cycle's invariant
(cedar_tpu/ops/pallas_transfer2.py:555-569), so the ``x`` it is given is
never written.

``periodic`` (``grid.periodic``) goes to every sweep, residual and
transfer of the dense cycle.  The fused cycle stays off on periodic grids
(:func:`fine_split_ok`), as in the JAX package, whose split workspaces are
built only where no axis is periodic.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cg, planes2
from cedar_tpu_torch.ops.fused2 import (
    interp_add_split, interp_sweep_split, point_relax_split,
    sweep_restrict_split,
)
from cedar_tpu_torch.ops.interp2 import interp, interp_add, restrict
from cedar_tpu_torch.ops.lines2 import line_relax_x, line_relax_y
from cedar_tpu_torch.ops.relax2 import point_relax
from cedar_tpu_torch.ops.stencil2 import residual
from cedar_tpu_torch.settings import CycleType, MLSettings, RelaxType
from cedar_tpu_torch.solver import inner
from cedar_tpu_torch.utils.timing import scope

# relaxation -> the line axes of a batched line smooth
_LINE_AXES = {RelaxType.line_x: "x", RelaxType.line_y: "y",
              RelaxType.line_xy: "xy"}


def coarse_solve(lev, b: torch.Tensor, settings: MLSettings,
                 periodic=(False, False)) -> torch.Tensor:
    """The coarsest level's solve: the inner multigrid solve where the
    level holds an inner hierarchy (``cg-solver: cedar``; the JAX package's
    ``_coarse_solve_inner``), else the LU solve."""
    if lev.inner is not None:
        return inner.solve(run_cycle, residual, StencilKind.nine_pt, lev, b,
                           settings, periodic, 2)
    return cg.solve_cg(lev.ainv, b)


def _relax(lev, kind, x, b, updown: str, periodic, dist=None, lvl=0,
           fuse_residual: bool = False):
    """One point sweep of level ``lvl``: the serial sweep, or under a mesh
    (``dist``, :class:`cedar_tpu_torch.parallel.halo.DistContext`) the
    sweep of this rank's block."""
    if dist is not None:
        return dist.relax(lvl, kind, x, b, updown, fuse_residual)
    return point_relax(lev.so, x, b, lev.recip, kind, updown,
                       fuse_residual=fuse_residual, periodic=periodic)


def _residual(lev, kind, x, b, periodic, dist=None, lvl=0):
    if dist is not None:
        return dist.residual(lvl, kind, x, b)
    return residual(lev.so, x, b, kind, periodic)


def _norm(r, dist=None):
    if dist is not None:
        return dist.norm(r)
    return torch.sqrt(torch.sum(r * r))


def _smooth(lev, kind, x, b, settings: MLSettings, updown: str,
            periodic=(False, False), dist=None, lvl=0):
    """One smoothing application (reference: multilevel.h:134-223).

    line-xy applies line-x then line-y DOWN (pre-smoothing) and line-y then
    line-x UP (symmetric post-smoothing).  ``solver.ml-relax.enabled``
    solves the lines by the full-length PCR (cedar_tpu/solver/
    cycle2.py:76-110 selects ``_pcr_solve`` under it).  Under a mesh
    (``dist``) the sweeps are the block's
    (:meth:`~cedar_tpu_torch.parallel.halo.DistContext.relax` and
    ``line_relax``)."""
    rt = settings.relaxation
    if rt == RelaxType.point:
        return _relax(lev, kind, x, b, updown, periodic, dist, lvl)
    full = settings.ml_relax_enabled

    def lx(x):
        if dist is not None:
            return dist.line_relax(lvl, "x", kind, x, b, updown, full)
        return line_relax_x(lev.so, x, b, lev.sor_x, kind, updown, periodic,
                            full)

    def ly(x):
        if dist is not None:
            return dist.line_relax(lvl, "y", kind, x, b, updown, full)
        return line_relax_y(lev.so, x, b, lev.sor_y, kind, updown, periodic,
                            full)

    if rt == RelaxType.line_x:
        return lx(x)
    if rt == RelaxType.line_y:
        return ly(x)
    if rt == RelaxType.line_xy:
        return ly(lx(x)) if updown == "down" else lx(ly(x))
    raise ValueError(f"invalid 2D relaxation: {rt}")


def _batched_smooth(lev, kind, x, b, settings: MLSettings, updown: str,
                    nsweeps: int, emit_res: bool = False):
    """``nsweeps`` smooths of a batch of planes, then, with ``emit_res``,
    the residual ``b - A x`` (returns ``(x, res)``): point relaxation by
    the batched sweep, the last one emitting the residual (with no sweep
    the residual alone); line-x, line-y and line-xy in one
    :func:`~cedar_tpu_torch.ops.planes2.line_nsmooth` call, in place."""
    rt = settings.relaxation
    if rt == RelaxType.point:
        res = None
        for k in range(nsweeps):
            if emit_res and k == nsweeps - 1:
                x, res = point_relax(lev.so, x, b, lev.recip, kind, updown,
                                     fuse_residual=True)
            else:
                x = point_relax(lev.so, x, b, lev.recip, kind, updown)
        if not emit_res:
            return x
        return x, residual(lev.so, x, b, kind) if res is None else res
    if rt not in _LINE_AXES:
        raise ValueError(f"invalid relaxation of a batch of planes: "
                         f"{rt.value}")
    return planes2.line_nsmooth(lev.so, x, b, kind, updown, nsweeps,
                                _LINE_AXES[rt], emit_res, lev.sor_x,
                                lev.sor_y, settings.ml_relax_enabled)


def fuse_final_ok(levels, settings: MLSettings) -> bool:
    """Whether the top level's last post-sweep can fuse the convergence
    residual: V-cycle, point relaxation with a post-sweep, two levels or
    more (the JAX package's condition; the port's sweep always takes
    ``fuse_residual``)."""
    return (
        settings.cycle == CycleType.v
        and settings.relaxation == RelaxType.point
        and settings.nrelax_post >= 1
        and len(levels) >= 2
    )


def ncycle(levels, kinds, lvl: int, x: torch.Tensor, b: torch.Tensor,
           settings: MLSettings, n: int = 1,
           fuse_final_residual: bool = False, periodic=(False, False),
           dist=None):
    """Recursive n-cycle (n=1: V, n=2: W).  Reference: vcycle.h:57-115.

    With ``fuse_final_residual`` (callers check :func:`fuse_final_ok`)
    returns ``(x, b - A x)``, the residual coming out of the last
    post-sweep.  Under a mesh (``dist``, the JAX cycle's ``constraints``)
    every level's arrays are this rank's blocks and the sweeps, residuals
    and transfers are :class:`~cedar_tpu_torch.parallel.halo.DistContext`'s
    (point and line relaxation): the restricted rhs comes back in the next
    level's layout, gathered where it agglomerates, and the interp-add
    reads this rank's part of the coarse correction; the coarsest level is
    replicated."""
    lev, kind = levels[lvl], kinds[lvl]
    pre = settings.nrelax_pre
    if x.ndim == 3:
        # a batch of planes: all pre-smooths + the residual (one call of
        # the line smooth; the point sweeps' last emits it)
        with scope("relaxation-residual-fused"):
            x, res = _batched_smooth(lev, kind, x, b, settings, "down", pre,
                                     emit_res=True)
    elif pre >= 1 and settings.relaxation == RelaxType.point:
        # fused final pre-sweep + residual
        with scope("relaxation"):
            for _ in range(pre - 1):
                x = _relax(lev, kind, x, b, "down", periodic, dist, lvl)
        with scope("relaxation-residual-fused"):
            x, res = _relax(lev, kind, x, b, "down", periodic, dist, lvl,
                            fuse_residual=True)
    else:
        with scope("relaxation"):
            for _ in range(pre):
                x = _smooth(lev, kind, x, b, settings, "down", periodic,
                            dist, lvl)
        with scope("residual"):
            res = _residual(lev, kind, x, b, periodic, dist, lvl)

    coarse = levels[lvl + 1]
    with scope("restrict"):
        cb = (restrict(coarse.ci, res, periodic) if dist is None
              else dist.restrict(lvl, res))
    if lvl + 1 == len(levels) - 1:
        with scope("coarse-solve"):
            cx = coarse_solve(coarse, cb, settings, periodic)
    else:
        cx = torch.zeros_like(cb)
        for _ in range(n):
            cx = ncycle(levels, kinds, lvl + 1, cx, cb, settings, n,
                        periodic=periodic, dist=dist)

    with scope("interp-add"):
        x = (interp_add(coarse.ci, lev.so, cx, res, x, periodic)
             if dist is None else dist.interp_add(lvl, cx, res, x))

    # nonsymmetric relaxation (solver.relax-symmetric false) keeps the
    # forward sweep order for post-smoothing (BMG2_SymStd_relax_GS.f90:78-87)
    post = "up" if settings.relax_symmetric else "down"
    nplain = settings.nrelax_post - (1 if fuse_final_residual else 0)
    with scope("relaxation"):
        if x.ndim == 3:
            x = _batched_smooth(lev, kind, x, b, settings, post, nplain)
        else:
            for _ in range(nplain):
                x = _smooth(lev, kind, x, b, settings, post, periodic,
                            dist, lvl)
    if fuse_final_residual:
        with scope("relaxation-residual-fused"):
            return _relax(lev, kind, x, b, post, periodic, dist, lvl,
                          fuse_residual=True)
    return x


def fine_split_ok(levels, settings: MLSettings,
                  periodic=(False, False)) -> bool:
    """Whether the solve runs the fused fine-level cycle
    (:func:`ncycle_split`): ``kernels.fine-split``, no periodic axis, a
    V-cycle, point relaxation with at least one pre- and one post-sweep,
    two levels or more (cedar_tpu/solver/cycle2.py:170, whose split
    workspaces are gated on the same settings and built only where no axis
    is periodic, cedar_tpu/solver/solver2.py:152-156)."""
    return (
        settings.fine_split
        and not any(periodic)
        and settings.cycle == CycleType.v
        and settings.relaxation == RelaxType.point
        and settings.nrelax_pre >= 1
        and settings.nrelax_post >= 1
        and len(levels) >= 2
    )


def _split_ok_at(levels, lvl: int, settings: MLSettings) -> bool:
    """Whether level ``lvl`` runs fused: one of the top
    ``kernels.split-levels`` (at least 1) under ``kernels.fine-split`` with
    point relaxation, and not the coarsest (cedar_tpu/solver/cycle2.py:188
    and the gate of its split stencil, solver2.py:180-189)."""
    return (
        settings.fine_split
        and settings.relaxation == RelaxType.point
        and lvl < max(settings.split_levels, 1)
        and lvl < len(levels) - 1
    )


def ncycle_split(levels, kinds, x: torch.Tensor, b: torch.Tensor,
                 settings: MLSettings, fuse_final_residual: bool = False,
                 lvl: int = 0):
    """One V-cycle from level ``lvl`` with the fused fine-level ops
    (cedar_tpu/solver/cycle2.py:200-287, in the dense layout).

    The fused last pre-sweep forms the coarse rhs from its residual; the
    residual is stored only when no post-sweep follows to recompute it.
    The next level runs fused too where :func:`_split_ok_at` allows, else
    the dense :func:`ncycle`.  The fused interp-add recomputes the residual
    of the pre-smoothed iterate and runs the first post-sweep.  Returns
    ``(x, None)``, or with ``fuse_final_residual`` ``(x, partials)``:
    partial sums of the squared residual of the last post-sweep, whose sum
    is ``‖b - A x‖²``.  ``x`` is not modified."""
    lev, kind = levels[lvl], kinds[lvl]
    with scope("relaxation"):
        for _ in range(settings.nrelax_pre - 1):
            x = point_relax_split(lev.so, x, b, kind, "down")
    coarse = levels[lvl + 1]
    with scope("relaxation-residual-restrict-fused"):
        x, res, cb = sweep_restrict_split(
            lev.so, x, b, coarse.ci, kind, "down",
            emit_res=settings.nrelax_post < 1)

    if lvl + 1 == len(levels) - 1:
        with scope("coarse-solve"):
            cx = coarse_solve(coarse, cb, settings)
    elif _split_ok_at(levels, lvl + 1, settings):
        cx, _ = ncycle_split(levels, kinds, torch.zeros_like(cb), cb,
                             settings, lvl=lvl + 1)
    else:
        cx = ncycle(levels, kinds, lvl + 1, torch.zeros_like(cb), cb,
                    settings)

    post = "up" if settings.relax_symmetric else "down"
    if settings.nrelax_post >= 1:
        fuse_here = fuse_final_residual and settings.nrelax_post == 1
        with scope("interp-add-relax-fused"):
            out = interp_sweep_split(coarse.ci, cx, lev.so, b, x, kind, post,
                                     fuse_norm=fuse_here)
        if fuse_here:
            return out
        x = out
        n_plain = (settings.nrelax_post - 1
                   - (1 if fuse_final_residual else 0))
        with scope("relaxation"):
            for _ in range(n_plain):
                x = point_relax_split(lev.so, x, b, kind, post)
        if fuse_final_residual:
            with scope("relaxation-residual-fused"):
                return point_relax_split(lev.so, x, b, kind, post,
                                         fuse_norm=True)
        return x, None

    # no post-sweep (fine_split_ok excludes it; mirrored from the JAX cycle)
    with scope("interp-add"):
        x = interp_add_split(coarse.ci, lev.so, cx, res, x)
    return x, None


def fmg_cycle(levels, kinds, lvl: int, b: torch.Tensor,
              settings: MLSettings, periodic=(False, False),
              dist=None) -> torch.Tensor:
    """Full multigrid cycle (reference: fcycle.h:49-84); returns a new x.

    Restricts ``b`` down to the coarsest level, solves there, then on each
    level interpolates the coarse solution up (``x = P cx``, no residual
    and no addend) and runs one V-cycle from it.  Like the JAX package, it
    starts from ``b`` alone: an incoming iterate plays no part.  Under a
    mesh (``dist``) as :func:`ncycle`."""
    lev = levels[lvl]
    if lvl == len(levels) - 1:
        with scope("coarse-solve"):
            return coarse_solve(lev, b, settings, periodic)
    coarse = levels[lvl + 1]
    with scope("restrict"):
        cb = (restrict(coarse.ci, b, periodic) if dist is None
              else dist.restrict(lvl, b))
    cx = fmg_cycle(levels, kinds, lvl + 1, cb, settings, periodic, dist)
    with scope("interp"):
        x = (interp(coarse.ci, cx, b.shape, periodic) if dist is None
             else dist.interp(lvl, cx))
    split_here = (dist is None and not any(periodic)
                  and _split_ok_at(levels, lvl, settings)
                  and settings.nrelax_pre >= 1 and settings.nrelax_post >= 1)
    if split_here:
        return ncycle_split(levels, kinds, x, b, settings, lvl=lvl)[0]
    return ncycle(levels, kinds, lvl, x, b, settings, periodic=periodic,
                  dist=dist)


def run_cycle(levels, kinds, x: torch.Tensor, b: torch.Tensor,
              settings: MLSettings, periodic=(False, False), dist=None):
    """One cycle of the configured type (reference: multilevel.h:289-296);
    returns the new iterate.  The dense V-cycle may overwrite ``x``, the
    fused one (:func:`fine_split_ok`, never under a mesh) leaves it, an
    F-cycle ignores it."""
    if len(levels) == 1:
        return coarse_solve(levels[0], b, settings, periodic)
    if settings.cycle == CycleType.f:
        return fmg_cycle(levels, kinds, 0, b, settings, periodic, dist)
    if dist is None and fine_split_ok(levels, settings, periodic):
        return ncycle_split(levels, kinds, x, b, settings)[0]
    return ncycle(levels, kinds, 0, x, b, settings, periodic=periodic,
                  dist=dist)


def cycle_residual(levels, kinds, x: torch.Tensor, b: torch.Tensor,
                   settings: MLSettings, periodic=(False, False), dist=None):
    """One iteration of the solve loop: the cycle, then ``‖b - A x‖₂`` on
    the finest level.  Returns ``(x, norm)``, the norm a 0-d tensor (no
    readback).

    The fused cycle (:func:`fine_split_ok`) takes the norm from the partial
    sums of its last post-sweep, as the JAX solve loop does
    (cedar_tpu/solver/solver2.py:334-365); otherwise the residual comes out
    of the last post-sweep where :func:`fuse_final_ok` allows
    (cedar_tpu/solver/solver2.py:370-394), or after the cycle.  Under a
    mesh (``dist``) the norm adds this rank's partial sum to the others'
    (one all-reduce)."""
    if dist is None and fine_split_ok(levels, settings, periodic):
        x, partials = ncycle_split(levels, kinds, x, b, settings,
                                   fuse_final_residual=True)
        return x, torch.sqrt(torch.sum(partials))
    if fuse_final_ok(levels, settings):
        x, r = ncycle(levels, kinds, 0, x, b, settings,
                      fuse_final_residual=True, periodic=periodic, dist=dist)
    else:
        x = run_cycle(levels, kinds, x, b, settings, periodic, dist)
        r = _residual(levels[0], kinds[0], x, b, periodic, dist)
    return x, _norm(r, dist)
