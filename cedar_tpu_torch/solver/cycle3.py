"""3D V-, W- and F-cycles over a level hierarchy, point and plane relaxation.

PyTorch counterpart of :mod:`cedar_tpu.solver.cycle3` (reference:
include/cedar/cycle/vcycle.h:44-115,
include/cedar/cycle/fcycle.h:49-84).  The recursion runs eagerly in Python;
every sweep, restriction and interpolation dispatches by device inside the
ops (CUDA kernels on the card, torch ops on the CPU).  Plane relaxation
(:mod:`cedar_tpu_torch.ops.planes3`) smooths with batched embedded 2D
cycles.

The last pre-sweep of each level emits the residual that feeds the
restriction, and with ``fuse_final_residual`` the last post-sweep of the
top level emits the convergence residual, as the Pallas path does.

Point sweeps return a new iterate, interpolation updates it in place:
``ncycle`` and the dense ``run_cycle`` may overwrite the ``x`` they are
given (with no pre-sweep, or with plane relaxation).

The fused fine-level V-cycle (:func:`ncycle_split`, the counterpart of the
JAX package's split-resident cycle and its wavefront kernels, under
``kernels.fine-split`` on the top ``kernels.split-levels`` levels) runs
each level's last pre-sweep, residual and restriction as one op and its
interp-add and first post-sweep as another
(:mod:`cedar_tpu_torch.ops.fused3`: kernels K15 and K16 on the card, K14
for the other sweeps); the last post-sweep of the top level emits the
convergence norm as partial sums.  It keeps the dense layout.  Its ops
work OUT of place: each returns a new iterate and ``ncycle_split`` hands
the buffers on.  The ``q`` that the fused pre-sweep returns is the
``q_pre`` from which the fused interp-add recomputes the restricted
residual, the cycle's invariant, so the ``x`` it is given is never
written.

The coarsest level solves by LU (``ainv``) or, under ``cg-solver:
cedar``, by the inner multigrid solve over its ``inner`` hierarchy (27-point
levels, point relaxation; :func:`coarse_solve`,
:mod:`cedar_tpu_torch.solver.inner`), in every cycle, the fused one
included.

``periodic`` (``grid.periodic``) goes to every sweep, residual, transfer
and plane relaxation of the dense cycle.  The fused cycle stays off on
periodic grids (:func:`fine_split_ok`), as in the JAX package, which
sends every periodic case to its dense path (cedar_tpu/solver/cycle3.py:
24-25) and builds its split workspaces only where no axis is periodic.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cg, planes3
from cedar_tpu_torch.ops.fused3 import (
    interp_sweep_split3, point_relax_split3, sweep_restrict_split3,
)
from cedar_tpu_torch.ops.interp3 import interp, interp_add, restrict
from cedar_tpu_torch.ops.relax3 import point_relax
from cedar_tpu_torch.ops.stencil3 import residual
from cedar_tpu_torch.settings import CycleType, MLSettings, RelaxType
from cedar_tpu_torch.solver import inner
from cedar_tpu_torch.utils.timing import scope


def coarse_solve(lev, b: torch.Tensor, settings: MLSettings,
                 periodic=(False, False, False)) -> torch.Tensor:
    """The coarsest level's solve: the inner multigrid solve where the
    level holds an inner hierarchy (``cg-solver: cedar``; the JAX package's
    ``_coarse_solve_inner``), else the LU solve."""
    if lev.inner is not None:
        return inner.solve(run_cycle, residual, StencilKind.twenty_seven_pt,
                           lev, b, settings, periodic, 3)
    return cg.solve_cg(lev.ainv, b)


def _smooth(lev, kind, x, b, settings: MLSettings, updown: str,
            periodic=(False, False, False)):
    """One smoothing application (reference: multilevel.h:134-223).

    plane-xyz applies xy, yz, xz plane sweeps DOWN and xz, yz, xy UP
    (3d/mpi/solver.h relax_dir dispatch)."""
    rt = settings.relaxation
    if rt == RelaxType.point:
        return point_relax(lev.so, x, b, lev.recip, kind, updown,
                           periodic=periodic)
    if rt in planes3.ORIENTS_OF:
        orients = planes3.ORIENTS_OF[rt]
        if updown == "up":
            orients = orients[::-1]
        for orient in orients:
            x = planes3.plane_relax(lev, kind, x, b, orient, updown,
                                    settings, periodic)
        return x
    raise ValueError(f"invalid 3D relaxation: {rt}")


def _nsmooth(lev, kind, x, b, settings: MLSettings, updown: str,
             nrelax: int, periodic=(False, False, False)):
    """``nrelax`` identical sweeps."""
    for _ in range(nrelax):
        x = _smooth(lev, kind, x, b, settings, updown, periodic)
    return x


def fuse_final_ok(levels, settings: MLSettings) -> bool:
    """Whether the top level's last post-sweep can fuse the convergence
    residual: V-cycle, point relaxation with a post-sweep, two levels or
    more (the JAX package's condition where its sweep kernel runs; the
    port's sweep always takes ``fuse_residual``)."""
    return (
        settings.cycle == CycleType.v
        and settings.relaxation == RelaxType.point
        and settings.nrelax_post >= 1
        and len(levels) >= 2
    )


def ncycle(levels, kinds, lvl: int, x: torch.Tensor, b: torch.Tensor,
           settings: MLSettings, n: int = 1,
           fuse_final_residual: bool = False,
           periodic=(False, False, False)):
    """Recursive n-cycle (n=1: V, n=2: W).  Reference: vcycle.h:57-115.

    With ``fuse_final_residual`` (callers check :func:`fuse_final_ok`)
    returns ``(x, b - A x)``, the residual coming out of the last
    post-sweep."""
    lev, kind = levels[lvl], kinds[lvl]
    pre = settings.nrelax_pre
    if pre >= 1 and settings.relaxation == RelaxType.point:
        # fused final pre-sweep + residual
        with scope("relaxation"):
            x = _nsmooth(lev, kind, x, b, settings, "down", pre - 1,
                         periodic)
        with scope("relaxation-residual-fused"):
            x, res = point_relax(lev.so, x, b, lev.recip, kind, "down",
                                 fuse_residual=True, periodic=periodic)
    else:
        with scope("relaxation"):
            x = _nsmooth(lev, kind, x, b, settings, "down", pre, periodic)
        with scope("residual"):
            res = residual(lev.so, x, b, kind, periodic)

    coarse = levels[lvl + 1]
    with scope("restrict"):
        cb = restrict(coarse.ci, res, periodic)
    if lvl + 1 == len(levels) - 1:
        with scope("coarse-solve"):
            cx = coarse_solve(coarse, cb, settings, periodic)
    else:
        cx = torch.zeros_like(cb)
        for _ in range(n):
            cx = ncycle(levels, kinds, lvl + 1, cx, cb, settings, n,
                        periodic=periodic)

    with scope("interp-add"):
        x = interp_add(coarse.ci, lev.so, cx, res, x, periodic)

    # nonsymmetric relaxation keeps the forward sweep order for
    # post-smoothing (reference: IRELAX_SYM, BMG3_SymStd_relax_GS.f90)
    post = "up" if settings.relax_symmetric else "down"
    nplain = settings.nrelax_post - (1 if fuse_final_residual else 0)
    with scope("relaxation"):
        x = _nsmooth(lev, kind, x, b, settings, post, nplain, periodic)
    if fuse_final_residual:
        with scope("relaxation-residual-fused"):
            return point_relax(lev.so, x, b, lev.recip, kind, post,
                               fuse_residual=True, periodic=periodic)
    return x


def fine_split_ok(levels, settings: MLSettings,
                  periodic=(False, False, False)) -> bool:
    """Whether the solve runs the fused fine-level cycle
    (:func:`ncycle_split`): ``kernels.fine-split``, no periodic axis, a
    V-cycle, point relaxation with at least one pre- and one post-sweep,
    two levels or more (cedar_tpu/solver/cycle3.py:124-139, whose split
    workspaces are gated on the same settings and built only where no axis
    is periodic, cedar_tpu/solver/solver3.py:95)."""
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
    point relaxation, and not the coarsest (cedar_tpu/solver/cycle3.py:141
    and the gate of its split workspaces, solver3.py:234-236)."""
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
    (cedar_tpu/solver/cycle3.py:152-251, in the dense layout).

    The fused last pre-sweep forms the coarse rhs from its residual, which
    is never stored: the fused interp-add recomputes it from the
    pre-smoothed iterate and runs the first post-sweep.  The next level
    runs fused too where :func:`_split_ok_at` allows, else the dense
    :func:`ncycle`; the coarse solve is :func:`coarse_solve`.  Returns ``(x,
    None)``, or with ``fuse_final_residual`` ``(x, partials)``: partial
    sums of the squared residual of the last post-sweep, whose sum is
    ``‖b - A x‖²``.  ``x`` is not modified.  Callers check
    :func:`fine_split_ok` (a post-sweep is required)."""
    lev, kind = levels[lvl], kinds[lvl]
    with scope("relaxation"):
        for _ in range(settings.nrelax_pre - 1):
            x = point_relax_split3(lev.so, x, b, kind, "down")
    coarse = levels[lvl + 1]
    with scope("relaxation-residual-restrict-fused"):
        x, _, cb = sweep_restrict_split3(lev.so, x, b, coarse.ci, kind,
                                         "down", emit_res=False)

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
    fuse_here = fuse_final_residual and settings.nrelax_post == 1
    with scope("interp-add-relax-fused"):
        out = interp_sweep_split3(coarse.ci, cx, lev.so, b, x, kind, post,
                                  fuse_norm=fuse_here)
    if fuse_here:
        return out
    x = out
    n_plain = settings.nrelax_post - 1 - (1 if fuse_final_residual else 0)
    with scope("relaxation"):
        for _ in range(n_plain):
            x = point_relax_split3(lev.so, x, b, kind, post)
    if fuse_final_residual:
        with scope("relaxation-residual-fused"):
            return point_relax_split3(lev.so, x, b, kind, post,
                                      fuse_norm=True)
    return x, None


def fmg_cycle(levels, kinds, lvl: int, b: torch.Tensor,
              settings: MLSettings,
              periodic=(False, False, False)) -> torch.Tensor:
    """Full multigrid cycle (reference: fcycle.h:49-84); returns a new x.

    Restricts ``b`` down to the coarsest level, solves there, then on each
    level interpolates the coarse solution up (``x = P cx``, no residual
    and no addend) and runs one V-cycle from it, fused where
    :func:`_split_ok_at` allows (cedar_tpu/solver/cycle3.py:378-424).
    Like the JAX package, it starts from ``b`` alone: an incoming iterate
    plays no part."""
    lev = levels[lvl]
    if lvl == len(levels) - 1:
        with scope("coarse-solve"):
            return coarse_solve(lev, b, settings, periodic)
    coarse = levels[lvl + 1]
    with scope("restrict"):
        cb = restrict(coarse.ci, b, periodic)
    cx = fmg_cycle(levels, kinds, lvl + 1, cb, settings, periodic)
    with scope("interp"):
        x = interp(coarse.ci, cx, b.shape, periodic)
    split_here = (not any(periodic) and _split_ok_at(levels, lvl, settings)
                  and settings.nrelax_pre >= 1 and settings.nrelax_post >= 1)
    if split_here:
        return ncycle_split(levels, kinds, x, b, settings, lvl=lvl)[0]
    return ncycle(levels, kinds, lvl, x, b, settings, periodic=periodic)


def run_cycle(levels, kinds, x: torch.Tensor, b: torch.Tensor,
              settings: MLSettings, periodic=(False, False, False)):
    """One cycle of the configured type (reference: multilevel.h:289-296);
    returns the new iterate.  The dense V-cycle may overwrite ``x``, the
    fused one (:func:`fine_split_ok`) leaves it, an F-cycle ignores it."""
    if len(levels) == 1:
        return coarse_solve(levels[0], b, settings, periodic)
    if settings.cycle == CycleType.f:
        return fmg_cycle(levels, kinds, 0, b, settings, periodic)
    if fine_split_ok(levels, settings, periodic):
        return ncycle_split(levels, kinds, x, b, settings)[0]
    return ncycle(levels, kinds, 0, x, b, settings, periodic=periodic)


def cycle_residual(levels, kinds, x: torch.Tensor, b: torch.Tensor,
                   settings: MLSettings, periodic=(False, False, False)):
    """One iteration of the solve loop: the cycle, then ``‖b - A x‖₂`` on
    the finest level.  Returns ``(x, norm)``, the norm a 0-d tensor (no
    readback).

    The fused cycle (:func:`fine_split_ok`) takes the norm from the partial
    sums of its last post-sweep, as the JAX solve loop does
    (cedar_tpu/solver/solver3.py:316-347); otherwise the residual comes out
    of the last post-sweep where :func:`fuse_final_ok` allows (the JAX
    solve loop's rule, solver3.py:349-375), or after the cycle."""
    if fine_split_ok(levels, settings, periodic):
        x, partials = ncycle_split(levels, kinds, x, b, settings,
                                   fuse_final_residual=True)
        return x, torch.sqrt(torch.sum(partials))
    if fuse_final_ok(levels, settings):
        x, r = ncycle(levels, kinds, 0, x, b, settings,
                      fuse_final_residual=True, periodic=periodic)
    else:
        x = run_cycle(levels, kinds, x, b, settings, periodic)
        r = residual(levels[0].so, x, b, kinds[0], periodic)
    return x, torch.sqrt(torch.sum(r * r))
