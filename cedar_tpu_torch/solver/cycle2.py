"""2D V- and W-cycles over a level hierarchy, point relaxation.

PyTorch counterpart of the dense path of :mod:`cedar_tpu.solver.cycle2`
(reference: include/cedar/cycle/vcycle.h:44-115).  The recursion runs
eagerly in Python; every sweep, restriction and interpolation dispatches by
device inside the ops (CUDA kernels on the card, torch ops on the CPU).

The last pre-sweep of each level emits the residual that feeds the
restriction, and with ``fuse_final_residual`` the last post-sweep of the
top level emits the convergence residual, as the Pallas path does.

Sweeps and interpolation update the iterate in place: ``ncycle`` and
``run_cycle`` overwrite the ``x`` they are given.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.ops import cg
from cedar_tpu_torch.ops.interp2 import interp_add, restrict
from cedar_tpu_torch.ops.relax2 import point_relax
from cedar_tpu_torch.ops.stencil2 import residual
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.utils.timing import scope


def ncycle(levels, kinds, lvl: int, x: torch.Tensor, b: torch.Tensor,
           settings: MLSettings, n: int = 1,
           fuse_final_residual: bool = False):
    """Recursive n-cycle (n=1: V, n=2: W).  Reference: vcycle.h:57-115.

    With ``fuse_final_residual`` (needs ``nrelax-post >= 1``) returns
    ``(x, b - A x)``, the residual coming out of the last post-sweep."""
    lev, kind = levels[lvl], kinds[lvl]
    pre = settings.nrelax_pre
    if pre >= 1:
        with scope("relaxation"):
            for _ in range(pre - 1):
                x = point_relax(lev.so, x, b, lev.recip, kind, "down")
        with scope("relaxation-residual-fused"):
            x, res = point_relax(lev.so, x, b, lev.recip, kind, "down",
                                 fuse_residual=True)
    else:
        with scope("residual"):
            res = residual(lev.so, x, b, kind)

    coarse = levels[lvl + 1]
    with scope("restrict"):
        cb = restrict(coarse.ci, res)
    if lvl + 1 == len(levels) - 1:
        with scope("coarse-solve"):
            cx = cg.solve_cg(coarse.ainv, cb)
    else:
        cx = torch.zeros_like(cb)
        for _ in range(n):
            cx = ncycle(levels, kinds, lvl + 1, cx, cb, settings, n)

    with scope("interp-add"):
        x = interp_add(coarse.ci, lev.so, cx, res, x)

    # nonsymmetric relaxation (solver.relax-symmetric false) keeps the
    # forward sweep order for post-smoothing (BMG2_SymStd_relax_GS.f90:78-87)
    post = "up" if settings.relax_symmetric else "down"
    nplain = settings.nrelax_post - (1 if fuse_final_residual else 0)
    with scope("relaxation"):
        for _ in range(nplain):
            x = point_relax(lev.so, x, b, lev.recip, kind, post)
    if fuse_final_residual:
        with scope("relaxation-residual-fused"):
            return point_relax(lev.so, x, b, lev.recip, kind, post,
                               fuse_residual=True)
    return x


def run_cycle(levels, kinds, x: torch.Tensor, b: torch.Tensor,
              settings: MLSettings):
    """One V-cycle (reference: multilevel.h:289-296); overwrites ``x``."""
    if len(levels) == 1:
        return cg.solve_cg(levels[0].ainv, b)
    return ncycle(levels, kinds, 0, x, b, settings)
