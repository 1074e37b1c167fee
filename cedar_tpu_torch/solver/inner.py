"""The inner multigrid coarse solve (``cg-solver: cedar``), 2D and 3D.

PyTorch counterpart of ``_coarse_solve_inner`` of the JAX package
(cedar_tpu/solver/cycle2.py:140-167, cycle3.py:94-121; reference:
setup_cg_solve, include/cedar/2d/mpi/solver.h:97-139): on the coarsest
grid the nested solver, configured by ``cg-config``, iterates its own
cycles from ``x = 0`` on ``A x = cb`` while ``i < max-iter and rel >=
tol``, ``rel = ‖cb − A x‖ / max(‖cb‖, 1e-300)`` (the floor in the
operand's dtype: 0 in float32, as in JAX; ``rel`` starts at ``inf``).

The JAX loop is a ``lax.while_loop`` that stops on the data.  Here it is a
loop of ``max-iter`` steps, a count known at setup, whose tests and updates
all stay on the device, so that the solve's captured cycle
(:mod:`cedar_tpu_torch.solver.graph`) holds it whole and reads nothing
back::

    active = rel >= tol                 # False on NaN: a NaN rel stops
    x_new  = cycle(x.clone())           # the dense cycle updates in place
    rel_new = ‖cb − A x_new‖ / r0
    x   = where(active, x_new, x)
    rel = where(active, rel_new, rel)

The steps after convergence are computed and discarded, so the result is
the JAX loop's, at the cost of ``max-iter`` inner cycles every time.  On a
batch of planes (plane relaxation's embedded solvers, ``cb`` ``(B, n1,
n2)``) ``r0``, ``rel`` and ``active`` are per plane, ``(B, 1, 1)``: each
plane stops on its own convergence, as ``vmap`` of the JAX loop gives.
The inner hierarchy's own coarsest level may hold an inner hierarchy
again (nested ``cg-config``), to ``MLSettings.MAX_NEST``.  On the CPU the
same loop runs eagerly.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.ops import backend
from cedar_tpu_torch.settings import MLSettings

#: where a list, each step appends its ``active`` mask (a device tensor,
#: no readback) to it: the count of the steps that were not discarded
#: (chip_smoke.py reads it from an eager cycle).  None in a solve.
record_active: list | None = None


def solve(run_cycle, residual, kind, coarse, cb: torch.Tensor,
          settings: MLSettings, periodic, ndim: int) -> torch.Tensor:
    """``x`` of ``A x = cb`` on ``coarse`` (a coarsest level holding
    ``inner``) by ``settings.cg_settings``' tol/max-iter iteration of
    ``run_cycle`` (the cycle module's) over the inner hierarchy, every
    level of stencil kind ``kind`` (``residual`` the stencil module's);
    the last ``ndim`` axes of ``cb`` are the grid."""
    inner, ist = coarse.inner, settings.cg_settings
    kinds = [kind] * len(inner)
    dims = tuple(range(-ndim, 0))

    def norm(a):
        return torch.sqrt(torch.sum(a * a, dim=dims, keepdim=True))

    r0 = torch.maximum(norm(cb), cb.new_full((), 1e-300))
    x = torch.zeros_like(cb)
    rel = torch.full_like(r0, float("inf"))
    # a cg-config that pins kernels.backend holds for the inner cycles
    with backend.using(ist.kernel_backend):
        for _ in range(ist.maxiter):
            active = rel >= ist.tol
            if record_active is not None:
                record_active.append(active)
            x_new = run_cycle(inner, kinds, x.clone(), cb, ist, periodic)
            rel_new = norm(residual(inner[0].so, x_new, cb, kinds[0],
                                    periodic)) / r0
            x = torch.where(active, x_new, x)
            rel = torch.where(active, rel_new, rel)
    return x
