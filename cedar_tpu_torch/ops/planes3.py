"""3D plane relaxation: zebra planes smoothed by embedded 2D BoxMG cycles.

PyTorch counterpart of :mod:`cedar_tpu.ops.planes3` (reference:
include/cedar/3d/relax_planes.h:36-246, src/3d/relax_planes.cc).  The
reference relaxes the planes of one zebra colour one after another, each
with its own 2D solver (configured by ``plane-config``, default one
V(2,1) cycle of line-xy relaxation, src/kernel_params.cc:72-78).  The
planes of a colour are independent, so here they run as ONE batched 2D
cycle over a batched 2D hierarchy (:mod:`cedar_tpu_torch.solver.cycle2`
on levels holding ``(ndir, B, n1, n2)`` stencils), the V- or F-cycle of
``plane-config`` with its relaxation (point, line-x, line-y or line-xy)
and its coarse solve (LU, or the inner multigrid solve of ``cg-solver:
cedar``, batched too, each plane stopping on its own convergence): on the
card each smooth of the whole batch is one launch (K1 a point sweep; K10
all pre- or post-smooths of line-xy, and of line-x or line-y in its
one-direction mode), each transfer one launch of K2, K3 or K5 (the
F-cycle's interpolation).

Plane 2D operators are the in-plane couplings with the full 3D diagonal
(copy_coeff, relax_planes.h:77-161):

* xy: c=p,  w=pw, s=ps, sw=psw, nw=pnw    (plane axis 2)
* xz: c=p,  w=pw, s=b,  sw=bw,  nw=be     (plane axis 1)
* yz: c=p,  w=ps, s=b,  sw=bs,  nw=bn     (plane axis 0)

The per-plane rhs adds the out-of-plane couplings at current values
(copy_rhs, src/3d/relax_planes.cc:25-120).  Zebra order of the planes:
DOWN relaxes planes of odd 1-based index first (0-based parity 0), UP the
reverse (relax_planes.h:44-52) — the opposite of the line zebra inside a
plane (:func:`cedar_tpu_torch.ops.lines2.colour_order`).

As in the JAX package, each plane gets its own coefficient slice (the
reference builds every plane solver from the last slice's coefficients,
relax_planes.h:85-92; the two agree whenever the operator is
plane-invariant).  Each colour's planes are gathered into one contiguous
batch at setup (its own hierarchy) and at every relaxation (the iterate and
the rhs), so the kernels never see a strided view.

On periodic grids only the out-of-plane couplings wrap
(:func:`out_of_plane_apply` with ``periodic``): the embedded 2D hierarchies
and cycles are non-periodic, as the JAX package builds them
(cedar_tpu/ops/planes3.py:131-176), so a periodic axis inside the planes is
not wrapped by the plane solves.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.shift import shift3
from cedar_tpu_torch.core.types import Dir3, StencilKind
from cedar_tpu_torch.ops import backend
from cedar_tpu_torch.ops.stencil3 import coupling, offsets_for
from cedar_tpu_torch.settings import MLSettings, RelaxType

# orientation -> (plane axis in the 3D array, 7-pt dirs, 27-pt extra dirs)
PLANE_SPECS = {
    "xy": (2, [Dir3.P, Dir3.PW, Dir3.PS], [Dir3.PSW, Dir3.PNW]),
    "xz": (1, [Dir3.P, Dir3.PW, Dir3.B], [Dir3.BW, Dir3.BE]),
    "yz": (0, [Dir3.P, Dir3.PS, Dir3.B], [Dir3.BS, Dir3.BN]),
}

#: the relaxations of the embedded plane solvers
PLANE_RELAX = (RelaxType.point, RelaxType.line_x, RelaxType.line_y,
               RelaxType.line_xy)

ORIENTS_OF = {
    RelaxType.plane_xy: ("xy",),
    RelaxType.plane_xz: ("xz",),
    RelaxType.plane_yz: ("yz",),
    RelaxType.plane_xyz: ("xy", "yz", "xz"),
}


def plane_kind2(kind3: StencilKind) -> StencilKind:
    return (StencilKind.five_pt if kind3 == StencilKind.seven_pt
            else StencilKind.nine_pt)


def slice_so(so3: torch.Tensor, kind3: StencilKind,
             orient: str) -> torch.Tensor:
    """Batched 2D plane operators ``(ndir2, nplanes, n1, n2)``: the batch
    axis after the direction axis (the JAX package's ``(nplanes, ndir2,
    n1, n2)`` with its first two axes swapped)."""
    axis, base, extra = PLANE_SPECS[orient]
    dirs = base + (extra if kind3 == StencilKind.twenty_seven_pt else [])
    return so3[dirs].movedim(axis + 1, 1)


def out_of_plane_apply(so3: torch.Tensor, q: torch.Tensor,
                       kind3: StencilKind, axis: int,
                       periodic=(False, False, False)) -> torch.Tensor:
    """Σ couplings with a nonzero offset along ``axis`` × neighbour
    values, in :func:`~cedar_tpu_torch.ops.stencil3.offsets_for` order;
    the shifts wrap around the ``periodic`` axes."""
    acc = None
    for off in offsets_for(kind3):
        if off[axis] == 0:
            continue
        term = (coupling(so3, off, periodic)
                * shift3(q, *off, periodic=periodic))
        acc = term if acc is None else acc + term
    return acc


def _colour_planes(a: torch.Tensor, axis: int, c: int) -> torch.Tensor:
    """The planes ``c::2`` along ``axis`` of a 3D array, as a strided
    ``(B, n1, n2)`` view."""
    return a.movedim(axis, 0)[c::2]


def setup_planes(levels, kinds, settings: MLSettings) -> tuple:
    """Attach the batched 2D plane hierarchies to every non-coarsest level:
    per orientation, one hierarchy per zebra colour over that colour's
    planes, each built from its own coefficient slices with
    ``compute_num_levels(n1, n2, plane min-coarse)`` levels from the plane
    settings (the relaxation's workspace: 1/diag for point relaxation, the
    line factors on the CPU; an inner hierarchy under ``cg-solver:
    cedar``), as the JAX package's ``setup_planes`` does."""
    from cedar_tpu_torch.solver import solver2

    psettings = settings.plane_settings
    new_levels = []
    for lvl, (lev, kind3) in enumerate(zip(levels, kinds)):
        if lvl == len(levels) - 1:
            new_levels.append(lev)
            continue
        planes = {}
        for orient in ORIENTS_OF[settings.relaxation]:
            so2 = slice_so(lev.so, kind3, orient)
            n1, n2 = so2.shape[-2:]
            nlev2 = solver2.compute_num_levels(n1, n2, psettings.min_coarse)
            planes[orient] = tuple(
                solver2.setup_hierarchy(so2[:, c::2], plane_kind2(kind3),
                                        nlev2, psettings)
                if so2.shape[1] > c else None
                for c in (0, 1)
            )
        new_levels.append(lev._replace(planes=planes))
    return tuple(new_levels)


def plane_relax(lev, kind3: StencilKind, x: torch.Tensor, b: torch.Tensor,
                orient: str, updown: str, settings: MLSettings,
                periodic=(False, False, False)):
    """One zebra plane-relaxation sweep (both colours), IN PLACE on ``x``;
    returns ``x``.

    Per colour: the rhs b + out-of-plane couplings at the current values;
    that colour's planes of ``x`` and of the rhs gathered into contiguous
    ``(B, n1, n2)`` tensors; ``max(1, plane max-iter)`` embedded cycles
    from the current plane values; the planes written back.  Only the
    out-of-plane couplings wrap around the ``periodic`` axes."""
    from cedar_tpu_torch.solver import cycle2

    axis = PLANE_SPECS[orient][0]
    psettings = settings.plane_settings
    reps = max(1, psettings.maxiter)
    for c in ((0, 1) if updown == "down" else (1, 0)):
        hier = lev.planes[orient][c]
        if hier is None:
            continue
        kinds2 = [plane_kind2(kind3)] + [StencilKind.nine_pt] * (len(hier) - 1)
        rhs = b + out_of_plane_apply(lev.so, x, kind3, axis, periodic)
        b2 = _colour_planes(rhs, axis, c).contiguous()
        # the embedded cycle updates its iterate in place: a gathered copy
        x2 = _colour_planes(x, axis, c).clone(
            memory_format=torch.contiguous_format)
        # a plane-config that pins kernels.backend holds for its solves
        with backend.using(psettings.kernel_backend):
            for _ in range(reps):
                x2 = cycle2.run_cycle(hier, kinds2, x2, b2, psettings)
        _colour_planes(x, axis, c).copy_(x2)
    return x
