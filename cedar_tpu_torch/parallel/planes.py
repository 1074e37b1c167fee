"""Plane relaxation under a mesh, 3D: the gather of whole planes.

PyTorch counterpart of cedar_tpu's distributed plane relaxation
(cedar_tpu/parallel/dist.py:44-132, ``_place_level`` and
``_place_planes``: the batched plane hierarchies sharded, the plane batch
over the out-of-plane mesh axis and the in-plane dims over the in-plane
axes; reference: include/cedar/3d/mpi/relax_planes.h:219-298, the 3D
communicator sliced by out-of-plane coordinate).  Here each rank makes its
planes whole instead and runs the serial batched plane cycle on them.

Per level and orientation (plane axis ``p``: 2 for xy, 1 for xz, 0 for yz,
:data:`cedar_tpu_torch.ops.planes3.PLANE_SPECS`), at setup
(:func:`setup`):

* the rank owns the planes of its block along ``p`` (every plane where
  the level replicates ``p``);
* their stencil is gathered whole in-plane, one all-gather along each
  partitioned in-plane axis, and the batched 2D hierarchies of the rank's
  planes of each zebra colour are set up on it
  (:func:`cedar_tpu_torch.ops.planes3.setup_colours`), or cut from a
  global hierarchy's (:func:`cut_colours`).  Each plane's hierarchy
  depends on that plane alone, so a rank's colour hierarchy is the serial
  one cut to its planes.

Per colour (:func:`relax`, the loop of :func:`cedar_tpu_torch.ops.planes3.
plane_relax`):

1. x extended by one point (the wrap along a periodic axis): along ``p``
   for a 7-point level, along every partitioned axis for a 27-point one,
   whose out-of-plane couplings reach the in-plane diagonals;
2. the rhs ``b + out_of_plane_apply(...)`` on the block;
3. the colour's planes of the rhs and of x stacked and gathered whole
   in-plane: one all-gather (tagged ``"plane"``) along each partitioned
   in-plane axis;
4. ``max(1, plane max-iter)`` cycles of ``cycle2.run_cycle`` on the
   rank's colour hierarchy, under the plane-config's backend: on the card
   the batched K10, K1, K4 or K5 and K2/K3;
5. the block's window written back into x.

Colour parity is global: a plane is colour ``c`` when its global index
has parity ``c`` (DOWN relaxes parity 0 first, UP the reverse), so a block
along ``p`` starting at an odd ``lo`` takes its colour ``c`` from local
index ``(c - lo) % 2`` (:func:`cedar_tpu_torch.ops.planes3.colour_start`).
The halo exchange runs for every colour the level has, whether or not
this rank holds a plane of it, since its neighbours along ``p`` may.

Every rank of an in-plane group (the ranks sharing a block along ``p``)
solves the same planes: redundant plane work for one gather per in-plane
axis and colour.  The alternative, a batched distributed 2D cycle over the
in-plane sub-mesh (the reference's sliced plane communicators), needs
distributed line relaxation on batches (ROADMAP queue 1, item 1).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import backend, planes3
from cedar_tpu_torch.parallel import comm
from cedar_tpu_torch.parallel.shard_relax import H


@dataclass
class PlaneWork:
    """One level's and orientation's workspace: the plane axis, the global
    index ``lo`` of the rank's first plane, ``names`` the axes along which
    x takes its halo of one, ``so1`` the block's stencil extended by one
    along them and ``colours`` the rank's colour hierarchies (None where
    it holds no plane of that colour)."""
    axis: int
    lo: int
    names: tuple
    so1: torch.Tensor
    colours: tuple


def _inplane(axis: int) -> list:
    return [d for d in range(3) if d != axis]


def whole_planes(a: torch.Tensor, lay, mesh, axis: int, dims) -> torch.Tensor:
    """``a`` gathered whole along the in-plane axes that ``lay``
    partitions (one all-gather each, tagged ``"plane"``); ``dims[k]`` is
    the dimension of ``a`` holding the ``k``-th in-plane axis."""
    for d, dim in zip(_inplane(axis), dims):
        name = lay.names[d]
        if name is not None:
            m = lay.hi[d] - lay.lo[d]
            a = comm.all_gather_axis(a, dim, name, mesh,
                                     [m] * mesh.shape[name], tag="plane")
    return a


def _cut_batch(hier, start: int, count: int) -> tuple:
    """Planes ``start .. start + count`` of a batched 2D hierarchy, each
    field contiguous (the batch axis after the leading axis of the
    stencil, CI and line factors; first for ``recip`` and ``ainv``)."""
    def take(a, dim):
        return None if a is None else a.narrow(dim, start, count).contiguous()

    return tuple(lev._replace(
        so=take(lev.so, 1), recip=take(lev.recip, 0), ci=take(lev.ci, 1),
        sor_x=take(lev.sor_x, 1), sor_y=take(lev.sor_y, 1),
        ainv=take(lev.ainv, 0),
        inner=(None if lev.inner is None
               else _cut_batch(lev.inner, start, count)))
        for lev in hier)


def cut_colours(colours, lo: int, hi: int) -> tuple:
    """A global hierarchy's colour hierarchies (colour ``c`` over the
    planes ``c::2``) cut to the planes ``[lo, hi)`` of a block."""
    out = []
    for c, hier in enumerate(colours):
        first = lo + planes3.colour_start(c, lo)
        count = len(range(first, hi, 2))
        out.append(None if hier is None or count == 0
                   else _cut_batch(hier, (first - c) // 2, count))
    return tuple(out)


def halo_names(lay, axis: int, kind: StencilKind) -> tuple:
    """The axes along which x takes its halo of one: the plane axis, and
    the in-plane axes too for a 27-point level."""
    full = kind == StencilKind.twenty_seven_pt
    return tuple(n if (d == axis or full) else None
                 for d, n in enumerate(lay.names))


def setup(ctx, lvl: int, lev, kind: StencilKind, orient: str,
          psettings) -> PlaneWork:
    """The workspace of level ``lvl`` and ``orient`` on this rank of
    ``ctx`` (a :class:`cedar_tpu_torch.parallel.halo.DistContext`): the
    colour hierarchies ``lev.planes[orient]`` where the level carries them
    (cut to the block by :func:`cut_colours`), else set up on the stencil
    of the rank's planes, gathered whole in-plane."""
    lay, mesh = ctx.layouts[lvl], ctx.mesh
    axis = planes3.PLANE_SPECS[orient][0]
    lo = lay.lo[axis]
    colours = lev.planes.get(orient) if lev.planes else None
    if colours is None:
        so = whole_planes(lev.so, lay, mesh, axis,
                          [d + 1 for d in _inplane(axis)])
        colours = planes3.setup_colours(so, kind, orient, psettings, lo)
    for c, hier in enumerate(colours):
        want = len(range(lo + planes3.colour_start(c, lo), lay.hi[axis], 2))
        got = 0 if hier is None else hier[0].so.shape[1]
        if got != want:
            raise ValueError(f"level {lvl} {orient}: {got} planes of colour "
                             f"{c}, the block holds {want}")
    names = halo_names(lay, axis, kind)
    idx = [slice(None)]
    for d, n in enumerate(lay.names):
        idx.append(slice(None) if n is None else
                   slice(H - 1, 1 - H) if names[d] is not None else
                   slice(H, -H))
    return PlaneWork(axis=axis, lo=lo, names=names,
                     so1=ctx.so_h[lvl][tuple(idx)].contiguous(),
                     colours=tuple(colours))


def relax(ctx, lvl: int, kind: StencilKind, x: torch.Tensor,
          b: torch.Tensor, orient: str, updown: str, settings):
    """One zebra plane-relaxation sweep (both colours) of this rank's block
    ``x`` of level ``lvl``, IN PLACE; returns ``x``.  Bit for bit the
    serial :func:`cedar_tpu_torch.ops.planes3.plane_relax` on the block."""
    from cedar_tpu_torch.solver import cycle2

    ws = ctx.planes[(lvl, orient)]
    lay, mesh, axis = ctx.layouts[lvl], ctx.mesh, ws.axis
    psettings = settings.plane_settings
    reps = max(1, psettings.maxiter)
    per = lay.op_periodic(mesh)
    inplane = _inplane(axis)
    window = tuple(slice(lay.lo[d], lay.hi[d]) for d in inplane)
    for c in ((0, 1) if updown == "down" else (1, 0)):
        if lay.shape[axis] <= c:          # the level has no such plane
            continue
        # the exchange pairs this rank with its neighbours along the plane
        # axis, which may hold planes of the colour where this one has none
        x1 = comm.halo_extend(x, ws.names, mesh, 1, periodic=lay.periodic)
        hier = ws.colours[c]
        if hier is None:
            continue
        acc = planes3.out_of_plane_apply(ws.so1, x1, kind, axis, per)
        rhs = b + comm.center(acc, ws.names, mesh, 1)
        t = torch.stack([planes3.colour_planes(rhs, axis, c, ws.lo),
                         planes3.colour_planes(x, axis, c, ws.lo)])
        t = whole_planes(t, lay, mesh, axis, (2, 3))
        b2 = t[0]
        # the embedded cycle updates its iterate in place: a copy of its own
        x2 = t[1].clone(memory_format=torch.contiguous_format)
        kinds2 = ([planes3.plane_kind2(kind)]
                  + [StencilKind.nine_pt] * (len(hier) - 1))
        # a plane-config that pins kernels.backend holds for its solves
        with backend.using(psettings.kernel_backend):
            for _ in range(reps):
                x2 = cycle2.run_cycle(hier, kinds2, x2, b2, psettings)
        planes3.colour_planes(x, axis, c, ws.lo).copy_(
            x2[(slice(None),) + window])
    return x
