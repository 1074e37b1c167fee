"""The distributed ops of a cycle and of its setup, each on this rank's
blocks: what XLA's partitioner did for cedar_tpu's sharded hierarchy.

Each op extends its inputs by the halo it reads
(:func:`cedar_tpu_torch.parallel.comm.halo_extend`), runs the port's
serial op on the extended window (a torch op on the CPU; K1 or K6, K2,
K3 and K5 or K7, K8 and K9 on the card) and keeps this rank's part.  A
window stops at the domain's edge, where the serial op sees the domain's
own edge, and starts at an even global index, where a fine point of the
window is a coarse point of the window's coarse grid as it is of the
whole grid (coarse point ``c`` is fine point ``2c``; CI index ``k`` is
fine point ``2k - 1``).

Level ``l``'s layout (:class:`Layout`) partitions an axis over its mesh
axis (``names[d]``, an extent that divides into blocks ``[lo, hi)``) or
replicates it.  A restriction from level ``l`` leaves each rank the
coarse points ``c`` with ``2c`` in its fine block (the chunk ``[c0,
c1)``): when the fine block is even that is the coarse level's block; an
axis that the coarse level replicates is gathered along its mesh row or
column (:meth:`DistContext.restrict`, the agglomeration going down); an
axis that it partitions and the fine level replicates is cut.  Going up
each rank takes the coarse points its fine block reads: a halo of the
coarse block, or its slice of a replicated coarse level.

The halo widths: the sweep ``H`` = 8 (:mod:`cedar_tpu_torch.parallel.
shard_relax`); the residual 1; the restriction, interp-add and
interpolation a transfer window of ``T`` = 4 fine points (3 on an odd
block start) and ``TC`` = 3 coarse points, the restriction reading fine
points ``2c - 1 .. 2c + 1`` and the interpolation coarse points
``floor(i / 2) .. ceil(i / 2)``; the setup of a level (``setup_interp``
reads the stencil 2 points away, ``coarsen_op`` the weights 2 points
away) a window of ``H`` fine points.  The interp-add reads ``res``, ``x``
and the diagonal at its own point only: those take no halo.

The convergence norm (:meth:`DistContext.norm`) sums ``r²`` over the
block, one rank of each mesh axis that the level replicates counting,
then adds the ranks' sums with one all-reduce.

Periodic axes (``Layout.periodic``, cedar_tpu/parallel/dist.py:163-237):
a level partitions a periodic axis only where its blocks are even (an odd
or non-dividing extent is replicated, :func:`cedar_tpu_torch.parallel.
dist.periodic_specs`).  Along a partitioned periodic axis a window does
not stop at the domain's edge: it reaches ``h`` points past the block on
both sides, global indices below 0 and from n on standing for the wrapped
points, and the halo exchange fills them with the wrap from the far rank
of the ring; the serial op then runs non-periodic along that axis and
reads the wrap from the window (an even window start keeps the colours
and the coarse points anchored, n being even).  Along a replicated
periodic axis the window holds the whole axis and the op runs in its own
periodic mode (:func:`cedar_tpu_torch.parallel.shard_relax.op_periodic`).

Line relaxation (:meth:`DistContext.line_relax`, cedar_tpu/ops/lines2.py:
507-545 and :mod:`cedar_tpu_torch.parallel.lines`): a zebra sweep along a
partitioned line axis takes the distributed SPIKE solve where the level is
eligible, else gathers whole lines: the line axis of q gathered (one
all-gather), the cross-line axis extended by ``H`` (two colours need a
halo of 2), the serial sweep (K4 on the card, cyclic lines along a
periodic line axis) on the window, and the block kept.  The stencil's
window is gathered once, at construction, and ``b``'s once a visit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import lines2
from cedar_tpu_torch.parallel import comm, shard_relax
from cedar_tpu_torch.parallel.shard_relax import H, op_periodic
from cedar_tpu_torch.solver.level import Level

T = 4     # fine points of a transfer window beyond the block
TC = 3    # coarse points of the coarse halo that a transfer reads


@dataclass(frozen=True)
class Layout:
    """This rank's part of a level of global ``shape``: per axis the mesh
    axis it is partitioned over (None: replicated, also over a mesh axis of
    one rank), the block ``[lo, hi)`` and whether the axis is periodic."""
    shape: tuple
    names: tuple
    lo: tuple
    hi: tuple
    periodic: tuple

    @classmethod
    def of(cls, shape, spec, mesh, periodic=None) -> "Layout":
        names, lo, hi = [], [], []
        for d, n in enumerate(shape):
            ax = spec[d] if d < len(spec) else None
            if ax is not None and mesh.shape[ax] > 1:
                if n % mesh.shape[ax]:
                    raise ValueError(f"level of shape {tuple(shape)}: axis "
                                     f"{d} does not divide over {ax}")
                m = n // mesh.shape[ax]
                names.append(ax)
                lo.append(mesh.coord(ax) * m)
                hi.append(mesh.coord(ax) * m + m)
            else:
                names.append(None)
                lo.append(0)
                hi.append(n)
        per = tuple(bool(p) for p in (periodic or ()))
        per += (False,) * (len(shape) - len(per))
        return cls(tuple(shape), tuple(names), tuple(lo), tuple(hi),
                   per[:len(shape)])

    def op_periodic(self, mesh) -> tuple:
        """The ``periodic`` argument of the serial ops on this level's
        windows (:func:`~cedar_tpu_torch.parallel.shard_relax.
        op_periodic`)."""
        return op_periodic(self.names, mesh, self.periodic)

    def window(self, h: int) -> tuple:
        """``(starts, stops)`` of the window ``h`` points beyond the block
        on partitioned axes, from an even index: inside the domain, or past
        its edges along a periodic axis (the wrap)."""
        s, e = [], []
        for d, n in enumerate(self.shape):
            if self.names[d] is None:
                s.append(0)
                e.append(n)
                continue
            a = self.lo[d] - h if self.periodic[d] else max(self.lo[d] - h, 0)
            s.append(a + (a & 1))
            e.append(self.hi[d] + h if self.periodic[d]
                     else min(self.hi[d] + h, n))
        return tuple(s), tuple(e)

    def chunk(self) -> tuple:
        """``(c0, c1)`` per axis: the coarse points ``c`` with ``2c`` in
        the block."""
        return tuple(((lo + 1) // 2, (hi + 1) // 2)
                     for lo, hi in zip(self.lo, self.hi))


def _cut(a, starts, stops, lead=0):
    """``a[starts:stops]`` on the axes after ``lead``, contiguous (the
    kernels take contiguous operands)."""
    idx = [slice(None)] * lead + [slice(s, e) for s, e in zip(starts, stops)]
    return a[tuple(idx)].contiguous()


def _cut_wrap(a, starts, stops, lead, periods):
    """:func:`_cut` with the indices of the axes of a period (``periods[d]``
    not None) taken modulo it: the wrapped entries of a periodic axis."""
    for d, n in enumerate(periods):
        if n is not None and (starts[d] < 0 or stops[d] > a.shape[lead + d]):
            idx = torch.arange(starts[d], stops[d], device=a.device) % n
            a = a.index_select(lead + d, idx)
            starts = starts[:d] + (0,) + tuple(starts[d + 1:])
            stops = stops[:d] + (len(idx),) + tuple(stops[d + 1:])
    return _cut(a, starts, stops, lead)


def _ext(a, lay: Layout, mesh, h: int, lead=0):
    """``a``, a block of ``lay``, extended by ``h`` (the wrap along its
    periodic axes)."""
    return comm.halo_extend(a, lay.names, mesh, h, lead, lay.periodic)


def _from_ext(a_ext, lay: Layout, h: int, starts, stops, lead=0):
    """The global window ``[starts, stops)`` of an array extended by ``h``
    on the partitioned axes of ``lay``."""
    base = [lo - h if n is not None else 0
            for lo, n in zip(lay.lo, lay.names)]
    return _cut(a_ext, [s - b for s, b in zip(starts, base)],
                [e - b for e, b in zip(stops, base)], lead)


def _pad_to(a, lay: Layout, starts, stops):
    """The block ``a`` zero-padded to the window ``[starts, stops)``
    (for inputs the op reads at its own point only)."""
    pad = []
    for d in reversed(range(len(lay.shape))):
        pad += [lay.lo[d] - starts[d], stops[d] - lay.hi[d]]
    return F.pad(a, pad) if any(pad) else a.contiguous()


def _chunk_sizes(lay: Layout, name: str, d: int, mesh) -> list:
    m = lay.hi[d] - lay.lo[d]
    return [(c * m + m + 1) // 2 - (c * m + 1) // 2
            for c in range(mesh.shape[name])]


def to_coarse_layout(a, fine: Layout, coarse: Layout, mesh, lead=0):
    """A coarse array held as the chunks of the fine layout (the output of
    a restriction or a Galerkin product) in the coarse level's layout:
    axes the coarse level replicates gathered, axes it partitions alone
    cut (cedar_tpu/solver/cycle2.py:386-388)."""
    for d in range(len(fine.shape)):
        fn, cn = fine.names[d], coarse.names[d]
        if fn is not None and cn is None:
            a = comm.all_gather_axis(a, d + lead, fn, mesh,
                                     _chunk_sizes(fine, fn, d, mesh))
        elif fn is None and cn is not None:
            a = a.narrow(d + lead, coarse.lo[d], coarse.hi[d] - coarse.lo[d])
        elif fn is not None and a.shape[d + lead] != coarse.hi[d] - \
                coarse.lo[d]:
            raise ValueError("a partitioned coarse axis needs an even fine "
                             "block")
    return a


def coarse_window(cx, fine: Layout, coarse: Layout, mesh, starts, stops):
    """The coarse points ``[starts, stops)`` of ``cx`` (held in the coarse
    layout) that a fine window reads: gathered along axes the fine level
    replicates and the coarse one partitions, a halo of ``TC`` along axes
    both partition, a slice of replicated axes (cedar_tpu/solver/
    cycle2.py:407-408)."""
    names = list(coarse.names)
    lo = list(coarse.lo)
    for d in range(len(coarse.shape)):
        cn = coarse.names[d]
        if cn is not None and fine.names[d] is None:
            m = coarse.hi[d] - coarse.lo[d]
            cx = comm.all_gather_axis(cx, d, cn, mesh,
                                      [m] * mesh.shape[cn])
            names[d], lo[d] = None, 0
    ext = comm.halo_extend(cx, names, mesh, TC, periodic=coarse.periodic)
    base = [lo[d] - TC if names[d] is not None else 0
            for d in range(len(names))]
    for d, n in enumerate(names):
        if n is None and fine.names[d] is not None and fine.periodic[d]:
            # a replicated periodic coarse axis under a partitioned fine
            # one: the window's wrap, TC points each side
            k = ext.shape[d]
            ext = torch.cat([ext.narrow(d, k - TC, TC), ext,
                             ext.narrow(d, 0, TC)], d)
            base[d] = -TC
    for d, n in enumerate(names):
        if n is not None and (starts[d] < base[d]
                              or stops[d] > base[d] + ext.shape[d]):
            raise ValueError("coarse window beyond the coarse halo")
    return _cut(ext, [s - b for s, b in zip(starts, base)],
                [e - b for e, b in zip(stops, base)])


def ci_window(fine: Layout) -> tuple:
    """``(starts, stops)`` of the CI entries that the transfer window of
    the fine layout reads: the window's coarse grid and one entry more."""
    s, e = fine.window(T)
    cs = tuple(a // 2 for a in s)
    return cs, tuple(c + (b - a - 1) // 2 + 2 for c, a, b in zip(cs, s, e))


class _Ops:
    """The serial ops of one dimension."""

    def __init__(self, ndim: int):
        if ndim == 2:
            from cedar_tpu_torch.ops import galerkin2 as gal
            from cedar_tpu_torch.ops import interp2 as itp
            self.relax = shard_relax.point_relax2
        else:
            from cedar_tpu_torch.ops import galerkin3 as gal
            from cedar_tpu_torch.ops import interp3 as itp
            self.relax = shard_relax.point_relax3
        self.restrict = itp.restrict
        self.interp_add = itp.interp_add
        self.interp = itp.interp
        self.setup_interp = itp.setup_interp
        self.coarsen_op = gal.coarsen_op
        self.coarsen_op_explicit = gal.coarsen_op_explicit


def setup_level(so, kind: StencilKind, fine: Layout, coarse: Layout, mesh):
    """The distributed setup of one level (cedar_tpu's sharded setup,
    cedar_tpu/parallel/dist.py:22-24): from this rank's block ``so`` of the
    fine stencil, the coarse stencil's block in the coarse layout and the
    CI entries of the fine layout's transfer window (:func:`ci_window`).
    Halo: ``H`` fine points.  Where the grid has a periodic axis the
    Galerkin product is the explicit one, as in the serial periodic setup;
    its wrap comes from the halo or, along a replicated axis, from the
    ops' periodic mode."""
    ops = _Ops(len(fine.shape))
    so_h = _ext(so, fine, mesh, H, lead=1)
    s, e = fine.window(H)
    so_w = _from_ext(so_h, fine, H, s, e, lead=1)
    per = fine.op_periodic(mesh)
    ci_w = ops.setup_interp(so_w, kind, per)
    if any(fine.periodic):
        # the serial periodic setup's product (galerkin coarsen_op)
        so_c = ops.coarsen_op_explicit(ci_w, so_w, kind, per)
    else:
        so_c = ops.coarsen_op(ci_w, so_w, kind)
    cs = [a // 2 for a in s]
    chunk = fine.chunk()
    so_c = _cut(so_c, [c0 - c for (c0, _), c in zip(chunk, cs)],
                [c1 - c for (_, c1), c in zip(chunk, cs)], lead=1)
    so_c = to_coarse_layout(so_c, fine, coarse, mesh, lead=1).contiguous()
    ws, we = ci_window(fine)
    ci = _cut(ci_w, [a - c for a, c in zip(ws, cs)],
              [b - c for b, c in zip(we, cs)], lead=1)
    return so_c, ci


class DistContext:
    """The distributed ops of a cycle over this rank's hierarchy
    ``levels`` (blocks as :func:`cedar_tpu_torch.parallel.dist.
    local_levels` cuts them): the ``dist`` argument of the cycle modules'
    ``ncycle``, ``fmg_cycle``, ``run_cycle`` and ``cycle_residual``.  It
    holds each level's stencil extended by ``H`` (for the sweeps and the
    transfer windows; one exchange at construction) and the rhs of the
    level being smoothed, extended once a visit.

    ``line_axes`` (2D: "x" and/or "y") sets up line relaxation on every
    level but the coarsest: per level and axis the distributed SPIKE
    workspace where ``spike`` allows it and the level is eligible
    (:func:`cedar_tpu_torch.parallel.lines.eligible`), else the stencil's
    window of whole lines for the gather (one gather each, here)."""

    def __init__(self, levels, layouts, mesh, kinds=None, line_axes=(),
                 spike=False):
        from cedar_tpu_torch.parallel import lines

        self.mesh = mesh
        self.layouts = tuple(layouts)
        self.ops = _Ops(len(layouts[0].shape))
        self.so_h, self.so_sweep = [], []
        for lev, lay in zip(levels, layouts):
            so_h = _ext(lev.so, lay, mesh, H, lead=1)
            self.so_h.append(so_h.contiguous())
            self.so_sweep.append(shard_relax.sweep_stencil(so_h, lay.names,
                                                           mesh, lay.periodic))
        self.ci = [lev.ci for lev in levels]
        self._b = {}
        # line relaxation: (lvl, axis) -> SPIKE workspace, or the gathered
        # stencil window (so, starts, stops) of the gather
        self.spike, self._line_so = {}, {}
        for lvl in range(len(levels) - 1):
            lay = self.layouts[lvl]
            for axis in line_axes:
                d = 0 if axis == "x" else 1
                lines2.check_lines(lay.shape[1 - d], lay.periodic[1 - d], axis)
                if spike and lines.eligible(lay, mesh, axis):
                    self.spike[(lvl, axis)] = lines.setup(
                        self, lvl, kinds[lvl], axis)
                else:
                    s, e = self.line_window(lay, d)
                    self._line_so[(lvl, d)] = self._lines_of(
                        levels[lvl].so, lay, d, s, e, lead=1)

    def _b_ext(self, lvl, b):
        held = self._b.get(lvl)
        if held is None or held[0] is not b:
            held = (b, _ext(b, self.layouts[lvl], self.mesh, H).contiguous())
            self._b[lvl] = held
        return held[1]

    def relax(self, lvl, kind, x, b, updown, fuse_residual=False):
        """One sweep of the block (halo ``H``)."""
        lay = self.layouts[lvl]
        return self.ops.relax(self.so_sweep[lvl], x, b, kind, updown,
                              lay.names, self.mesh, fuse_residual,
                              self._b_ext(lvl, b), lay.periodic)

    # -- line relaxation ---------------------------------------------------
    @staticmethod
    def line_window(lay: Layout, d: int) -> tuple:
        """``(starts, stops)`` of the window of a sweep of the lines along
        axis ``d``: the whole line axis, the cross-line axis ``H`` past the
        block (:meth:`Layout.window`)."""
        s, e = lay.window(H)
        s, e = list(s), list(e)
        s[d], e[d] = 0, lay.shape[d]
        return tuple(s), tuple(e)

    def _lines_of(self, a, lay: Layout, d: int, starts, stops, lead=0):
        """The window ``[starts, stops)`` of whole lines along axis ``d``
        from the block ``a``: its cross-line axis extended by ``H`` (one
        exchange), then its line axis gathered (one all-gather)."""
        c = 1 - d
        names = [None, None]
        names[c] = lay.names[c]
        ext = comm.halo_extend(a, names, self.mesh, H, lead, lay.periodic)
        if lay.names[d] is not None:
            m = lay.hi[d] - lay.lo[d]
            ext = comm.all_gather_axis(ext, d + lead, lay.names[d], self.mesh,
                                       [m] * self.mesh.shape[lay.names[d]],
                                       tag="line")
        base = [0, 0]
        if lay.names[c] is not None:
            base[c] = lay.lo[c] - H
        return _cut(ext, [a - b for a, b in zip(starts, base)],
                    [e - b for e, b in zip(stops, base)], lead)

    def line_relax(self, lvl, axis, kind, x, b, updown, full=False):
        """One zebra sweep of the lines along ``axis`` ("x" or "y") of the
        block ``x``; returns the new block.  The distributed SPIKE solve
        where the level and axis have its workspace, else the gather: the
        serial sweep (K4 on the card) on the window of whole lines
        (:meth:`line_window`), in ``full`` (``solver.ml-relax``) PCR where
        asked."""
        ws = self.spike.get((lvl, axis))
        if ws is not None:
            from cedar_tpu_torch.parallel import lines

            return lines.sweep(ws, self, lvl, kind, x, b, updown)
        d = 0 if axis == "x" else 1
        lay = self.layouts[lvl]
        s, e = self.line_window(lay, d)
        so_w = self._line_so[(lvl, d)]
        held = self._b.get(("lines", lvl, d))
        if held is None or held[0] is not b:
            held = (b, self._lines_of(b, lay, d, s, e))
            self._b[("lines", lvl, d)] = held
        q_w = self._lines_of(x, lay, d, s, e)
        per = list(lay.op_periodic(self.mesh))
        per[d] = lay.periodic[d]
        sweep = lines2.line_relax_x if axis == "x" else lines2.line_relax_y
        sweep(so_w, q_w, held[1], None, kind, updown, tuple(per), full)
        return _cut(q_w, [lo - a for lo, a in zip(lay.lo, s)],
                    [hi - a for hi, a in zip(lay.hi, s)])

    def residual(self, lvl, kind, x, b):
        """``b - A x`` on the block (halo 1)."""
        lay = self.layouts[lvl]
        return shard_relax.residual(self.so_sweep[lvl], x, b, kind,
                                    lay.names, self.mesh, lay.periodic)

    def restrict(self, lvl, res):
        """The restriction of the block ``res`` of level ``lvl``, in level
        ``lvl + 1``'s layout (halo ``T``)."""
        fine, coarse = self.layouts[lvl], self.layouts[lvl + 1]
        s, e = fine.window(T)
        res_w = _from_ext(_ext(res, fine, self.mesh, T), fine, T, s, e)
        cb = self.ops.restrict(self.ci[lvl + 1], res_w,
                               fine.op_periodic(self.mesh))
        chunk = fine.chunk()
        cs = [a // 2 for a in s]
        cb = _cut(cb, [c0 - c for (c0, _), c in zip(chunk, cs)],
                  [c1 - c for (_, c1), c in zip(chunk, cs)])
        return to_coarse_layout(cb, fine, coarse, self.mesh).contiguous()

    def _coarse(self, lvl, cx):
        fine, coarse = self.layouts[lvl], self.layouts[lvl + 1]
        s, e = fine.window(T)
        cs = tuple(a // 2 for a in s)
        ce = tuple(c + (b - a - 1) // 2 + 1 for c, a, b in zip(cs, s, e))
        return s, e, coarse_window(cx, fine, coarse, self.mesh, cs, ce)

    def interp_add(self, lvl, cx, res, x):
        """``x + P cx + res/diag`` on the block of level ``lvl`` (coarse
        halo ``TC``)."""
        fine = self.layouts[lvl]
        s, e, cx_w = self._coarse(lvl, cx)
        so_w = _from_ext(self.so_h[lvl], fine, H, s, e, lead=1)
        out = self.ops.interp_add(self.ci[lvl + 1], so_w, cx_w,
                                  _pad_to(res, fine, s, e),
                                  _pad_to(x, fine, s, e),
                                  fine.op_periodic(self.mesh))
        return _cut(out, [lo - a for lo, a in zip(fine.lo, s)],
                    [hi - a for hi, a in zip(fine.hi, s)])

    def interp(self, lvl, cx):
        """``P cx`` on the block of level ``lvl`` (the F-cycle's level
        entry; coarse halo ``TC``)."""
        fine = self.layouts[lvl]
        s, e, cx_w = self._coarse(lvl, cx)
        out = self.ops.interp(self.ci[lvl + 1], cx_w,
                              tuple(b - a for a, b in zip(s, e)),
                              fine.op_periodic(self.mesh))
        return _cut(out, [lo - a for lo, a in zip(fine.lo, s)],
                    [hi - a for hi, a in zip(fine.hi, s)])

    def norm(self, r) -> torch.Tensor:
        """``‖r‖₂`` of level 0's block ``r`` over the mesh (0-d)."""
        lay = self.layouts[0]
        counts = all(self.mesh.coord(ax) == 0
                     for ax in self.mesh.axis_names
                     if ax not in lay.names)
        part = torch.sum(r * r) if counts else r.new_zeros(())
        return torch.sqrt(comm.all_reduce_sum(part, self.mesh))

    def gather(self, x) -> torch.Tensor:
        """The global array of level 0's blocks ``x``, on every rank."""
        lay, mesh = self.layouts[0], self.mesh
        if all(n is None for n in lay.names):
            return x
        parts = comm.all_gather_world(x.contiguous(), mesh)
        out = x.new_empty(lay.shape)
        for i, part in enumerate(parts):
            coords = np.unravel_index(i, mesh.dims)
            idx = []
            for d, n in enumerate(lay.names):
                if n is None:
                    idx.append(slice(None))
                else:
                    m = lay.hi[d] - lay.lo[d]
                    c = coords[mesh.axis_names.index(n)]
                    idx.append(slice(c * m, c * m + m))
            out[tuple(idx)] = part
        return out


def cut_level(lev, lay: Layout, finer: Layout | None) -> Level:
    """A global level's blocks in ``lay``, its CI entries those of the
    finer layout's transfer window (:func:`ci_window`; along a periodic
    axis the entries past the ends are the wrapped ones, CI entry ``k``
    being entry ``k + nc``)."""
    so = _cut(lev.so, lay.lo, lay.hi, lead=1)
    ci = None
    if finer is not None and lev.ci is not None:
        ws, we = ci_window(finer)
        periods = [n if p else None for n, p in zip(lay.shape, lay.periodic)]
        ci = _cut_wrap(lev.ci, ws, we, 1, periods)
    return Level(so=so, ci=ci, ainv=lev.ainv, inner=lev.inner)
