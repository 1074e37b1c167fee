"""The distributed SPIKE (interface-reduction) line solve, 2D.

PyTorch counterpart of cedar_tpu's ``DistSpikeFactors``,
``DistSpikeLines``, ``dist_spike_eligible``, ``setup_lines_spike_dist``
and ``_dist_spike_color`` (cedar_tpu/ops/lines2.py:325-505; reference:
LineSolve_A/B/C, src/2d/ftn/mpi/BMG2_SymStd_relax_lines_x.f90:156-277).
A zebra sweep along a partitioned line axis, each rank holding a block of
L rows of every line:

* at setup, per colour: the interior system of each line's block (rows 1
  .. L-2, its couplings to rows 0 and L-1 dropped), the two spikes ``p``
  and ``q`` (its solutions for those couplings), and the rank's two rows
  of the reduced system of the first and last rows of every block, which
  one all-gather along the line axis gives every rank whole ((2P) rows);
* at each colour: the line right-hand side from q extended by one point,
  the interior solve ``phi``, ONE all-gather of the (2, nb) interface
  right-hand sides, the reduced system solved on every rank (the full PCR
  of :func:`cedar_tpu_torch.ops.lines2.pcr_solve`), and the rows
  ``x = phi + p s + q e`` with the block's own end rows ``s``, ``e``.

The interior solves (the spikes at setup, ``phi`` at each colour) are one
call of the serial line sweep on the interior system written as a 5-point
stencil with no coupling across lines (``S = 0``, so its right-hand side
is ``b`` exactly): K4 on the card, which factors the lines on the fly, by
the line length rule of :func:`~cedar_tpu_torch.ops.lines2.pcr_stride`.
That is another factorisation than cedar_tpu's LU scans and than the
serial sweep of the whole line, so the result is not bit for bit the
serial sweep's (the tests hold it at 1e-12 against the serial sweep and
at cedar_tpu's own tolerance against its ``DistSolver2``).

Eligibility (:func:`eligible`, cedar_tpu/parallel/dist.py:292-322): a
line axis partitioned over more than one rank, not periodic, blocks of at
least 4 rows; an even number of lines a rank along a partitioned
cross-line axis, so that the colours stay on the rank.  The y-lines run
the x-line solve on the transposed operands.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from cedar_tpu_torch.core.types import Dir2, StencilKind
from cedar_tpu_torch.ops import lines2
from cedar_tpu_torch.parallel import comm


@dataclass
class SpikeColour:
    """One colour's workspace: ``so_int`` the interior system as a 5-point
    stencil ``(3, L-2, nb)``, the spikes ``p`` and ``q`` ``(L-2, nb)``, the
    end rows' couplings to the interior ``up0`` and ``loL`` ``(nb,)``, and
    the reduced system's ``rlo``, ``rdg``, ``rup`` ``(2P, nb)`` (the first
    and last row of each rank's block, in mesh order)."""
    so_int: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor
    up0: torch.Tensor
    loL: torch.Tensor
    rlo: torch.Tensor
    rdg: torch.Tensor
    rup: torch.Tensor


@dataclass
class SpikeLines:
    """A level's SPIKE workspace for the lines along ``axis``: both
    colours (index = line parity), the stencil of the block extended by
    one point (x-line layout, for the right-hand side), the line axis's
    mesh axis name, its rank count and this rank's coordinate."""
    axis: str
    colours: tuple
    so1: torch.Tensor
    line_name: str
    nranks: int
    coord: int


def eligible(lay, mesh, axis: str) -> bool:
    """Whether the lines along ``axis`` of a level of layout ``lay``
    (:class:`~cedar_tpu_torch.parallel.halo.Layout`) take the distributed
    SPIKE solve (cedar_tpu's ``dist_spike_eligible``)."""
    d = 0 if axis == "x" else 1
    c = 1 - d
    la, ba = lay.names[d], lay.names[c]
    if la is None or mesh.shape[la] <= 1 or lay.periodic[d]:
        return False
    n = lay.shape[d]
    if n % mesh.shape[la] or n // mesh.shape[la] < 4:
        return False
    return ba is None or lay.shape[c] % (2 * mesh.shape[ba]) == 0


def interior_solve(so_int: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The solutions of the interior systems ``so_int`` for the right-hand
    sides ``r`` ``(L-2, nb)``: one serial line sweep (K4 on the card) of a
    zero iterate, whose right-hand side is ``r`` (``S = 0``)."""
    r = r.contiguous()           # the kernel takes contiguous operands
    x = torch.zeros(r.shape, dtype=r.dtype, device=r.device)
    lines2.line_relax_x(so_int, x, r, None, StencilKind.five_pt, "down")
    return x


def _x_layout(a: torch.Tensor, axis: str, kind=None) -> torch.Tensor:
    """``a`` (a stencil where ``kind`` is given) in x-line layout."""
    if axis == "x":
        return a
    if kind is not None:
        return lines2.transpose_so(a, kind)
    return a.mT


def setup(ctx, lvl: int, kind: StencilKind, axis: str) -> SpikeLines:
    """The SPIKE workspace of level ``lvl`` for the lines along ``axis``
    (cedar_tpu's ``setup_lines_spike_dist``): per colour the interior
    systems, the spikes and the reduced system, gathered once along the
    line axis."""
    from cedar_tpu_torch.parallel.halo import H, _from_ext

    lay, mesh = ctx.layouts[lvl], ctx.mesh
    d = 0 if axis == "x" else 1
    name = lay.names[d]
    nranks, coord = mesh.shape[name], mesh.coord(name)
    # the block with one more point on each side of its partitioned axes
    s = tuple(lo - 1 if n is not None else lo
              for lo, n in zip(lay.lo, lay.names))
    e = tuple(hi + 1 if n is not None else hi
              for hi, n in zip(lay.hi, lay.names))
    so1 = _x_layout(_from_ext(ctx.so_h[lvl], lay, H, s, e, lead=1), axis,
                    kind).contiguous()
    c0 = 1 if lay.names[1 - d] is not None else 0
    nb_all = so1.shape[-1] - 2 * c0
    blk = so1[:, 1:, c0:c0 + nb_all]            # rows 0 .. L (one past)
    L = blk.shape[1] - 1
    dg = blk[Dir2.O, :L]
    lo = -blk[Dir2.W, :L]
    up = -blk[Dir2.W, 1:L + 1]
    if coord == 0:
        lo = lo.clone()
        lo[0] = 0.0              # row 0 of the domain couples nothing below
    colours = []
    for parity in (0, 1):
        lo_c, dg_c, up_c = (a[:, parity::2] for a in (lo, dg, up))
        nb = dg_c.shape[1]
        so_int = dg_c.new_zeros((3, L - 2, nb))
        so_int[Dir2.O] = dg_c[1:L - 1]
        so_int[Dir2.W] = -lo_c[1:L - 1]
        src = dg_c.new_zeros((L - 2, nb))
        src[0] = -lo_c[1]
        p = interior_solve(so_int, src)
        src = dg_c.new_zeros((L - 2, nb))
        src[-1] = -up_c[L - 2]
        q = interior_solve(so_int, src)
        up0, loL = up_c[0], lo_c[L - 1]
        red = torch.stack([
            torch.stack([lo_c[0], loL * p[-1]]),
            torch.stack([dg_c[0] + up0 * p[0], dg_c[L - 1] + loL * q[-1]]),
            torch.stack([up0 * q[0], up_c[L - 1]]),
        ]).contiguous()                          # (3, 2, nb)
        red = comm.all_gather_axis(red, 1, name, mesh, [2] * nranks)
        colours.append(SpikeColour(so_int.contiguous(), p, q,
                                   up0.contiguous(), loL.contiguous(),
                                   red[0].contiguous(), red[1].contiguous(),
                                   red[2].contiguous()))
    return SpikeLines(axis, tuple(colours), so1, name, nranks, coord)


def sweep(ws: SpikeLines, ctx, lvl: int, kind: StencilKind, x: torch.Tensor,
          b: torch.Tensor, updown: str) -> torch.Tensor:
    """One zebra sweep of the block ``x`` along ``ws.axis`` by the
    distributed SPIKE solve (cedar_tpu's ``_dist_spike_color``, both
    colours); returns the new block."""
    lay = ctx.layouts[lvl]
    d = 0 if ws.axis == "x" else 1
    c = 1 - d
    per = list(lay.op_periodic(ctx.mesh))
    per_x = (per[d], per[c])
    pad = []
    for n in reversed(lay.names):
        pad += [1, 1] if n is not None else [0, 0]
    b1 = _x_layout(F.pad(b, pad), ws.axis)
    c0 = 1 if lay.names[c] is not None else 0
    h = 1 << (2 * ws.nranks - 1).bit_length()   # the full PCR
    i = 2 * ws.coord
    q = x.clone()
    qx = _x_layout(q, ws.axis)
    for parity in lines2.colour_order(updown):
        q1 = _x_layout(comm.halo_extend(q, lay.names, ctx.mesh, 1,
                                        periodic=lay.periodic), ws.axis)
        rhs = lines2.line_rhs_x(ws.so1, q1, b1, kind, per_x)
        r = rhs[1:-1, c0:rhs.shape[1] - c0][:, parity::2]
        f = ws.colours[parity]
        L = r.shape[0]
        phi = interior_solve(f.so_int, r[1:L - 1])
        rr = torch.stack([r[0] - f.up0 * phi[0],
                          r[L - 1] - f.loL * phi[-1]]).contiguous()
        rr = comm.all_gather_axis(rr, 0, ws.line_name, ctx.mesh,
                                  [2] * ws.nranks, tag="spike")
        w = lines2.pcr_solve(f.rlo, f.rdg, f.rup, rr, h)
        s, e = w[i], w[i + 1]
        x_int = phi + f.p * s[None] + f.q * e[None]
        qx[:, parity::2] = torch.cat([s[None], x_int, e[None]])
    return q
