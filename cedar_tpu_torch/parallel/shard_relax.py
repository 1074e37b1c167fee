"""Point relaxation on a shard: kernels K1 and K6 on halo-extended blocks.

PyTorch counterpart of :mod:`cedar_tpu.parallel.shard_relax`.  The
reference exchanges ghost rows after every colour
(src/2d/ftn/mpi/BMG2_SymStd_relax_GS.f90:124-126); here, as in
cedar_tpu, each sweep

1. extends q (and b, unless the caller holds it extended) by ``H``
   points on each partitioned axis, one exchange each way per axis
   (:func:`cedar_tpu_torch.parallel.comm.halo_extend`), zeros beyond the
   mesh edges of a non-periodic axis; the stencil, extended once at
   setup, has there its diagonal repaired to 1 so that the discarded halo
   updates stay finite (cedar_tpu/parallel/shard_relax.py:135-136,
   :167-168), and its entries that couple a point outside the domain
   zeroed, so that the halo stays 0 (:func:`sweep_stencil`).  Along a
   partitioned periodic axis the halo holds the wrap (the far rank's
   values, and its stencil, couplings across the edge kept);
2. runs the port's serial sweep (``relax2.point_relax``, K1 on the card;
   ``relax3.point_relax``, K6) on the extended block, its colours anchored
   to global indices by the origin ``coord * local - H`` (``-H`` on the
   first rank of an axis), in the kernel's own periodic mode along a
   periodic axis that the level replicates (:func:`op_periodic`; the
   odd-extent Jacobi phases included);
3. keeps the block.

A colour phase reads the neighbours one point away, so after ``k``
phases the points ``k`` or more from the extended block's edge are
exact: ``H = 8`` covers the 2 colours of the 5- and 7-point sweeps, the
4 of the 9-point one and the 8 of the 27-point one.  The fused residual
reads one point further: a sweep of ``H`` colours or more (27-point)
computes its residual after the sweep instead, from a halo of one
(:func:`residual`).

:func:`supported2` and :func:`supported3` say which blocks the kernels
take: every partition that divides the level (the TPU's lane alignment of
z, cedar_tpu/parallel/shard_relax.py:112-116, has no counterpart here).
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import relax2, relax3, stencil2, stencil3
from cedar_tpu_torch.parallel import comm

H = 8


def _parted(names, mesh):
    return [n is not None and mesh.shape[n] > 1 for n in names]


def op_periodic(names, mesh, periodic) -> tuple:
    """The ``periodic`` argument of a serial op on a window: the periodic
    axes that the level does not partition (the window holds the whole
    axis, the op wraps it); along a partitioned periodic axis the wrap is
    in the halo."""
    per = tuple(periodic) if periodic else (False,) * len(names)
    return tuple(bool(p) and not q
                 for p, q in zip(per, _parted(names, mesh)))


def origin(names, mesh, local_shape) -> tuple:
    """The global index of the extended block's first point on each axis
    (cedar_tpu/parallel/shard_relax.py:67-77)."""
    return tuple(mesh.coord(n) * local_shape[d] - H if p else 0
                 for d, (n, p) in enumerate(zip(names,
                                                _parted(names, mesh))))


def _outward(ndim: int) -> dict:
    """plane -> the axes along which an entry stored at a point couples a
    point one lower: an entry on the first layer of such an axis couples
    a point outside the domain, which the serial operators never read."""
    if ndim == 2:
        table = {off: (plane, (sz, sw)) for off, (plane, sz, sw)
                 in stencil2.NEIGHBOR_COUPLINGS.items()}
    else:
        table = stencil3.NEIGHBOR_COUPLINGS_27
    out = {}
    for off, (plane, sh) in table.items():
        for d in range(ndim):
            if -sh[d] == -1 or off[d] - sh[d] == -1:
                out.setdefault(int(plane), set()).add(d)
    return out


def sweep_stencil(so_h: torch.Tensor, names, mesh,
                  periodic=None) -> torch.Tensor:
    """The stencil for the sweeps from ``so_h``, the block extended by
    ``H`` (zeros beyond the mesh edges): at a mesh edge the diagonal of
    the zeros repaired to 1 and the entries of the first layer that couple
    a point outside the domain set to 0, so that the halo stays 0 through
    the sweep, as the serial sweep reads it.  A periodic axis has no edge:
    its halo holds the wrap and the couplings across it stay.  ``so_h``
    itself where the block touches no mesh edge."""
    ndim = so_h.ndim - 1
    per = tuple(periodic) if periodic else (False,) * ndim
    edges = []                 # (axis, whether it is the low edge)
    for d, (n, p) in enumerate(zip(names, _parted(names, mesh))):
        if per[d]:
            continue
        if p and mesh.coord(n) == 0:
            edges.append((d, True))
        if p and mesh.coord(n) == mesh.shape[n] - 1:
            edges.append((d, False))
    if not edges:
        return so_h
    so_e = so_h.clone()
    diag = so_e[0]          # Dir2.O and Dir3.P are plane 0
    so_e[0] = torch.where(diag == 0, torch.ones_like(diag), diag)
    for plane, axes in _outward(ndim).items():
        if plane >= so_e.shape[0]:
            continue
        for d, low in edges:
            if low and d in axes:
                so_e[plane].narrow(d, H, 1).zero_()
    return so_e


def _supported(shape, names, mesh) -> bool:
    for d, (n, p) in enumerate(zip(names, _parted(names, mesh))):
        if p and shape[d] % mesh.shape[n]:
            return False
    return True


def supported2(shape, dtype, kind, names, mesh) -> bool:
    """Whether K1 (or its plain version) sweeps this partition of a 2D
    level: every partitioned extent divides, 5- or 9-point."""
    return (kind in (StencilKind.five_pt, StencilKind.nine_pt)
            and dtype in (torch.float32, torch.float64)
            and _supported(shape, names, mesh))


def supported3(shape, dtype, kind, names, mesh) -> bool:
    """Whether K6 (or its plain version) sweeps this partition of a 3D
    level: every partitioned extent divides, 7- or 27-point."""
    return (kind in (StencilKind.seven_pt, StencilKind.twenty_seven_pt)
            and dtype in (torch.float32, torch.float64)
            and _supported(shape, names, mesh))


def _ncolors(kind: StencilKind) -> int:
    return {StencilKind.five_pt: 2, StencilKind.seven_pt: 2,
            StencilKind.nine_pt: 4, StencilKind.twenty_seven_pt: 8}[kind]


def residual(so_e, q, b, kind, names, mesh, periodic=None) -> torch.Tensor:
    """``b - A q`` on the block, from ``so_e`` (the stencil extended by
    ``H``) and q extended by one point (halo width 1; the wrap along a
    partitioned periodic axis)."""
    ndim = q.ndim
    q1 = comm.halo_extend(q, names, mesh, 1, periodic=periodic)
    idx = [slice(None)]
    for n, p in zip(names, _parted(names, mesh)):
        idx.append(slice(H - 1, -(H - 1)) if p else slice(None))
    so1 = so_e[tuple(idx)].contiguous()
    pad = []
    for p in reversed(_parted(names, mesh)):
        pad += [1, 1] if p else [0, 0]
    b1 = torch.nn.functional.pad(b, pad)
    st = stencil2 if ndim == 2 else stencil3
    return comm.center(st.residual(so1, q1, b1, kind,
                                   op_periodic(names, mesh, periodic)),
                       names, mesh, 1).contiguous()


def _point_relax(rx, so_e, q, b, kind, updown, names, mesh, fuse_residual,
                 b_e=None, periodic=None):
    # the kernels take contiguous operands
    q_e = comm.halo_extend(q, names, mesh, H, periodic=periodic).contiguous()
    if b_e is None:
        b_e = comm.halo_extend(b, names, mesh, H,
                               periodic=periodic).contiguous()
    org = origin(names, mesh, q.shape)
    fuse = fuse_residual and _ncolors(kind) < H
    out = rx.point_relax(so_e, q_e, b_e, None, kind, updown,
                         fuse_residual=fuse, origin=org,
                         periodic=op_periodic(names, mesh, periodic))
    if fuse:
        return (comm.center(out[0], names, mesh, H).contiguous(),
                comm.center(out[1], names, mesh, H).contiguous())
    q = comm.center(out, names, mesh, H).contiguous()
    if fuse_residual:
        return q, residual(so_e, q, b, kind, names, mesh, periodic)
    return q


def point_relax2(so_e, q, b, kind, updown, names, mesh,
                 fuse_residual=False, b_e=None, periodic=None):
    """The 2D multicolour sweep of the block ``q`` (K1 on the card), from
    the stencil of :func:`sweep_stencil` and, where given, ``b``
    extended by ``H`` (``b_e``); returns the new block, with
    ``fuse_residual`` also ``b - A q``.  ``periodic``: the grid's periodic
    axes."""
    return _point_relax(relax2, so_e, q, b, kind, updown, names, mesh,
                        fuse_residual, b_e, periodic)


def point_relax3(so_e, q, b, kind, updown, names, mesh,
                 fuse_residual=False, b_e=None, periodic=None):
    """The 3D multicolour sweep of the block ``q`` (K6 on the card); as
    :func:`point_relax2`."""
    return _point_relax(relax3, so_e, q, b, kind, updown, names, mesh,
                        fuse_residual, b_e, periodic)

