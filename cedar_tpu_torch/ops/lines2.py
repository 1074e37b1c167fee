"""2D zebra line relaxation with batched tridiagonal line solves.

PyTorch counterpart of the serial part of :mod:`cedar_tpu.ops.lines2`
(reference: BMG2_SymStd_relax_lines_{x,y}.f90,
BMG2_SymStd_SETUP_lines_{x,y}.f90):

* zebra order — DOWN relaxes the lines of odd index first (Fortran
  JBEG_START=3), then the even ones; UP reverses;
* per line: rhs = b + every coupling to the OTHER lines at current values,
  then an exact tridiagonal solve along the line with diagonal ``O`` and
  off-diagonal ``-W`` (x-lines) or ``-S`` (y-lines).

The solve depends on the line's length n, by one rule that the kernels
(K4, K10) follow too (:func:`pcr_stride`): lines of ``PCR_MIN_LEN`` points
or more take parallel cyclic reduction (PCR) down to an interleave stride
h, then Thomas on the h interleaved systems (:func:`pcr_solve`, the term
order of ``cedar_tpu.ops.pallas_lines2._solve_all_lines``); shorter lines
(the coarse levels) take the LDLᵀ recurrence, whose factors
(:func:`setup_lines`) are the reference's SOR workspace
(:func:`tridiag_solve`).

x-lines run along axis 0 (one line per column ``j``); y-lines run along
axis 1 and reuse the x-line functions on transposed operands (under
transpose W↔S swap, SW↦SWᵀ, NW↦NWᵀ).  All lines of one colour are
independent, so the plain version batches them: the recurrences are Python
loops ALONG the line over all lines of the colour at once.  Every function
reads the grid from the last two axes, so a batch of planes (``so``
``(ndir, B, nx, ny)``, ``q`` ``(B, nx, ny)``, factors ``(2, B, nx, ny)``)
goes through the same code.

:func:`line_relax_x` and :func:`line_relax_y` dispatch by device and
backend, as :func:`cedar_tpu_torch.ops.relax2.point_relax` does: a CUDA
tensor goes to the line kernel (:mod:`cedar_tpu_torch.ops.cuda_lines2`,
factored on the fly; a batch of planes ``(B, nx, ny)`` with ``so`` ``(ndir, B, nx, ny)``,
never periodic, one launch of the batched mode), a CPU tensor to its plain
version.  Both update ``q`` IN PLACE.

Periodic grids (``periodic``): across a periodic axis the right-hand side
wraps around, and the number of lines must be even (line 0 and the last
line are neighbours, so they must take different colours); along a
periodic axis a line is cyclic and takes :func:`cyclic_solve`, two solves
with the modified matrix by the same length rule and a Sherman–Morrison
correction (cedar_tpu/ops/lines2.py:108-141).

``solver.ml-relax.enabled`` selects cedar_tpu's full-length PCR
(``cedar_tpu.ops.lines2._pcr_solve``) for the lines of ``PCR_MIN_LEN``
points or more: every function that solves lines takes ``full``, and
:func:`pcr_stride` then gives h = the power of two at or above n, so that
:func:`pcr_solve` runs all log2 h PCR steps and its Thomas step is
``r / dg``; shorter lines keep the LDLᵀ recurrence.  The serial SPIKE solve
is cedar_tpu's XLA formulation of the same tridiagonal solve and is not
ported (ROADMAP, "Do not port"); the distributed SPIKE solve is
:mod:`cedar_tpu_torch.parallel.lines`, and a sweep along a partitioned
line axis that does not take it gathers whole lines and runs this
module's sweep on them (:meth:`cedar_tpu_torch.parallel.halo.DistContext.
line_relax`).

Under ``kernels.backend: xla`` (:mod:`cedar_tpu_torch.ops.backend`) a CUDA
tensor takes the plain version too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cedar_tpu_torch.ops import backend
from cedar_tpu_torch.core.shift import shift2
from cedar_tpu_torch.core.types import Dir2, StencilKind


def transpose_so(so: torch.Tensor, kind: StencilKind) -> torch.Tensor:
    """The stencil of the transposed grid (``_transpose_so``)."""
    planes = [so[Dir2.O].mT, so[Dir2.S].mT, so[Dir2.W].mT]
    if kind != StencilKind.five_pt:
        planes += [so[Dir2.SW].mT, so[Dir2.NW].mT]
    return torch.stack(planes)


def _factor(diag: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """LDLᵀ of the lines along axis -2: ``(2, ..., n, m)`` with plane 0 =
    1/d and plane 1 = l (``l[0] = 0``), by DPTTRF's recurrence
    ``l_i = e_i / d_{i-1}``, ``d_i = a_i - l_i·e_i``."""
    d = torch.empty_like(diag)
    ls = torch.zeros_like(diag)
    d[..., 0, :] = diag[..., 0, :]
    for i in range(1, diag.shape[-2]):
        ls[..., i, :] = e[..., i, :] / d[..., i - 1, :]
        d[..., i, :] = diag[..., i, :] - ls[..., i, :] * e[..., i, :]
    return torch.stack([1.0 / d, ls])


def setup_lines(so: torch.Tensor, kind: StencilKind, axis: str) -> torch.Tensor:
    """LDLᵀ factors of each grid line along ``axis`` ('x' or 'y'), in the
    layout of ``so``: ``(2, [B,] nx, ny)``, plane 0 = 1/d(i), plane 1 = l(i)
    with e = -W (x-lines) or -S (y-lines)."""
    if axis == "y":
        fac = _factor(so[Dir2.O].mT, -so[Dir2.S].mT)
        return fac.mT.contiguous()
    return _factor(so[Dir2.O], -so[Dir2.W])


def tridiag_solve(sor: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve ``LDLᵀ x = rhs`` along axis -2, batched over the others."""
    dinv, ls = sor[0], sor[1]
    n = rhs.shape[-2]
    z = torch.empty_like(rhs)
    z[..., 0, :] = rhs[..., 0, :]
    for i in range(1, n):
        z[..., i, :] = rhs[..., i, :] - ls[..., i, :] * z[..., i - 1, :]
    w = z * dinv
    x = torch.empty_like(rhs)
    x[..., n - 1, :] = w[..., n - 1, :]
    for i in range(n - 2, -1, -1):
        x[..., i, :] = w[..., i, :] - ls[..., i + 1, :] * x[..., i + 1, :]
    return x


#: lines of this many points or more take :func:`pcr_solve`
#: (``cedar_tpu.ops.lines2._PCR_MIN_LEN``); shorter ones the LDLᵀ recurrence
PCR_MIN_LEN = 64


def pcr_stride(n: int, full: bool = False) -> int:
    """The interleave stride h at which :func:`pcr_solve` stops PCR on a
    line of ``n`` points, or 0 where the line takes the LDLᵀ recurrence
    (n < ``PCR_MIN_LEN``).  The kernels K4 and K10 take h from here too.

    h trades log2 h PCR steps over every row against Thomas chains of
    2n/h dependent steps: on the H100 8 was fastest for 128-point lines
    (K10) and 32 for 2048-point lines (K4) among 8, 16, 32 and 64
    (``tools/tune_lines.py``; PERF.md, Findings).  With ``full``
    (``solver.ml-relax.enabled``) h is the power of two at or above n:
    PCR runs to the end, cedar_tpu's ``_pcr_solve``."""
    if n < PCR_MIN_LEN:
        return 0
    if full:
        return 1 << (n - 1).bit_length()
    return 8 if n < 512 else 32


def _shift_rows(a: torch.Tensor, s: int, fill: float) -> torch.Tensor:
    """``out[..., i, :] = a[..., i + s, :]``, ``fill`` off the line."""
    out = torch.full_like(a, fill)
    if s > 0:
        out[..., :-s, :] = a[..., s:, :]
    else:
        out[..., -s:, :] = a[..., :s, :]
    return out


def pcr_solve(lo: torch.Tensor, dg: torch.Tensor, up: torch.Tensor,
              r: torch.Tensor, h: int) -> torch.Tensor:
    """Solve the tridiagonal systems along axis -2, batched over the
    others: ``lo[i]`` couples row i to i-1 (``lo[0] = 0``), ``up[i]`` to
    i+1 (``up[n-1] = 0``), diagonal ``dg``, rhs ``r``.

    PCR until rows h apart are decoupled (log2 h steps), then Thomas on
    the h interleaved systems of ⌈n/h⌉ rows, in the term order of
    ``cedar_tpu.ops.pallas_lines2._solve_all_lines``; the line is padded to
    a multiple of h with identity rows (diagonal 1, couplings and rhs 0).
    With h at or above n (:func:`pcr_stride` ``full``) that is
    cedar_tpu's full-length ``_pcr_solve``: its log2 h steps, then ``r /
    dg``.
    """
    n = r.shape[-2]
    npad = -(-n // h) * h
    if npad != n:
        pad = (0, 0, 0, npad - n)
        lo, up, r = (F.pad(a, pad) for a in (lo, up, r))
        dg = F.pad(dg, pad, value=1.0)
    hh = 1
    while hh < h:
        al = lo / _shift_rows(dg, -hh, 1.0)
        be = up / _shift_rows(dg, hh, 1.0)
        dg = (dg - al * _shift_rows(up, -hh, 0.0)
              - be * _shift_rows(lo, hh, 0.0))
        r = r - al * _shift_rows(r, -hh, 0.0) - be * _shift_rows(r, hh, 0.0)
        lo = -al * _shift_rows(lo, -hh, 0.0)
        up = -be * _shift_rows(up, hh, 0.0)
        hh *= 2
    # interleaved Thomas: step t of every system is the row slab
    # [t*h, (t+1)*h)
    nt = npad // h
    slabs = (*r.shape[:-2], nt, h, r.shape[-1])
    lo, dg, up, r = (a.reshape(slabs) for a in (lo, dg, up, r))
    d, z = [dg[..., 0, :, :]], [r[..., 0, :, :]]
    for t in range(1, nt):
        lt = lo[..., t, :, :] / d[-1]
        d.append(dg[..., t, :, :] - lt * up[..., t - 1, :, :])
        z.append(r[..., t, :, :] - lt * z[-1])
    x = [z[-1] / d[-1]]
    for t in range(nt - 2, -1, -1):
        x.append((z[t] - up[..., t, :, :] * x[-1]) / d[t])
    sol = torch.stack(x[::-1], dim=-3).reshape(*slabs[:-3], npad, slabs[-1])
    return sol[..., :n, :]


def line_coeffs_x(so: torch.Tensor):
    """``(lo, dg, up)`` of the x-lines for :func:`pcr_solve`: ``lo[i] =
    -W(i)`` (0 at i = 0), ``up[i] = -W(i+1)`` (0 at the last row)."""
    e = -so[Dir2.W]
    lo = e.clone()
    lo[..., 0, :] = 0.0
    return lo, so[Dir2.O], _shift_rows(e, 1, 0.0)


def cyclic_solve(lo: torch.Tensor, dg: torch.Tensor, up: torch.Tensor,
                 wrap: torch.Tensor, r: torch.Tensor,
                 full: bool = False) -> torch.Tensor:
    """Solve cyclic tridiagonal systems along axis -2, batched over the
    others: :func:`line_coeffs_x`'s ``lo``, ``dg``, ``up`` and the wrap
    coupling ``wrap`` of row 0 to row n-1 (and back: the operator is
    symmetric).  Sherman–Morrison (cedar_tpu/ops/lines2.py:108-141):

        A' = A_cyc with  d[0]   -= γ,   γ = -d[0]
                         d[n-1] -= cl·cu/γ,  corners dropped
        u  = (γ, 0, …, cl),   v = (1, 0, …, cu/γ)
        x  = y − z · (v·y)/(1 + v·z),   A'y = r,  A'z = u

    both solves of A' by the line's length rule (:func:`pcr_solve` to
    :func:`pcr_stride` ``(n, full)`` or the LDLᵀ recurrence, factored from
    A'), as the kernel K4 runs them."""
    n = r.shape[-2]
    cl = cu = wrap
    gamma = -dg[..., 0, :]
    dg = dg.clone()
    dg[..., 0, :] = dg[..., 0, :] - gamma
    dg[..., n - 1, :] = dg[..., n - 1, :] - cl * cu / gamma
    u = torch.zeros_like(r)
    u[..., 0, :] = gamma
    u[..., n - 1, :] = cl
    h = pcr_stride(n, full)
    if h:
        y, z = (pcr_solve(lo, dg, up, v, h) for v in (r, u))
    else:
        fac = _factor(dg, lo)
        y, z = (tridiag_solve(fac, v) for v in (r, u))
    t = cu / gamma
    vy = y[..., 0, :] + t * y[..., n - 1, :]
    vz = z[..., 0, :] + t * z[..., n - 1, :]
    return y - z * (vy / (1.0 + vz))[..., None, :]


def check_lines(nlines: int, periodic_across: bool, axis: str) -> None:
    """Zebra lines across a periodic axis need an even number of lines:
    line 0 and the last line are neighbours (cedar_tpu/ops/lines2.py:
    636-640)."""
    if periodic_across and nlines % 2:
        other = "y" if axis == "x" else "x"
        raise ValueError(
            f"zebra {axis}-line relaxation needs an even number of lines "
            f"when the {other} axis is periodic (line 0 and line "
            f"{nlines - 1} are neighbors)")


def line_rhs_x(so, q, b, kind: StencilKind,
               periodic=(False, False)) -> torch.Tensor:
    """rhs = b + couplings to the neighbouring lines (everything but the
    W/E terms along the line), in ``_line_rhs_x``'s term order."""
    def sh(a, dz, dw):
        return shift2(a, dz, dw, periodic)

    S = so[Dir2.S]
    rhs = b + S * sh(q, 0, -1) + sh(S, 0, 1) * sh(q, 0, 1)
    if kind != StencilKind.five_pt:
        SW, NW = so[Dir2.SW], so[Dir2.NW]
        rhs = (
            rhs
            + SW * sh(q, -1, -1)
            + sh(NW, 1, 0) * sh(q, 1, -1)
            + sh(NW, 0, 1) * sh(q, -1, 1)
            + sh(SW, 1, 1) * sh(q, 1, 1)
        )
    return rhs


def colour_order(updown: str):
    """Line parities in sweep order (DOWN: odd lines first)."""
    return (1, 0) if updown == "down" else (0, 1)


def sweep_x_torch(so, q, b, sor, kind: StencilKind, updown: str,
                  periodic=(False, False), full: bool = False):
    """One zebra x-line sweep in torch ops, IN PLACE on ``q`` (which may be
    a transposed view).  Lines of :func:`pcr_stride` ``(n, full)`` h > 0
    take :func:`pcr_solve` (``sor`` unused), the others the LDLᵀ
    recurrence with the factors ``sor``, or factored from ``so`` where
    ``sor`` is None.  Along a periodic x axis the lines are cyclic
    (:func:`cyclic_solve`, ``sor`` unused); across a periodic y axis the
    rhs wraps."""
    check_lines(q.shape[-1], periodic[1], "x")
    cyclic = bool(periodic[0])
    h = pcr_stride(q.shape[-2], full)
    if h or cyclic:
        lo, dg, up = line_coeffs_x(so)
    elif sor is None:
        sor = _factor(so[Dir2.O], -so[Dir2.W])
    for parity in colour_order(updown):
        rhs = line_rhs_x(so, q, b, kind, periodic)[..., parity::2]
        sl = (..., slice(parity, None, 2))
        if cyclic:
            wrap = -so[Dir2.W][..., 0, parity::2]
            q[sl] = cyclic_solve(lo[sl], dg[sl], up[sl], wrap, rhs, full)
        elif h:
            q[sl] = pcr_solve(lo[sl], dg[sl], up[sl], rhs, h)
        else:
            q[sl] = tridiag_solve(sor[sl], rhs)
    return q


def sweep_y_torch(so, q, b, sor, kind: StencilKind, updown: str,
                  periodic=(False, False), full: bool = False):
    """One zebra y-line sweep: :func:`sweep_x_torch` on the transposed
    system, IN PLACE on ``q`` through its transposed view."""
    sor_t = None if sor is None else sor.mT
    sweep_x_torch(transpose_so(so, kind), q.mT, b.mT, sor_t, kind, updown,
                  (periodic[1], periodic[0]), full)
    return q


def line_relax_x(so, q, b, sor, kind: StencilKind, updown: str,
                 periodic=(False, False), full: bool = False):
    """One zebra x-line sweep (both colours), IN PLACE on ``q``; returns
    ``q``.  ``sor`` (:func:`setup_lines` factors, or None) feeds the CPU
    path; the CUDA kernel factors on the fly, with the same rounding.
    ``full`` (``solver.ml-relax.enabled``): the full-length PCR."""
    from cedar_tpu_torch.ops import cuda_lines2

    if backend.kernels(q, "line sweep"):
        return cuda_lines2.line_x(so, q, b, kind, updown, periodic, full)
    return cuda_lines2.line_x_plain(so, q, b, kind, updown, sor=sor,
                                    periodic=periodic, full=full)


def line_relax_y(so, q, b, sor, kind: StencilKind, updown: str,
                 periodic=(False, False), full: bool = False):
    """One zebra y-line sweep (both colours), IN PLACE on ``q``."""
    from cedar_tpu_torch.ops import cuda_lines2

    if backend.kernels(q, "line sweep"):
        return cuda_lines2.line_y(so, q, b, kind, updown, periodic, full)
    return cuda_lines2.line_y_plain(so, q, b, kind, updown, sor=sor,
                                    periodic=periodic, full=full)
