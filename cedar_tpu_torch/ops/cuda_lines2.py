"""K4: the 2D zebra line-relaxation kernel (CUDA) and its plain versions.

Counterpart of :mod:`cedar_tpu.ops.pallas_lines2`.  :func:`line_x` and
:func:`line_y` launch ``csrc/lines2.cu`` once for each zebra colour on the
tensors' current stream; :func:`line_x_plain` and :func:`line_y_plain`
compute the same functions in torch ops (:mod:`cedar_tpu_torch.ops.lines2`).
:func:`cedar_tpu_torch.ops.lines2.line_relax_x` / ``line_relax_y`` pick one
by device.

Both update ``q`` in place and solve a line as
:func:`~cedar_tpu_torch.ops.lines2.sweep_x_torch` does: PCR to the stride
:func:`~cedar_tpu_torch.ops.lines2.pcr_stride` h, then Thomas on the h
interleaved systems, for lines of 64 points or more; the LDLᵀ recurrence,
factored on the fly, for shorter ones.  A block of the kernel holds the
adjacent active lines :func:`group` gives in shared memory (``LINE_SMEM``
bytes at most), or, for a line too long for it, one line in a
device-memory scratch; x-lines run in clusters of ``K4_CLUSTER`` blocks
that stage and store their lines together.  The plain versions take the
:func:`~cedar_tpu_torch.ops.lines2.setup_lines` factors for the short lines
or, given None, factor the same way.  ``launches`` counts kernel launches
made by :func:`line_x` / :func:`line_y` (one a colour;
``periodic_launches`` the periodic ones among them), ``plain_calls``
calls of the plain versions.

A batch of independent planes (``q`` and ``b`` ``(B, nx, ny)``, ``so``
``(ndir, B, nx, ny)``; plane relaxation's line-x and line-y plane
smoothers, never periodic) goes to K10's one-direction mode
(:func:`cedar_tpu_torch.ops.cuda_planes2.smooth` with ``axes`` "x" or
"y", counted in its ``line_launches``): one launch for both colours of
every plane, each line solved as here, so each plane equals its
unbatched sweep bit for bit.  The plain versions take the batch as it is.

``periodic`` marks the periodic axes.  A line along a periodic axis is
cyclic: the kernel stages it twice, with the right-hand side and with the
Sherman–Morrison vector u, solves both with the modified matrix and
combines them as :func:`~cedar_tpu_torch.ops.lines2.cyclic_solve` does, so
a block holds half as many cyclic lines.  Across a periodic axis the
right-hand side wraps, and an odd number of lines raises before any
launch (:func:`~cedar_tpu_torch.ops.lines2.check_lines`).
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, lines2

launches = 0
periodic_launches = 0
plain_calls = 0

#: shared memory the line kernels (K4, K10) give a block's lines, bytes:
#: two buffers of npad rows of 4 values a line (csrc/stencil2.cuh `Lines`)
LINE_SMEM = 192 * 1024
#: rows K4 aims to stage a block: 3 lines of 2048 points (x-lines read
#: runs of 2 lines + 1 columns a row; PERF.md, Findings)
K4_ROWS = 6144
#: blocks of a cluster of K4's x-line kernel (csrc/lines2.cu `kCluster`)
K4_CLUSTER = 4


def line_pad(n: int, h: int) -> int:
    """The rows a line of ``n`` points is held in (csrc/stencil2.cuh
    ``line_pad``): a multiple of h for PCR, ``n`` made odd for the LDLᵀ
    recurrence (h = 0)."""
    return -(-n // h) * h if h else n | 1


def group(n: int, nactive: int, itemsize: int, rows: int,
          cyclic: bool = False) -> tuple:
    """``(h, lines, scratch)`` for solving lines of ``n`` points: the PCR
    stride, the lines a block holds at once (at most ``nactive`` and
    ``rows`` rows, one at least) and whether they must sit in a device-memory
    scratch (a line's 8 · npad values beyond ``LINE_SMEM``).  A cyclic line
    takes the room of two."""
    h = lines2.pcr_stride(n)
    slots = 2 if cyclic else 1
    npad = line_pad(n, h)
    fit = LINE_SMEM // (8 * slots * npad * itemsize)
    lines = max(1, min(nactive, fit, rows // (slots * npad)))
    return h, lines, fit == 0


def _check(so, q, b, kind: StencilKind, periodic=(False, False)) -> None:
    if kind not in (StencilKind.five_pt, StencilKind.nine_pt):
        raise ValueError(f"line sweep takes 2D five_pt or nine_pt, not {kind}")
    if q.ndim not in (2, 3) or b.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and b {tuple(b.shape)}: "
                         "expected (nx, ny) or a batch (B, nx, ny)")
    if q.ndim == 3 and any(periodic):
        raise ValueError("a batch of planes is never periodic")
    if tuple(so.shape) != (kind.ndirs, *q.shape):
        raise ValueError(
            f"so {tuple(so.shape)} does not fit {kind} on {tuple(q.shape)}"
        )
    # in place is race-free only because a line's rhs reads q on the lines
    # of the other colour; q must not alias what the kernel reads
    storage = q.untyped_storage().data_ptr()
    if storage in (b.untyped_storage().data_ptr(),
                   so.untyped_storage().data_ptr()):
        raise ValueError("q must not share storage with so or b")


def _launch(entry: str, so, q, b, kind: StencilKind, updown: str,
            nlines: int, length: int, periodic, cyclic: bool):
    global launches, periodic_launches
    if q.ndim != 2:
        raise ValueError(f"K4 takes one plane, not {tuple(q.shape)}")
    _check(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    lib = cuda_build.load("lines2")
    fn = getattr(lib, entry)
    stream = cuda_build.stream_of(q)
    nx, ny = q.shape
    nine = int(kind == StencilKind.nine_pt)
    h, lines, far = group(length, (nlines + 1) // 2, q.element_size(),
                          K4_ROWS, cyclic)
    # a line too long for shared memory: its arrays (both of a cyclic
    # line's systems), a block each (x-lines run in clusters of K4_CLUSTER
    # blocks)
    blocks = -(-((nlines + 1) // 2) // K4_CLUSTER) * K4_CLUSTER
    slots = 2 if cyclic else 1
    scratch = (q.new_empty((blocks, 8 * slots * line_pad(length, h)))
               if far else None)
    px, py = (int(bool(p)) for p in periodic)
    for parity in lines2.colour_order(updown):
        cuda_build.check(
            fn(dt, so.data_ptr(), q.data_ptr(), b.data_ptr(),
               None if scratch is None else scratch.data_ptr(), nx, ny, nine,
               parity, h, lines, px, py, stream),
            entry,
        )
        launches += 1
        periodic_launches += any(periodic)
    return q


def line_x(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
           kind: StencilKind, updown: str,
           periodic=(False, False)) -> torch.Tensor:
    """One zebra x-line sweep on the card, ``q`` updated in place (a
    batch of planes: one launch of K10's one-direction mode)."""
    if q.ndim == 3:
        return _batched(so, q, b, kind, updown, periodic, "x")
    nx, ny = q.shape
    lines2.check_lines(ny, periodic[1], "x")
    return _launch("cedar_line2_x", so, q, b, kind, updown, ny, nx, periodic,
                   bool(periodic[0]))


def line_y(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
           kind: StencilKind, updown: str,
           periodic=(False, False)) -> torch.Tensor:
    """One zebra y-line sweep on the card, ``q`` updated in place; the
    operands are read where they lie (no transposes)."""
    if q.ndim == 3:
        return _batched(so, q, b, kind, updown, periodic, "y")
    nx, ny = q.shape
    lines2.check_lines(nx, periodic[0], "y")
    return _launch("cedar_line2_y", so, q, b, kind, updown, nx, ny, periodic,
                   bool(periodic[1]))


def _batched(so, q, b, kind: StencilKind, updown: str, periodic,
             axes: str) -> torch.Tensor:
    """A zebra sweep of every plane of a batch: K10 along ``axes``."""
    from cedar_tpu_torch.ops import cuda_planes2

    _check(so, q, b, kind, periodic)
    return cuda_planes2.smooth(so, q, b, kind, updown, 1, axes=axes)


def line_x_plain(so, q, b, kind: StencilKind, updown: str, sor=None,
                 periodic=(False, False)):
    """:func:`line_x` in torch ops, on any device; ``q`` in place."""
    global plain_calls
    plain_calls += 1
    _check(so, q, b, kind, periodic)
    return lines2.sweep_x_torch(so, q, b, sor, kind, updown, periodic)


def line_y_plain(so, q, b, kind: StencilKind, updown: str, sor=None,
                 periodic=(False, False)):
    """:func:`line_y` in torch ops, on any device; ``q`` in place."""
    global plain_calls
    plain_calls += 1
    _check(so, q, b, kind, periodic)
    return lines2.sweep_y_torch(so, q, b, sor, kind, updown, periodic)
