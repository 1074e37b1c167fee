"""K4: the 2D zebra line-relaxation kernel (CUDA) and its plain versions.

Counterpart of :mod:`cedar_tpu.ops.pallas_lines2`.  :func:`line_x` and
:func:`line_y` launch ``csrc/lines2.cu`` for each zebra colour (an rhs
pass, then the line solves) on the tensors' current stream;
:func:`line_x_plain` and :func:`line_y_plain` compute the same functions in
torch ops (:mod:`cedar_tpu_torch.ops.lines2`).
:func:`cedar_tpu_torch.ops.lines2.line_relax_x` / ``line_relax_y`` pick one
by device.

Both update ``q`` in place.  The kernel factors each line on the fly, with
a scratch buffer, and reads no setup workspace; the plain versions take the
:func:`~cedar_tpu_torch.ops.lines2.setup_lines` factors or, given None,
factor the same way.  ``launches`` counts kernel launches made by
:func:`line_x` / :func:`line_y`, ``plain_calls`` calls of the plain
versions.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, lines2

launches = 0
plain_calls = 0


def _check(so, q, b, kind: StencilKind) -> None:
    if kind not in (StencilKind.five_pt, StencilKind.nine_pt):
        raise ValueError(f"line sweep takes 2D five_pt or nine_pt, not {kind}")
    if q.ndim != 2 or b.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and b {tuple(b.shape)}")
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
            nlines: int, length: int):
    global launches
    _check(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    lib = cuda_build.load("lines2")
    fn = getattr(lib, entry)
    stream = cuda_build.stream_of(q)
    nx, ny = q.shape
    nine = int(kind == StencilKind.nine_pt)
    # the active lines' rhs (then the forward solution w) and multipliers l
    scratch = q.new_empty((2, length, (nlines + 1) // 2))
    for parity in lines2.colour_order(updown):
        cuda_build.check(
            fn(dt, so.data_ptr(), q.data_ptr(), b.data_ptr(),
               scratch.data_ptr(), nx, ny, nine, parity, stream),
            entry,
        )
        launches += 2   # the rhs pass and the line solves
    return q


def line_x(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
           kind: StencilKind, updown: str) -> torch.Tensor:
    """One zebra x-line sweep on the card, ``q`` updated in place."""
    nx, ny = q.shape
    return _launch("cedar_line2_x", so, q, b, kind, updown, ny, nx)


def line_y(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
           kind: StencilKind, updown: str) -> torch.Tensor:
    """One zebra y-line sweep on the card, ``q`` updated in place; the
    operands are read where they lie (no transposes)."""
    nx, ny = q.shape
    return _launch("cedar_line2_y", so, q, b, kind, updown, nx, ny)


def line_x_plain(so, q, b, kind: StencilKind, updown: str, sor=None):
    """:func:`line_x` in torch ops, on any device; ``q`` in place."""
    global plain_calls
    plain_calls += 1
    _check(so, q, b, kind)
    return lines2.sweep_x_torch(so, q, b, sor, kind, updown)


def line_y_plain(so, q, b, kind: StencilKind, updown: str, sor=None):
    """:func:`line_y` in torch ops, on any device; ``q`` in place."""
    global plain_calls
    plain_calls += 1
    _check(so, q, b, kind)
    return lines2.sweep_y_torch(so, q, b, sor, kind, updown)
