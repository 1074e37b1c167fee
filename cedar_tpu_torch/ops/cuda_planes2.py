"""K10: the batched whole line-xy smooth (CUDA) and its plain version.

Counterpart of :mod:`cedar_tpu.ops.pallas_planes2`.  :func:`smooth`
launches ``csrc/planes2.cu`` once for ``nsweeps`` complete line-xy smooths
of every plane of a batch (x-line zebra then y-line zebra DOWN, the reverse
UP), optionally followed by the residual; :func:`smooth_plain` computes the
same function in torch ops: the zebra sweeps of
:mod:`cedar_tpu_torch.ops.lines2` composed, then
:func:`cedar_tpu_torch.ops.stencil2.residual`.
:mod:`cedar_tpu_torch.ops.planes2` picks one by device.

``axes`` "x" or "y" is the one-direction mode: the zebra x-line (y-line)
sweeps alone, the batched K4 of plane relaxation's line-x and line-y plane
smoothers (one launch for ``nsweeps`` sweeps of every plane and the
residual); each plane's sweep equals K4's and
:func:`~cedar_tpu_torch.ops.cuda_lines2.line_x_plain` /
``line_y_plain``'s on that plane.  Planes are never periodic (the JAX
package builds its plane solvers non-periodic), so no line is cyclic.

Operands: ``q`` and ``b`` ``(B, nx, ny)``, ``so`` ``(ndir, B, nx, ny)``.
Both versions update ``q`` in place and solve each line as K4 does (PCR
to the stride :func:`~cedar_tpu_torch.ops.lines2.pcr_stride`, then
interleaved Thomas, for lines of 64 points or more; the LDLᵀ recurrence
below).  A block of the kernel smooths one plane; each colour pass stages
its lines in shared memory, in groups of as many lines as
:data:`~cedar_tpu_torch.ops.cuda_lines2.LINE_SMEM` holds (a device-memory
scratch for a line too long for it).  The plain version takes the
:func:`~cedar_tpu_torch.ops.lines2.setup_lines` factors of the batch for
the short lines or, given None, factors the same way.  ``launches`` counts
kernel launches made by :func:`smooth` in line-xy mode (one a call),
``line_launches`` those in the one-direction mode, ``plain_calls`` calls
of :func:`smooth_plain`.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, cuda_lines2, lines2
from cedar_tpu_torch.ops.stencil2 import residual

launches = 0
line_launches = 0
plain_calls = 0

#: ``axes`` -> the kernel's mode bits (1: x-lines, 2: y-lines)
AXES = {"xy": 3, "x": 1, "y": 2}


def _check(so, q, b, kind: StencilKind, updown: str,
           axes: str = "xy") -> None:
    if axes not in AXES:
        raise ValueError(f"axes must be one of {tuple(AXES)}, not {axes!r}")
    if kind not in (StencilKind.five_pt, StencilKind.nine_pt):
        raise ValueError(f"line-xy smooth takes 2D five_pt or nine_pt, "
                         f"not {kind}")
    if updown not in ("down", "up"):
        raise ValueError(f"updown must be 'down' or 'up', not {updown!r}")
    if q.ndim != 3 or b.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and b {tuple(b.shape)}: "
                         "expected a batch (B, nx, ny)")
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


def smooth(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
           kind: StencilKind, updown: str, nsweeps: int = 1,
           emit_res: bool = False, axes: str = "xy"):
    """``nsweeps`` line-xy smooths (``axes`` "x" or "y": zebra x- or
    y-line sweeps) of every plane on the card, ``q`` updated in place: one
    launch.  Returns ``q``, or ``(q, b - A q)`` with ``emit_res``."""
    global launches, line_launches
    _check(so, q, b, kind, updown, axes)
    dt = cuda_build.check_operands(so, q, b)
    res = torch.empty_like(q) if emit_res else None
    nb, nx, ny = q.shape
    if nsweeps > 0 or emit_res:
        lib = cuda_build.load("planes2")
        # a pass holds as many of its lines as the shared memory takes, or
        # one line in a device-memory scratch if one does not fit (of the
        # passes that run)
        size = q.element_size()
        hx, lx, far_x = cuda_lines2.group(nx, (ny + 1) // 2, size, nx * ny)
        hy, ly, far_y = cuda_lines2.group(ny, (nx + 1) // 2, size, nx * ny)
        on_x, on_y = AXES[axes] & 1, AXES[axes] & 2
        per_plane = 0
        if (far_x and on_x) or (far_y and on_y):
            per_plane = 8 * max(
                lx * cuda_lines2.line_pad(nx, hx) if on_x else 1,
                ly * cuda_lines2.line_pad(ny, hy) if on_y else 1)
        scratch = q.new_empty((nb, per_plane)) if per_plane else None
        cuda_build.check(
            lib.cedar_line_xy_smooth2(
                dt, so.data_ptr(), q.data_ptr(), b.data_ptr(),
                None if res is None else res.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                nb, nx, ny, int(kind == StencilKind.nine_pt),
                int(updown == "up"), nsweeps, AXES[axes], hx, hy, lx, ly,
                per_plane, cuda_build.stream_of(q)),
            "line_xy_smooth2",
        )
        if axes == "xy":
            launches += 1
        else:
            line_launches += 1
    return (q, res) if emit_res else q


def smooth_plain(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                 kind: StencilKind, updown: str, nsweeps: int = 1,
                 emit_res: bool = False, sor_x=None, sor_y=None,
                 axes: str = "xy"):
    """:func:`smooth` in torch ops, on any device; ``q`` in place.
    ``sor_x`` / ``sor_y``: the batch's line factors, or None."""
    global plain_calls
    plain_calls += 1
    _check(so, q, b, kind, updown, axes)
    passes = [lambda: lines2.sweep_x_torch(so, q, b, sor_x, kind, updown),
              lambda: lines2.sweep_y_torch(so, q, b, sor_y, kind, updown)]
    passes = [p for p, a in zip(passes, "xy") if a in axes]
    if updown == "up":
        passes.reverse()
    for _ in range(nsweeps):
        for p in passes:
            p()
    if emit_res:
        return q, residual(so, q, b, kind)
    return q
