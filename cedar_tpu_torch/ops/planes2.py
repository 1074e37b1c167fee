"""Whole line-xy smooths over a batch of independent 2D planes.

PyTorch counterpart of :mod:`cedar_tpu.ops.pallas_planes2`
(``line_xy_smooth``, ``line_xy_nsmooth_res``): the smoothing of the
embedded 2D cycles of 3D plane relaxation (:mod:`cedar_tpu_torch.ops.
planes3`), where every level is a batch of planes (``so`` ``(ndir, B, nx,
ny)``, ``q`` and ``b`` ``(B, nx, ny)``).

Each function dispatches by device, as
:func:`cedar_tpu_torch.ops.lines2.line_relax_x` does: a CUDA tensor goes
to kernel K10 (:mod:`cedar_tpu_torch.ops.cuda_planes2`, one launch for all
sweeps of all planes), a CPU tensor to its plain version.  Both update
``q`` IN PLACE.  ``sor_x`` / ``sor_y`` (:func:`~cedar_tpu_torch.ops.
lines2.setup_lines` factors of the batch, or None) feed the CPU path only.
:func:`line_nsmooth` runs the zebra x-line or y-line sweeps alone (K10's
one-direction mode on the card: the batched K4 of line-x and line-y plane
smoothers).
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind


def line_nsmooth(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                 kind: StencilKind, updown: str, nsweeps: int, axes: str,
                 emit_res: bool = False, sor_x=None, sor_y=None,
                 full: bool = False):
    """``nsweeps`` smooths of every plane along ``axes`` ("x": zebra
    x-line sweeps, "y": y-line sweeps, "xy": line-xy smooths), IN PLACE on
    ``q``, with the residual ``b - A q`` in the same launch where
    ``emit_res``; ``full`` (``solver.ml-relax.enabled``): the lines take
    the full-length PCR.  Returns ``q`` or ``(q, res)``."""
    from cedar_tpu_torch.ops import cuda_planes2

    if q.is_cuda:
        return cuda_planes2.smooth(so, q, b, kind, updown, nsweeps, emit_res,
                                   axes, full)
    if q.device.type != "cpu":
        raise NotImplementedError(f"no line smooth for tensors on "
                                  f"{q.device}")
    return cuda_planes2.smooth_plain(so, q, b, kind, updown, nsweeps,
                                     emit_res, sor_x, sor_y, axes, full)


def line_xy_smooth(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                   kind: StencilKind, updown: str, nsweeps: int = 1,
                   sor_x=None, sor_y=None) -> torch.Tensor:
    """``nsweeps`` line-xy smooths of every plane (x zebra then y zebra
    DOWN, y then x UP), IN PLACE on ``q``; returns ``q``."""
    return line_nsmooth(so, q, b, kind, updown, nsweeps, "xy", False, sor_x,
                        sor_y)


def line_xy_nsmooth_res(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                        kind: StencilKind, updown: str, nsweeps: int,
                        sor_x=None, sor_y=None):
    """:func:`line_xy_smooth`, then the residual ``b - A q`` in the same
    launch.  Returns ``(q, res)``."""
    return line_nsmooth(so, q, b, kind, updown, nsweeps, "xy", True, sor_x,
                        sor_y)
