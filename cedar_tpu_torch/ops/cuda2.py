"""K1: the 2D multicolour sweep kernel (CUDA) and its plain version.

Counterpart of :mod:`cedar_tpu.ops.pallas2`.  :func:`sweep` launches
``csrc/sweep2.cu`` once per colour phase (and once more for the fused
residual) on the tensors' current stream; :func:`sweep_plain` computes the
same function in torch ops (:func:`cedar_tpu_torch.ops.relax2.sweep_torch`).
:func:`cedar_tpu_torch.ops.relax2.point_relax` picks one by device.

Both update ``q`` in place.  ``launches`` counts kernel launches made by
:func:`sweep`, ``plain_calls`` calls of :func:`sweep_plain`.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, relax2

launches = 0
plain_calls = 0


def _check_sweep(so, q, b, kind: StencilKind) -> None:
    if kind not in (StencilKind.five_pt, StencilKind.nine_pt):
        # in-place phases are race-free only for colourings in which no
        # point couples to its own colour: red-black 5-pt, 4-colour 9-pt
        raise ValueError(f"sweep takes 2D five_pt or nine_pt, not {kind}")
    if q.ndim != 2 or b.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and b {tuple(b.shape)}")
    if tuple(so.shape) != (kind.ndirs, *q.shape):
        raise ValueError(
            f"so {tuple(so.shape)} does not fit {kind} on {tuple(q.shape)}"
        )
    if b.data_ptr() == q.data_ptr():
        raise ValueError("b and q must not share storage")


def sweep(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
          kind: StencilKind, updown: str, fuse_residual: bool = False,
          origin=(0, 0)):
    """One full multicolour GS sweep on the card, ``q`` updated in place.

    Returns ``q``, or ``(q, res)`` with ``fuse_residual``."""
    global launches
    _check_sweep(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    lib = cuda_build.load("sweep2")
    stream = cuda_build.stream_of(q)
    nx, ny = q.shape
    nine = int(kind == StencilKind.nine_pt)
    oz, ow = (int(o) for o in origin)
    for c in relax2.color_order(kind, updown):
        color = 2 * c[0] + c[1] if nine else c
        cuda_build.check(
            lib.cedar_sweep2_phase(dt, so.data_ptr(), q.data_ptr(),
                                   b.data_ptr(), nx, ny, nine, color, oz, ow,
                                   stream),
            "sweep2 phase",
        )
        launches += 1
    if not fuse_residual:
        return q
    res = torch.empty_like(q)
    cuda_build.check(
        lib.cedar_residual2(dt, so.data_ptr(), q.data_ptr(), b.data_ptr(),
                            res.data_ptr(), nx, ny, nine, stream),
        "sweep2 residual",
    )
    launches += 1
    return q, res


def sweep_plain(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                kind: StencilKind, updown: str, fuse_residual: bool = False,
                origin=(0, 0), recip=None):
    """:func:`sweep` in torch ops, on any device; ``q`` updated in place."""
    global plain_calls
    plain_calls += 1
    _check_sweep(so, q, b, kind)
    out = relax2.sweep_torch(so, q, b, recip, kind, updown, fuse_residual,
                             origin)
    if fuse_residual:
        return q.copy_(out[0]), out[1]
    return q.copy_(out)
