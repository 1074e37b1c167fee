"""K6: the 3D multicolour sweep kernel (CUDA) and its plain version.

Counterpart of :mod:`cedar_tpu.ops.pallas3` (``_sweep_kernel`` and its
(x, y)-tiled ``_sweep2d_kernel``).  :func:`sweep` launches
``csrc/sweep3.cu`` once per colour phase (2 for 7-point, 8 for 27-point)
and once more for the fused residual, on the tensors' current stream;
:func:`sweep_plain` computes the same function in torch ops
(:func:`cedar_tpu_torch.ops.relax3.sweep3_torch`).
:func:`cedar_tpu_torch.ops.relax3.point_relax` picks one by device.

Both update ``q`` in place.  ``launches`` counts kernel launches made by
:func:`sweep`, ``plain_calls`` calls of :func:`sweep_plain`.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, relax3

launches = 0
plain_calls = 0


def _shares_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _check_sweep(so, q, b, kind: StencilKind) -> None:
    if kind not in (StencilKind.seven_pt, StencilKind.twenty_seven_pt):
        # in-place phases are race-free only for colourings in which no
        # point couples to its own colour: red-black 7-pt, 8-colour 27-pt
        raise ValueError(f"sweep takes 3D seven_pt or twenty_seven_pt, "
                         f"not {kind}")
    if q.ndim != 3 or b.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and b {tuple(b.shape)}")
    if tuple(so.shape) != (kind.ndirs, *q.shape):
        raise ValueError(
            f"so {tuple(so.shape)} does not fit {kind} on {tuple(q.shape)}"
        )
    if _shares_storage(q, b) or _shares_storage(q, so):
        raise ValueError("q must not share storage with so or b")


def sweep(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
          kind: StencilKind, updown: str, fuse_residual: bool = False,
          origin=(0, 0, 0)):
    """One full multicolour GS sweep on the card, ``q`` updated in place.

    Returns ``q``, or ``(q, res)`` with ``fuse_residual``."""
    global launches
    _check_sweep(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    lib = cuda_build.load("sweep3")
    stream = cuda_build.stream_of(q)
    nx, ny, nz = q.shape
    ts = int(kind == StencilKind.twenty_seven_pt)
    ox, oy, oz = (int(o) for o in origin)
    for color in relax3.color_order(kind, updown):
        cuda_build.check(
            lib.cedar_sweep3_phase(dt, so.data_ptr(), q.data_ptr(),
                                   b.data_ptr(), nx, ny, nz, ts, color, ox,
                                   oy, oz, stream),
            "sweep3 phase",
        )
        launches += 1
    if not fuse_residual:
        return q
    res = torch.empty_like(q)
    cuda_build.check(
        lib.cedar_residual3(dt, so.data_ptr(), q.data_ptr(), b.data_ptr(),
                            res.data_ptr(), nx, ny, nz, ts, stream),
        "sweep3 residual",
    )
    launches += 1
    return q, res


def sweep_plain(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                kind: StencilKind, updown: str, fuse_residual: bool = False,
                origin=(0, 0, 0), recip=None):
    """:func:`sweep` in torch ops, on any device; ``q`` updated in place."""
    global plain_calls
    plain_calls += 1
    _check_sweep(so, q, b, kind)
    out = relax3.sweep3_torch(so, q, b, recip, kind, updown, fuse_residual,
                              origin)
    if fuse_residual:
        return q.copy_(out[0]), out[1]
    return q.copy_(out)
