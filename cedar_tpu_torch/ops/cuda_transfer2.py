"""K2 (restrict), K3 (interp-add) and K5 (interp): the 2D transfer kernels
(CUDA) and their plain versions.

Counterpart of :mod:`cedar_tpu.ops.pallas_transfer2` (its dense
``restrict`` / ``interp_add`` and the F-cycle's ``interp_split_nores``).
:func:`restrict`, :func:`interp_add` and :func:`interp` launch
``csrc/transfer2.cu`` on the tensors' current stream; :func:`restrict_plain`,
:func:`interp_add_plain` and :func:`interp_plain` compute the same
functions in torch ops (:mod:`cedar_tpu_torch.ops.interp2`).
:mod:`cedar_tpu_torch.ops.interp2` picks one by device.

The kernels read the unpadded CI ``(8, nxc+1, nyc+1)`` and the dense
residual; interp-add updates ``q`` in place (both versions do).  Restrict
and interp-add also take a batch of planes in one launch: ``res`` / ``q``
``(B, nx, ny)``, ``so`` ``(ndir, B, nx, ny)``, CI ``(8, B, nxc+1, nyc+1)``.
``*_launches`` count kernel launches, ``*_plain_calls`` plain-version calls.
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.ops import cuda_build, interp2

restrict_launches = 0
interp_launches = 0
interp2_launches = 0
restrict_plain_calls = 0
interp_plain_calls = 0
interp2_plain_calls = 0


def _coarse_shape(ci: torch.Tensor, fine_shape) -> tuple[int, int]:
    """The coarse grid of ``ci`` for the fine grid ``fine_shape`` (``(nx,
    ny)``, or ``(B, nx, ny)`` for a batch of planes), checked."""
    *batch, nx, ny = fine_shape
    nc = ((nx - 1) // 2 + 1, (ny - 1) // 2 + 1)
    want = (8, *batch, nc[0] + 1, nc[1] + 1)
    if tuple(ci.shape) != want:
        raise ValueError(
            f"ci {tuple(ci.shape)} does not interpolate to fine "
            f"{tuple(fine_shape)} (expected {want})"
        )
    return nc


def _batch(grid: torch.Tensor) -> int:
    """The number of planes of a ``(nx, ny)`` or ``(B, nx, ny)`` tensor."""
    if grid.ndim not in (2, 3):
        raise ValueError(f"expected (nx, ny) or (B, nx, ny), not "
                         f"{tuple(grid.shape)}")
    return grid.shape[0] if grid.ndim == 3 else 1


def restrict(ci: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """``cb = Pᵀ res`` on the card; returns a new ``(nxc, nyc)`` (or
    ``(B, nxc, nyc)``) tensor."""
    global restrict_launches
    nb = _batch(res)
    nxc, nyc = _coarse_shape(ci, res.shape)
    dt = cuda_build.check_operands(ci, res)
    lib = cuda_build.load("transfer2")
    cb = res.new_empty(res.shape[:-2] + (nxc, nyc))
    nx, ny = res.shape[-2:]
    cuda_build.check(
        lib.cedar_restrict2(dt, ci.data_ptr(), res.data_ptr(), cb.data_ptr(),
                            nx, ny, nxc, nyc, nb, cuda_build.stream_of(res)),
        "restrict2",
    )
    restrict_launches += 1
    return cb


def interp_add(ci, so, qc, res, q) -> torch.Tensor:
    """``q += P qc + res/diag`` on the card, in place; returns ``q``."""
    global interp_launches
    nb = _batch(q)
    if res.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and res {tuple(res.shape)}")
    nxc, nyc = _coarse_shape(ci, q.shape)
    if tuple(qc.shape) != q.shape[:-2] + (nxc, nyc):
        raise ValueError(f"qc {tuple(qc.shape)}, expected "
                         f"{q.shape[:-2] + (nxc, nyc)}")
    if so.ndim != q.ndim + 1 or tuple(so.shape[1:]) != tuple(q.shape):
        raise ValueError(f"so {tuple(so.shape)} on q {tuple(q.shape)}")
    if q.data_ptr() in (res.data_ptr(), qc.data_ptr(), so.data_ptr()):
        raise ValueError("q must not share storage with an input")
    dt = cuda_build.check_operands(ci, so, qc, res, q)
    lib = cuda_build.load("transfer2")
    nx, ny = q.shape[-2:]
    cuda_build.check(
        lib.cedar_interp_add2(dt, ci.data_ptr(), so.data_ptr(), qc.data_ptr(),
                              res.data_ptr(), q.data_ptr(), nx, ny, nxc, nyc,
                              nb, cuda_build.stream_of(q)),
        "interp_add2",
    )
    interp_launches += 1
    return q


def interp(ci: torch.Tensor, qc: torch.Tensor, fine_shape) -> torch.Tensor:
    """``x = P qc`` on the card; returns a new ``fine_shape`` tensor."""
    global interp2_launches
    if len(fine_shape) != 2:
        raise ValueError(f"interp takes one plane, not {tuple(fine_shape)}")
    nxc, nyc = _coarse_shape(ci, fine_shape)
    if tuple(qc.shape) != (nxc, nyc):
        raise ValueError(f"qc {tuple(qc.shape)}, expected {(nxc, nyc)}")
    dt = cuda_build.check_operands(ci, qc)
    lib = cuda_build.load("transfer2")
    nx, ny = fine_shape
    x = qc.new_empty((nx, ny))
    cuda_build.check(
        lib.cedar_interp2(dt, ci.data_ptr(), qc.data_ptr(), x.data_ptr(), nx,
                          ny, nxc, nyc, cuda_build.stream_of(qc)),
        "interp2",
    )
    interp2_launches += 1
    return x


def restrict_plain(ci: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """:func:`restrict` in torch ops, on any device."""
    global restrict_plain_calls
    restrict_plain_calls += 1
    _coarse_shape(ci, res.shape)
    return interp2.restrict_torch(ci, res)


def interp_add_plain(ci, so, qc, res, q) -> torch.Tensor:
    """:func:`interp_add` in torch ops, on any device; ``q`` in place."""
    global interp_plain_calls
    interp_plain_calls += 1
    _coarse_shape(ci, q.shape)
    return q.copy_(interp2.interp_add_torch(ci, so, qc, res, q))


def interp_plain(ci: torch.Tensor, qc: torch.Tensor, fine_shape):
    """:func:`interp` in torch ops, on any device."""
    global interp2_plain_calls
    interp2_plain_calls += 1
    nc = _coarse_shape(ci, fine_shape)
    if tuple(qc.shape) != nc:
        raise ValueError(f"qc {tuple(qc.shape)}, expected {nc}")
    return interp2.interp_torch(ci, qc, fine_shape)
