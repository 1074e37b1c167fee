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
residual; interp-add updates ``q`` in place (both versions do).
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
    nx, ny = fine_shape
    nc = ((nx - 1) // 2 + 1, (ny - 1) // 2 + 1)
    if tuple(ci.shape) != (8, nc[0] + 1, nc[1] + 1):
        raise ValueError(
            f"ci {tuple(ci.shape)} does not interpolate to fine "
            f"{tuple(fine_shape)} (expected {(8, nc[0] + 1, nc[1] + 1)})"
        )
    return nc


def restrict(ci: torch.Tensor, res: torch.Tensor) -> torch.Tensor:
    """``cb = Pᵀ res`` on the card; returns a new ``(nxc, nyc)`` tensor."""
    global restrict_launches
    if res.ndim != 2:
        raise ValueError(f"res must be 2D, not {tuple(res.shape)}")
    nxc, nyc = _coarse_shape(ci, res.shape)
    dt = cuda_build.check_operands(ci, res)
    lib = cuda_build.load("transfer2")
    cb = res.new_empty((nxc, nyc))
    nx, ny = res.shape
    cuda_build.check(
        lib.cedar_restrict2(dt, ci.data_ptr(), res.data_ptr(), cb.data_ptr(),
                            nx, ny, nxc, nyc, cuda_build.stream_of(res)),
        "restrict2",
    )
    restrict_launches += 1
    return cb


def interp_add(ci, so, qc, res, q) -> torch.Tensor:
    """``q += P qc + res/diag`` on the card, in place; returns ``q``."""
    global interp_launches
    if q.ndim != 2 or res.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and res {tuple(res.shape)}")
    nxc, nyc = _coarse_shape(ci, q.shape)
    if tuple(qc.shape) != (nxc, nyc):
        raise ValueError(f"qc {tuple(qc.shape)}, expected {(nxc, nyc)}")
    if so.ndim != 3 or tuple(so.shape[1:]) != tuple(q.shape):
        raise ValueError(f"so {tuple(so.shape)} on q {tuple(q.shape)}")
    if q.data_ptr() in (res.data_ptr(), qc.data_ptr(), so.data_ptr()):
        raise ValueError("q must not share storage with an input")
    dt = cuda_build.check_operands(ci, so, qc, res, q)
    lib = cuda_build.load("transfer2")
    nx, ny = q.shape
    cuda_build.check(
        lib.cedar_interp_add2(dt, ci.data_ptr(), so.data_ptr(), qc.data_ptr(),
                              res.data_ptr(), q.data_ptr(), nx, ny, nxc, nyc,
                              cuda_build.stream_of(q)),
        "interp_add2",
    )
    interp_launches += 1
    return q


def interp(ci: torch.Tensor, qc: torch.Tensor, fine_shape) -> torch.Tensor:
    """``x = P qc`` on the card; returns a new ``fine_shape`` tensor."""
    global interp2_launches
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
