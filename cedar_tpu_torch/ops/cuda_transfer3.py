"""K7 (restrict), K8 (interp-add) and K9 (interp): the 3D transfer kernels
(CUDA) and their plain versions.

Counterpart of :mod:`cedar_tpu.ops.pallas_transfer3` (restrict) and of the
dense-layout function of the :mod:`cedar_tpu.ops.pallas3_split` transfer
kernels (``_restrict_kernel3``, ``_interp_kernel3``,
``_interp_kernel3_nores``).  :func:`restrict`, :func:`interp_add` and
:func:`interp` launch ``csrc/transfer3.cu`` on the tensors' current
stream; :func:`restrict_plain`, :func:`interp_add_plain` and
:func:`interp_plain` compute the same functions in torch ops
(:mod:`cedar_tpu_torch.ops.interp3`), which picks one by device.

The kernels read the unpadded CI ``(26, nxc+1, nyc+1, nzc+1)`` and the
dense fine arrays; interp-add updates ``q`` in place (both versions do).
``*_launches`` count kernel launches (``*_periodic_launches`` the periodic
ones among them), ``*_plain_calls`` plain-version calls.

Each takes ``periodic`` (the JAX functions' periodic mode, which its Pallas
kernels never run: cedar_tpu/solver/cycle3.py:24-25): the restriction's
fine samples wrap around the marked axes, and the interpolations read
coarse index ``nxc`` (``nyc``, ``nzc``) as index 0; the weights' wrap
entries come from setup (:func:`cedar_tpu_torch.ops.interp3.setup_interp`).
"""

from __future__ import annotations

import torch

from cedar_tpu_torch.ops import cuda_build, interp3

restrict_launches = 0
interp_add_launches = 0
interp_launches = 0
restrict_periodic_launches = 0
interp_add_periodic_launches = 0
interp_periodic_launches = 0
restrict_plain_calls = 0
interp_add_plain_calls = 0
interp_plain_calls = 0


def _coarse_shape(ci: torch.Tensor, fine_shape) -> tuple[int, int, int]:
    if len(fine_shape) != 3:
        raise ValueError(f"fine shape {tuple(fine_shape)} is not 3D")
    nc = tuple((n - 1) // 2 + 1 for n in fine_shape)
    want = (26, nc[0] + 1, nc[1] + 1, nc[2] + 1)
    if tuple(ci.shape) != want:
        raise ValueError(
            f"ci {tuple(ci.shape)} does not interpolate to fine "
            f"{tuple(fine_shape)} (expected {want})"
        )
    return nc


def _check_qc(qc: torch.Tensor, nc) -> None:
    if tuple(qc.shape) != tuple(nc):
        raise ValueError(f"qc {tuple(qc.shape)}, expected {tuple(nc)}")


def _wrap(periodic) -> tuple[int, int, int]:
    """The periodic axes as the C entry points take them."""
    return tuple(int(bool(p)) for p in periodic)


def restrict(ci: torch.Tensor, res: torch.Tensor,
             periodic=(False, False, False)) -> torch.Tensor:
    """``cb = Pᵀ res`` on the card; returns a new ``(nxc, nyc, nzc)``
    tensor."""
    global restrict_launches, restrict_periodic_launches
    nxc, nyc, nzc = _coarse_shape(ci, res.shape)
    dt = cuda_build.check_operands(ci, res)
    lib = cuda_build.load("transfer3")
    cb = res.new_empty((nxc, nyc, nzc))
    nx, ny, nz = res.shape
    cuda_build.check(
        lib.cedar_restrict3(dt, ci.data_ptr(), res.data_ptr(), cb.data_ptr(),
                            nx, ny, nz, nxc, nyc, nzc, *_wrap(periodic),
                            cuda_build.stream_of(res)),
        "restrict3",
    )
    restrict_launches += 1
    restrict_periodic_launches += any(periodic)
    return cb


def interp_add(ci, so, qc, res, q,
               periodic=(False, False, False)) -> torch.Tensor:
    """``q += P qc + res/diag`` on the card, in place; returns ``q``."""
    global interp_add_launches, interp_add_periodic_launches
    if res.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and res {tuple(res.shape)}")
    nc = _coarse_shape(ci, q.shape)
    _check_qc(qc, nc)
    if so.ndim != 4 or tuple(so.shape[1:]) != tuple(q.shape):
        raise ValueError(f"so {tuple(so.shape)} on q {tuple(q.shape)}")
    mine = q.untyped_storage().data_ptr()
    if any(mine == t.untyped_storage().data_ptr()
           for t in (ci, so, qc, res)):
        raise ValueError("q must not share storage with an input")
    dt = cuda_build.check_operands(ci, so, qc, res, q)
    lib = cuda_build.load("transfer3")
    nx, ny, nz = q.shape
    cuda_build.check(
        lib.cedar_interp_add3(dt, ci.data_ptr(), so.data_ptr(),
                              qc.data_ptr(), res.data_ptr(), q.data_ptr(),
                              nx, ny, nz, *nc, *_wrap(periodic),
                              cuda_build.stream_of(q)),
        "interp_add3",
    )
    interp_add_launches += 1
    interp_add_periodic_launches += any(periodic)
    return q


def interp(ci: torch.Tensor, qc: torch.Tensor, fine_shape,
           periodic=(False, False, False)) -> torch.Tensor:
    """``x = P qc`` on the card; returns a new ``fine_shape`` tensor."""
    global interp_launches, interp_periodic_launches
    nc = _coarse_shape(ci, fine_shape)
    _check_qc(qc, nc)
    dt = cuda_build.check_operands(ci, qc)
    lib = cuda_build.load("transfer3")
    nx, ny, nz = fine_shape
    x = qc.new_empty((nx, ny, nz))
    cuda_build.check(
        lib.cedar_interp3(dt, ci.data_ptr(), qc.data_ptr(), x.data_ptr(), nx,
                          ny, nz, *nc, *_wrap(periodic),
                          cuda_build.stream_of(qc)),
        "interp3",
    )
    interp_launches += 1
    interp_periodic_launches += any(periodic)
    return x


def restrict_plain(ci: torch.Tensor, res: torch.Tensor,
                   periodic=(False, False, False)) -> torch.Tensor:
    """:func:`restrict` in torch ops, on any device."""
    global restrict_plain_calls
    restrict_plain_calls += 1
    _coarse_shape(ci, res.shape)
    return interp3.restrict_torch(ci, res, periodic)


def interp_add_plain(ci, so, qc, res, q,
                     periodic=(False, False, False)) -> torch.Tensor:
    """:func:`interp_add` in torch ops, on any device; ``q`` in place."""
    global interp_add_plain_calls
    interp_add_plain_calls += 1
    _check_qc(qc, _coarse_shape(ci, q.shape))
    return q.copy_(interp3.interp_add_torch(ci, so, qc, res, q, periodic))


def interp_plain(ci: torch.Tensor, qc: torch.Tensor, fine_shape,
                 periodic=(False, False, False)):
    """:func:`interp` in torch ops, on any device."""
    global interp_plain_calls
    interp_plain_calls += 1
    _check_qc(qc, _coarse_shape(ci, fine_shape))
    return interp3.interp_torch(ci, qc, tuple(fine_shape), periodic)
