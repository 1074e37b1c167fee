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
residual; interp-add updates ``q`` in place (both versions do).  All
three also take a batch of planes in one launch: ``res`` / ``q`` / ``x``
``(B, nx, ny)``, ``qc`` ``(B, nxc, nyc)``, ``so`` ``(ndir, B, nx, ny)``,
CI ``(8, B, nxc+1, nyc+1)`` (K5 a grid z over the planes).
``*_launches`` count kernel launches (``*_periodic_launches`` the periodic
ones among them, ``interp2_batched_launches`` K5's batched ones),
``*_plain_calls`` plain-version calls.
Each takes ``periodic``: the restriction's fine samples wrap around the
marked axes, and the interpolations read coarse index ``nxc`` (``nyc``) as
index 0; the weights' wrap entries come from setup
(:func:`cedar_tpu_torch.ops.interp2.setup_interp`).

Restrict and interp-add launch on a :func:`plan` that this module computes
from the shapes and the launch checks: segments of lanes over consecutive
coarse columns of one row of one plane, the rows of every plane one after
the other, so that a block of small planes holds several whole planes.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from cedar_tpu_torch.ops import cuda_build, interp2

restrict_launches = 0
interp_launches = 0
interp2_launches = 0
restrict_periodic_launches = 0
interp_periodic_launches = 0
interp2_periodic_launches = 0
interp2_batched_launches = 0
restrict_plain_calls = 0
interp_plain_calls = 0
interp2_plain_calls = 0


#: threads a K2 or K3 block, largest first: :func:`plan` takes the largest
#: whose launch still has a block for every SM
THREADS = (256, 128, 64)
#: the H100's SMs
N_SM = 132


@dataclass(frozen=True)
class Plan:
    """A K2 or K3 launch (csrc/transfer2.cu checks it): segments of ``seg``
    lanes (a power of two up to a warp) over consecutive coarse columns of
    one row, ``nseg`` segments a row; blocks of ``threads`` threads, that
    is ``threads // seg`` rows; a grid of ``(nseg, gy)`` blocks over
    ``rows`` rows: K2's coarse rows, ``B * nxc``, or K3's cell rows, ``B *
    (nxc + 1)`` (cell k holds fine rows 2k-1 and 2k)."""
    seg: int
    nseg: int
    threads: int
    gy: int
    rows: int

    @property
    def regime(self) -> str:
        """``packed`` where a warp holds several rows (planes of at most 16
        coarse columns), else ``strip`` (a warp a row segment)."""
        return "packed" if self.seg < 32 else "strip"

    @property
    def blocks(self) -> int:
        return self.nseg * self.gy


@functools.lru_cache(maxsize=512)
def plan(kernel: str, shape, n_sm: int = N_SM) -> Plan:
    """The launch of K2 (``kernel`` ``"restrict"``) or K3
    (``"interp_add"``) on a ``(B, nx, ny)`` batch of fine planes: a segment
    of the smallest power of two lanes that holds the ``nyc`` coarse
    columns, at most a warp; the most threads a block that still give each
    of ``n_sm`` SMs a block."""
    nb, nx, ny = shape
    nxc, nyc = (nx - 1) // 2 + 1, (ny - 1) // 2 + 1
    if kernel not in ("restrict", "interp_add"):
        raise ValueError(f"no transfer plan for {kernel!r}")
    rows = nb * (nxc if kernel == "restrict" else nxc + 1)
    seg = min(32, 1 << (nyc - 1).bit_length())
    nseg = -(-nyc // seg)
    for threads in THREADS:
        gy = -(-rows // (threads // seg))
        if nseg * gy >= n_sm:
            break
    if gy > 65535:
        raise ValueError(f"{kernel} on {tuple(shape)}: {gy} blocks of rows")
    return Plan(seg, nseg, threads, gy, rows)


def _planes(grid: torch.Tensor) -> tuple[int, int, int]:
    """``(B, nx, ny)`` of a ``(nx, ny)`` or ``(B, nx, ny)`` tensor."""
    return (_batch(grid), *grid.shape[-2:])


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


def _wrap(periodic) -> tuple[int, int]:
    """The periodic axes as the C entry points take them."""
    return int(bool(periodic[0])), int(bool(periodic[1]))


def restrict(ci: torch.Tensor, res: torch.Tensor,
             periodic=(False, False)) -> torch.Tensor:
    """``cb = Pᵀ res`` on the card; returns a new ``(nxc, nyc)`` (or
    ``(B, nxc, nyc)``) tensor."""
    global restrict_launches, restrict_periodic_launches
    nb = _batch(res)
    nxc, nyc = _coarse_shape(ci, res.shape)
    dt = cuda_build.check_operands(ci, res)
    lib = cuda_build.load("transfer2")
    cb = res.new_empty(res.shape[:-2] + (nxc, nyc))
    nx, ny = res.shape[-2:]
    p = plan("restrict", _planes(res), cuda_build.n_sm(res.device))
    cuda_build.check(
        lib.cedar_restrict2(dt, ci.data_ptr(), res.data_ptr(), cb.data_ptr(),
                            nx, ny, nxc, nyc, nb, *_wrap(periodic), p.seg,
                            p.nseg, p.threads, p.gy,
                            cuda_build.stream_of(res)),
        "restrict2",
    )
    restrict_launches += 1
    restrict_periodic_launches += any(periodic)
    return cb


def interp_add(ci, so, qc, res, q, periodic=(False, False)) -> torch.Tensor:
    """``q += P qc + res/diag`` on the card, in place; returns ``q``."""
    global interp_launches, interp_periodic_launches
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
    p = plan("interp_add", _planes(q), cuda_build.n_sm(q.device))
    cuda_build.check(
        lib.cedar_interp_add2(dt, ci.data_ptr(), so.data_ptr(), qc.data_ptr(),
                              res.data_ptr(), q.data_ptr(), nx, ny, nxc, nyc,
                              nb, *_wrap(periodic), p.seg, p.nseg, p.threads,
                              p.gy, cuda_build.stream_of(q)),
        "interp_add2",
    )
    interp_launches += 1
    interp_periodic_launches += any(periodic)
    return q


def _check_interp(ci, qc, fine_shape) -> tuple[int, int]:
    """The coarse shape of ``x = P qc`` on ``fine_shape`` (``(nx, ny)`` or
    ``(B, nx, ny)``), checked."""
    if len(fine_shape) not in (2, 3):
        raise ValueError(f"interp takes (nx, ny) or (B, nx, ny), not "
                         f"{tuple(fine_shape)}")
    nc = _coarse_shape(ci, fine_shape)
    want = tuple(fine_shape[:-2]) + nc
    if tuple(qc.shape) != want:
        raise ValueError(f"qc {tuple(qc.shape)}, expected {want}")
    return nc


def interp(ci: torch.Tensor, qc: torch.Tensor, fine_shape,
           periodic=(False, False)) -> torch.Tensor:
    """``x = P qc`` on the card; returns a new ``fine_shape`` tensor (a
    batch ``(B, nx, ny)``: one launch)."""
    global interp2_launches, interp2_periodic_launches
    global interp2_batched_launches
    nxc, nyc = _check_interp(ci, qc, fine_shape)
    dt = cuda_build.check_operands(ci, qc)
    lib = cuda_build.load("transfer2")
    nx, ny = fine_shape[-2:]
    nb = fine_shape[0] if len(fine_shape) == 3 else 1
    x = qc.new_empty(tuple(fine_shape))
    cuda_build.check(
        lib.cedar_interp2(dt, ci.data_ptr(), qc.data_ptr(), x.data_ptr(), nx,
                          ny, nxc, nyc, nb, *_wrap(periodic),
                          cuda_build.stream_of(qc)),
        "interp2",
    )
    interp2_launches += 1
    interp2_periodic_launches += any(periodic)
    interp2_batched_launches += len(fine_shape) == 3
    return x


def restrict_plain(ci: torch.Tensor, res: torch.Tensor,
                   periodic=(False, False)) -> torch.Tensor:
    """:func:`restrict` in torch ops, on any device."""
    global restrict_plain_calls
    restrict_plain_calls += 1
    _coarse_shape(ci, res.shape)
    return interp2.restrict_torch(ci, res, periodic)


def interp_add_plain(ci, so, qc, res, q,
                     periodic=(False, False)) -> torch.Tensor:
    """:func:`interp_add` in torch ops, on any device; ``q`` in place."""
    global interp_plain_calls
    interp_plain_calls += 1
    _coarse_shape(ci, q.shape)
    return q.copy_(interp2.interp_add_torch(ci, so, qc, res, q, periodic))


def interp_plain(ci: torch.Tensor, qc: torch.Tensor, fine_shape,
                 periodic=(False, False)):
    """:func:`interp` in torch ops, on any device."""
    global interp2_plain_calls
    interp2_plain_calls += 1
    _check_interp(ci, qc, fine_shape)
    return interp2.interp_torch(ci, qc, fine_shape, periodic)
