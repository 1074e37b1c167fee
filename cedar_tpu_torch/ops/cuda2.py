"""K1: the 2D multicolour sweep kernel (CUDA) and its plain version.

Counterpart of :mod:`cedar_tpu.ops.pallas2`.  :func:`sweep` launches
``csrc/sweep2.cu`` once a sweep (all colour phases, and the residual with
``fuse_residual``) on the tensors' current stream, on a :func:`plan` that
this module computes from the shapes and the launch checks: a level whose
stencil planes, q and b fit one block's shared memory is swept there
(resident), every other one by the tile kernel it shares with K11
(streamed).  :func:`sweep_plain` computes the same function in torch ops
(:func:`cedar_tpu_torch.ops.relax2.sweep_torch`).
:func:`cedar_tpu_torch.ops.relax2.point_relax` picks one by device.

Both return the swept iterate in a new tensor and leave ``q`` as it
was, as the JAX function does.  ``periodic`` wraps the couplings around
the marked axes (the Pallas kernel's ``periodic`` mode); the plan does not
depend on it.  A batch of independent planes (plane relaxation's embedded
point smoothers: ``q`` and ``b`` ``(B, nx, ny)``, ``so`` ``(ndir, B, nx,
ny)``, never periodic) is one launch on the plan of one plane, each plane
swept as alone, its colours anchored to its own origin (the Pallas
sweep batched by ``pallas_call``'s vmap rule).  ``launches`` counts the
streamed launches made by :func:`sweep`, ``resident_launches`` the
resident ones, ``plain_calls`` calls of :func:`sweep_plain`;
``periodic_launches`` and ``periodic_resident_launches`` count the
periodic ones among them, ``batched_launches`` the batched ones (either
regime).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, relax2
from cedar_tpu_torch.ops.cuda_build import BLOCK_SMEM

launches = 0
resident_launches = 0
periodic_launches = 0
periodic_resident_launches = 0
batched_launches = 0
plain_calls = 0

#: threads of a resident block (csrc/sweep2.cu ``kResThreads``)
THREADS = 1024


def resident_bytes(itemsize: int, nine: bool, shape) -> int:
    """Shared memory of a resident block that holds a level's stencil
    planes (3 or 5), q and b."""
    nx, ny = shape
    return ((5 if nine else 3) + 2) * nx * ny * itemsize


@dataclass(frozen=True)
class Plan:
    """A K1 launch: resident (``smem`` the bytes of the one block that holds
    the level) or streamed (``smem`` 0: the tile kernel, on static shared
    memory)."""
    smem: int

    @property
    def resident(self) -> bool:
        return self.smem > 0


@functools.lru_cache(maxsize=256)
def plan(itemsize: int, nine: bool, shape) -> Plan:
    """The K1 launch on an ``(nx, ny)`` grid: resident where the level's
    arrays fit one block's shared memory, else streamed."""
    size = resident_bytes(itemsize, nine, shape)
    return Plan(size if size <= BLOCK_SMEM else 0)


def _check_sweep(so, q, b, kind: StencilKind, periodic=(False, False)):
    if kind not in (StencilKind.five_pt, StencilKind.nine_pt):
        # a phase updates its colour from the others' values only for
        # colourings in which no point couples to its own colour: red-black
        # 5-pt, 4-colour 9-pt
        raise ValueError(f"sweep takes 2D five_pt or nine_pt, not {kind}")
    if q.ndim not in (2, 3) or b.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and b {tuple(b.shape)}: "
                         "expected (nx, ny) or a batch (B, nx, ny)")
    if tuple(so.shape) != (kind.ndirs, *q.shape):
        raise ValueError(
            f"so {tuple(so.shape)} does not fit {kind} on {tuple(q.shape)}"
        )
    if b.data_ptr() == q.data_ptr():
        raise ValueError("b and q must not share storage")
    if q.ndim == 3 and any(periodic):
        raise ValueError("a batch of planes is never periodic")


def sweep(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
          kind: StencilKind, updown: str, fuse_residual: bool = False,
          origin=(0, 0), periodic=(False, False)):
    """One full multicolour GS sweep on the card, one launch, out of place.

    Returns the swept iterate, or ``(q_new, b - A q_new)`` with
    ``fuse_residual``; ``q`` is left as it was.  A batch ``(B, nx, ny)``
    is one launch on one plane's plan."""
    _check_sweep(so, q, b, kind, periodic)
    p = plan(q.element_size(), kind == StencilKind.nine_pt,
             tuple(q.shape[-2:]))
    return _sweep(p, so, q, b, kind, updown, fuse_residual, origin, periodic)


def _sweep(p: Plan, so, q, b, kind, updown, fuse_residual=False,
           origin=(0, 0), periodic=(False, False)):
    """:func:`sweep` on the plan ``p`` (tools/tune_fused2.py times both
    regimes at one shape)."""
    global launches, resident_launches, batched_launches
    global periodic_launches, periodic_resident_launches
    _check_sweep(so, q, b, kind, periodic)
    dt = cuda_build.check_operands(so, q, b)
    lib = cuda_build.load("sweep2")
    nine = kind == StencilKind.nine_pt
    q_out = torch.empty_like(q)
    res = torch.empty_like(q) if fuse_residual else None
    colors, ncolors = relax2.pack_colors(kind, updown)
    oz, ow = (int(o) for o in origin)
    nx, ny = q.shape[-2:]
    nb = q.shape[0] if q.ndim == 3 else 1
    cuda_build.check(
        lib.cedar_sweep2(dt, so.data_ptr(), q.data_ptr(), b.data_ptr(),
                         q_out.data_ptr(),
                         None if res is None else res.data_ptr(), nx, ny, nb,
                         int(nine), colors, ncolors, oz, ow,
                         int(fuse_residual), int(bool(periodic[0])),
                         int(bool(periodic[1])), p.smem,
                         cuda_build.stream_of(q)),
        "sweep2",
    )
    if p.resident:
        resident_launches += 1
        periodic_resident_launches += any(periodic)
    else:
        launches += 1
        periodic_launches += any(periodic)
    batched_launches += q.ndim == 3
    return (q_out, res) if fuse_residual else q_out


def sweep_plain(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                kind: StencilKind, updown: str, fuse_residual: bool = False,
                origin=(0, 0), periodic=(False, False), recip=None):
    """:func:`sweep` in torch ops, on any device; returns new tensors and
    leaves ``q`` as it was."""
    global plain_calls
    plain_calls += 1
    _check_sweep(so, q, b, kind, periodic)
    return relax2.sweep_torch(so, q, b, recip, kind, updown, fuse_residual,
                              origin, periodic)
