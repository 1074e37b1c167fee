"""Procedural, handle-based API (reference: include/cedar/capi.h).

PyTorch counterpart of :mod:`cedar_tpu.capi`, under the same names and
direction enums: topo / operator create-set-apply-dump-destroy and solver
create-run-destroy (include/cedar/2d/interface/c/{topo,operator,solver}.h,
src/2d/interface/c/solver.cc), 2D and 3D, as flat functions over integer
handles, numpy in and numpy out.

The topology carries the device the solve runs on: the topo create
functions take ``device`` (default the card, as the gallery's functions
do: ``gallery.default_device``; ``device="cpu"`` runs the plain torch
versions of the kernels).  Without a card the default raises: a handle
solve never falls back to the CPU by itself.  The operator is held in
float64 on the host, as cedar_tpu's is (``np.zeros``); solver creation
copies it to the device, and ``run`` copies ``b`` and ``x`` there (in the
operator's dtype) and the solution back.  A process mesh (``mesh=``, a
:class:`cedar_tpu_torch.parallel.topo.Mesh`; every rank of it makes the
same calls) gives distributed solvers (``DistSolver2``/``DistSolver3``,
cedar_tpu/capi.py:158-167) on the mesh's device.

Example (mirrors examples/basic-2d-ser/poisson.cc)::

    import cedar_tpu_torch.capi as capi
    topo = capi.bmg2_topo_create(256, 256)          # on the card
    op = capi.bmg2_operator_create(topo)
    capi.bmg2_operator_set(op, coords, vals)   # (i, j, dir) triples
    slv = capi.bmg2_solver_create(op)
    capi.bmg2_solver_run(slv, x, b)
    capi.bmg2_solver_destroy(slv)
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from cedar_tpu_torch.config import Config
from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.gallery import default_device
from cedar_tpu_torch.ops.stencil2 import matvec as matvec2
from cedar_tpu_torch.ops.stencil3 import matvec as matvec3
from cedar_tpu_torch.solver.solver2 import Solver2
from cedar_tpu_torch.solver.solver3 import Solver3

# direction enums (reference: 2d/base_types.h bmg2_dir, 3d cdr3_dir)
BMG2_O, BMG2_W, BMG2_S, BMG2_SW, BMG2_NW = 0, 1, 2, 3, 4
(BMG3_P, BMG3_PW, BMG3_PS, BMG3_B, BMG3_PSW, BMG3_PNW, BMG3_BW, BMG3_BNW,
 BMG3_BN, BMG3_BNE, BMG3_BE, BMG3_BSE, BMG3_BS, BMG3_BSW) = range(14)

_handles = {}
_next = itertools.count(1)


def _new(obj) -> int:
    h = next(_next)
    _handles[h] = obj
    return h


def _get(h):
    return _handles[h]


class _Topo:
    def __init__(self, shape, mesh=None, config=None, device=None):
        from cedar_tpu_torch.parallel.topo import Mesh

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError("cedar_tpu_torch: mesh must be a "
                            "cedar_tpu_torch.parallel.topo.Mesh (make_mesh)")
        self.shape = tuple(int(n) for n in shape)
        self.config = config or {}
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else default_device(
            device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "cedar_tpu_torch: no CUDA device; pass device='cpu' to "
                "solve on the CPU")


class _Op:
    def __init__(self, topo: _Topo, ndim: int):
        self.topo = topo
        self.ndim = ndim
        ndir = 5 if ndim == 2 else 14
        self.so = np.zeros((ndir,) + topo.shape)

    def kind_of(self) -> StencilKind:
        if self.ndim == 2:
            five = not (self.so[BMG2_SW].any() or self.so[BMG2_NW].any())
            return StencilKind.five_pt if five else StencilKind.nine_pt
        seven = not self.so[4:].any()
        return (
            StencilKind.seven_pt if seven
            else StencilKind.twenty_seven_pt
        )

    def tensor(self, a) -> torch.Tensor:
        """``a`` on the topology's device, in the operator's dtype."""
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=self.topo.device)

    def stencil(self) -> tuple:
        """``(so, kind)``: the planes of the stencil's kind on the
        topology's device (cedar_tpu's solvers and matvec read only
        those)."""
        kind = self.kind_of()
        return self.tensor(self.so[:kind.ndirs]), kind


# -- topo ---------------------------------------------------------------------

def bmg2_topo_create(ngx: int, ngy: int, mesh=None, config=None,
                     device=None) -> int:
    """reference: bmg2_topo_create; ``device`` (default the card) is where
    the operator's solves and applies run."""
    return _new(_Topo((ngx, ngy), mesh, config, device))


def bmg3_topo_create(ngx: int, ngy: int, ngz: int, mesh=None,
                     config=None, device=None) -> int:
    return _new(_Topo((ngx, ngy, ngz), mesh, config, device))


# -- operator -----------------------------------------------------------------

def bmg2_operator_create(topo: int) -> int:
    return _new(_Op(_get(topo), 2))


def bmg3_operator_create(topo: int) -> int:
    return _new(_Op(_get(topo), 3))


def bmg2_operator_set(op: int, coords, vals) -> None:
    """Set stencil entries; ``coords`` rows are (i, j, dir), 0-based
    interior indices (reference: bmg2_operator_set)."""
    o = _get(op)
    for (i, j, d), v in zip(coords, vals):
        o.so[int(d), int(i), int(j)] = v


def bmg3_operator_set(op: int, coords, vals) -> None:
    o = _get(op)
    for (i, j, k, d), v in zip(coords, vals):
        o.so[int(d), int(i), int(j), int(k)] = v


def bmg2_operator_set_full(op: int, so) -> None:
    """Bulk variant: the stencil planes ``so`` (no reference analogue;
    avoids per-entry loops)."""
    o = _get(op)
    so = np.asarray(so)
    o.so[: so.shape[0]] = so


bmg3_operator_set_full = bmg2_operator_set_full


def bmg2_operator_apply(op: int, x) -> np.ndarray:
    """b = A x on the topology's device (reference: bmg2_operator_apply ->
    UTILS_matvec)."""
    o = _get(op)
    mv = matvec2 if o.ndim == 2 else matvec3
    so, kind = o.stencil()
    return mv(so, o.tensor(x), kind).cpu().numpy()


bmg3_operator_apply = bmg2_operator_apply


def bmg2_operator_dump(op: int) -> np.ndarray:
    """Return the stored stencil (the reference dumps it to a file)."""
    return _get(op).so.copy()


bmg3_operator_dump = bmg2_operator_dump


def bmg2_operator_destroy(op: int) -> None:
    _handles.pop(op, None)


bmg3_operator_destroy = bmg2_operator_destroy


# -- solver -------------------------------------------------------------------

def _solver_create(op_h: int, config, ndim: int) -> int:
    o = _get(op_h)
    conf = Config(config or o.topo.config)
    if o.topo.mesh is not None:
        from cedar_tpu_torch.parallel import DistSolver2, DistSolver3

        cls = DistSolver2 if ndim == 2 else DistSolver3
        return _new(cls(*o.stencil(), conf, o.topo.mesh))
    cls = Solver2 if ndim == 2 else Solver3
    return _new(cls(*o.stencil(), conf))


def bmg2_solver_create(op: int, config=None) -> int:
    """reference: bmg2_solver_create (src/2d/interface/c/solver.cc); the
    setup runs on the topology's device."""
    return _solver_create(op, config, 2)


def bmg3_solver_create(op: int, config=None) -> int:
    return _solver_create(op, config, 3)


def bmg2_solver_run(slv: int, x, b) -> np.ndarray:
    """x = solve(b) with initial guess x (reference: bmg2_solver_run).

    Returns the solution (also written into ``x`` when it is a numpy
    array, matching the reference's in-place semantics)."""
    s = _get(slv)
    fine = s.levels[0].so

    def on(a):
        return torch.as_tensor(np.asarray(a), dtype=fine.dtype,
                               device=fine.device)

    out = s.solve(on(b), on(x)).cpu().numpy()
    if isinstance(x, np.ndarray):
        x[...] = out
    return out


bmg3_solver_run = bmg2_solver_run


def bmg2_solver_destroy(slv: int) -> None:
    _handles.pop(slv, None)


bmg3_solver_destroy = bmg2_solver_destroy
