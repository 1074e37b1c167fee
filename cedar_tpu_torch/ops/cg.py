"""Coarsest-grid direct solve, 2D and 3D.

PyTorch counterpart of :mod:`cedar_tpu.ops.cg`.  The reference factors a
banded copy of the coarsest operator with LAPACK (BMG2_SymStd_SETUP_cg_LU.f90,
BMG2_SymStd_SOLVE_cg.f90); here the dense matrix is assembled once at setup,
inverted through its Cholesky factor, and applied each cycle as one small
matrix-vector product.  These are library calls
(``torch.linalg.cholesky``, ``solve_triangular``, ``@``), as the JAX
package leaves them to XLA.

A float32 product on the card runs in full float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False; it is PyTorch's default,
and :func:`solve_cg` sets it explicitly so that a caller's global switch
cannot turn the coarse solve into TF32.

A batch of independent operators (plane relaxation's embedded 2D
hierarchies: ``so`` ``(ndir, B, n1, n2)``) gives a batch of inverses
``(B, n, n)``, factored by the batched library calls, and :func:`solve_cg`
applies them to ``b`` ``(B, n1, n2)`` as one batched product.
"""

from __future__ import annotations

import numpy as np
import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import stencil2, stencil3


def assemble_dense(so: torch.Tensor, kind: StencilKind,
                   periodic=None) -> torch.Tensor:
    """Dense row-form matrix of the operator over 2 or 3 axes, x-fastest
    ordering (x, then y, then z: the reference's KK loop,
    SETUP_cg_LU.f90:116-144); ``(*batch, n, n)`` for a batched ``so``.
    A neighbour across an axis marked in ``periodic`` wraps around
    (cedar_tpu/ops/cg.py:35-70)."""
    dims = kind.ndim
    if periodic is None:
        periodic = (False,) * dims
    stencil = stencil2 if dims == 2 else stencil3
    af = stencil.full_offsets(so, kind, periodic)
    nshape = tuple(so.shape[-dims:])
    batch = tuple(so.shape[1:-dims])
    n = int(np.prod(nshape))
    strides = [int(np.prod(nshape[:d])) for d in range(dims)]
    idx = np.indices(nshape)
    flat = torch.as_tensor(
        sum(idx[d] * strides[d] for d in range(dims)).reshape(-1),
        device=so.device,
    )
    mat = so.new_zeros(batch + (n, n))
    flat_mat = mat.view(-1, n, n)
    bidx = torch.arange(flat_mat.shape[0], device=so.device)[:, None]
    for off, field in af.items():
        nb_flat = np.zeros(nshape, np.int64)
        valid = np.ones(nshape, bool)
        for d in range(dims):
            nb_d = idx[d] + off[d]
            if periodic[d]:
                nb_d = nb_d % nshape[d]
            else:
                valid &= (nb_d >= 0) & (nb_d < nshape[d])
            nb_flat += np.clip(nb_d, 0, nshape[d] - 1) * strides[d]
        col = torch.as_tensor(nb_flat.reshape(-1), device=so.device)
        vals = torch.where(
            torch.as_tensor(valid.reshape(-1), device=so.device),
            field.reshape(-1, n), field.new_zeros(()),
        )
        flat_mat.index_put_((bidx, flat[None], col[None]), vals,
                            accumulate=True)
    return mat


def setup_cg_lu(so: torch.Tensor, kind: StencilKind,
                indefinite: bool = False, periodic=None) -> torch.Tensor:
    """Assemble, (shift,) and invert the coarse operator.  Returns A⁻¹.
    ``indefinite`` (the fully periodic singular case) adds the last
    diagonal entry once more, the reference's rank-deficiency shift."""
    mat = assemble_dense(so, kind, periodic)
    if indefinite:
        # reference: ABD(last,last) += SO(coarse last interior, KO)
        mat[..., -1, -1] += so[0].reshape(mat.shape[:-2] + (-1,))[..., -1]
    chol = torch.linalg.cholesky(mat)
    eye = torch.eye(mat.shape[-1], dtype=mat.dtype, device=mat.device)
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.linalg.solve_triangular(chol.mT, y, upper=True)


def solve_cg(ainv: torch.Tensor, b: torch.Tensor,
             subtract_mean: bool = False) -> torch.Tensor:
    """x = A⁻¹ b on the coarsest grid, any dimension (x-fastest
    flattening: the axes reversed); a batch ``ainv`` ``(B, n, n)`` solves
    ``b`` ``(B, n1, n2)`` plane by plane.  ``subtract_mean`` removes the
    mean of x (of each plane), the reference's projection off the null
    space of a singular operator (SOLVE_cg.f90:124-141)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if ainv.ndim == 3:
        bt = b.transpose(-1, -2).reshape(b.shape[0], -1, 1)
        x = torch.bmm(ainv, bt).reshape(b.shape[0], b.shape[2], b.shape[1])
        x = x.transpose(-1, -2).contiguous()
        if subtract_mean:
            x = x - x.mean(dim=(-2, -1), keepdim=True)
        return x
    axes = tuple(reversed(range(b.ndim)))
    x = (ainv @ b.permute(axes).reshape(-1))
    x = x.reshape(tuple(reversed(b.shape))).permute(axes).contiguous()
    if subtract_mean:
        x = x - torch.mean(x)
    return x
