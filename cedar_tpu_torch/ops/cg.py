"""Coarsest-grid direct solve, 2D.

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
"""

from __future__ import annotations

import numpy as np
import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops.stencil2 import full_offsets


def assemble_dense(so: torch.Tensor, kind: StencilKind) -> torch.Tensor:
    """Dense row-form matrix of the operator, x-fastest ordering (the
    reference's KK loop, SETUP_cg_LU.f90:116-144)."""
    af = full_offsets(so, kind)
    nshape = tuple(so.shape[1:])
    n = int(np.prod(nshape))
    strides = [1, nshape[0]]
    idx = np.indices(nshape)
    flat = torch.as_tensor(
        (idx[0] * strides[0] + idx[1] * strides[1]).reshape(-1),
        device=so.device,
    )
    mat = so.new_zeros((n, n))
    for off, field in af.items():
        nb_flat = np.zeros(nshape, np.int64)
        valid = np.ones(nshape, bool)
        for d in range(2):
            nb_d = idx[d] + off[d]
            valid &= (nb_d >= 0) & (nb_d < nshape[d])
            nb_flat += np.clip(nb_d, 0, nshape[d] - 1) * strides[d]
        col = torch.as_tensor(nb_flat.reshape(-1), device=so.device)
        vals = torch.where(
            torch.as_tensor(valid.reshape(-1), device=so.device),
            field.reshape(-1), field.new_zeros(()),
        )
        mat.index_put_((flat, col), vals, accumulate=True)
    return mat


def setup_cg_lu(so: torch.Tensor, kind: StencilKind,
                indefinite: bool = False) -> torch.Tensor:
    """Assemble, (shift,) and invert the coarse operator.  Returns A⁻¹."""
    mat = assemble_dense(so, kind)
    if indefinite:
        # reference: ABD(last,last) += SO(coarse last interior, KO)
        mat[-1, -1] += so[0].reshape(-1)[-1]
    chol = torch.linalg.cholesky(mat)
    eye = torch.eye(mat.shape[0], dtype=mat.dtype, device=mat.device)
    y = torch.linalg.solve_triangular(chol, eye, upper=False)
    return torch.linalg.solve_triangular(chol.T, y, upper=True)


def solve_cg(ainv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A⁻¹ b on the coarsest grid (x-fastest flattening)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = (ainv @ b.T.reshape(-1)).reshape(b.shape[1], b.shape[0]).T
    return x.contiguous()
