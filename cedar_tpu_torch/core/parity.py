"""Parity (even/odd) grid decomposition, 2D and 3D.

PyTorch counterpart of :mod:`cedar_tpu.core.parity`.  The JAX package
builds these from reshapes because a double-strided slice is a lane gather
on the TPU; here strided views and strided writes are plain indexing.
"""

from __future__ import annotations

import torch

# channel order: (z parity, w parity)
_PARITIES = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _split_axis(a: torch.Tensor, axis: int):
    """(…, n, …) -> (even, odd) subgrids along ``axis``."""
    even = [slice(None)] * a.ndim
    odd = [slice(None)] * a.ndim
    even[axis] = slice(0, None, 2)
    odd[axis] = slice(1, None, 2)
    return a[tuple(even)], a[tuple(odd)]


def deinterleave2(a: torch.Tensor):
    """Split (..., nx, ny) into parity subgrids over the last two axes
    (leading axes are batch axes).

    Returns dict ``(pz, pw) -> subgrid`` with shapes
    ``(ceil/floor(nx/2), ceil/floor(ny/2))`` according to parity.
    """
    out = {}
    for pz, r in zip((0, 1), _split_axis(a, -2)):
        out[(pz, 0)], out[(pz, 1)] = _split_axis(r, -1)
    return out


def interleave2(parts: dict, nx: int, ny: int) -> torch.Tensor:
    """Merge parity subgrids back into a (..., nx, ny) tensor (missing -> 0)."""
    ref = next(v for v in parts.values() if v is not None)
    out = ref.new_zeros(ref.shape[:-2] + (nx, ny))
    for pz, pw in _PARITIES:
        v = parts.get((pz, pw))
        if v is not None:
            out[..., pz::2, pw::2] = v
    return out


def deinterleave3(a: torch.Tensor):
    """Split (nx, ny, nz) into its eight parity subgrids: dict
    ``(p0, p1, p2) -> subgrid``."""
    out = {}
    for p0, r0 in zip((0, 1), _split_axis(a, 0)):
        for p1, r1 in zip((0, 1), _split_axis(r0, 1)):
            out[(p0, p1, 0)], out[(p0, p1, 1)] = _split_axis(r1, 2)
    return out


def interleave3(parts: dict, n0: int, n1: int, n2: int) -> torch.Tensor:
    """Merge 3D parity subgrids back into (n0, n1, n2) (missing -> 0)."""
    ref = next(v for v in parts.values() if v is not None)
    out = ref.new_zeros((n0, n1, n2))
    for (p0, p1, p2), v in parts.items():
        if v is not None:
            out[p0::2, p1::2, p2::2] = v
    return out


def subgrid_sample_nd(sub: torch.Tensor, deltas, out_shape):
    """``out[c] = sub[c + d]`` over the last ``len(deltas)`` axes (leading
    axes are batch axes), zero outside, padded/cropped to ``out_shape``
    (coarse grid)."""
    lead = sub.ndim - len(deltas)
    out = sub.new_zeros(tuple(sub.shape[:lead]) + tuple(out_shape))
    dst, src = [Ellipsis], [Ellipsis]
    for d, n_out, n_sub in zip(deltas, out_shape, sub.shape[lead:]):
        lo = max(-d, 0)
        hi = min(n_out, n_sub - d)
        if hi <= lo:
            return out
        dst.append(slice(lo, hi))
        src.append(slice(lo + d, hi + d))
    out[tuple(dst)] = sub[tuple(src)]
    return out


def subgrid_sample(sub: torch.Tensor, dz: int, dw: int, out_shape):
    """``out[z, w] = sub[z + dz, w + dw]``, zero outside, padded/cropped to
    ``out_shape`` (coarse grid)."""
    return subgrid_sample_nd(sub, (dz, dw), out_shape)
