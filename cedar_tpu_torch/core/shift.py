"""Shifted-window primitives over interior-only tensors.

PyTorch counterpart of :mod:`cedar_tpu.core.shift`.  Every stencil read is a
static shifted window instead of a ghost-padded access:
``shift(a, (dz, dw))`` returns ``out[z, w] = a[z+dz, w+dw]`` with
out-of-range reads giving 0 (Dirichlet ghosts) or wrapping (periodic).
"""

from __future__ import annotations

import torch


def shift(a: torch.Tensor, offsets, periodic=None) -> torch.Tensor:
    """N-D static shift: ``out[idx] = a[idx + offsets]``.

    Out-of-range elements are 0 for non-periodic axes and wrap around for
    periodic axes.  ``offsets`` has one entry per trailing axis of ``a``;
    extra leading axes are batch axes.
    """
    noff = len(offsets)
    lead = a.ndim - noff
    if periodic is None:
        periodic = (False,) * noff

    out = a
    for ax in range(noff):
        d = int(offsets[ax])
        if d != 0 and periodic[ax]:
            out = torch.roll(out, -d, dims=lead + ax)

    if not any(int(offsets[ax]) != 0 and not periodic[ax]
               for ax in range(noff)):
        return out
    dst = [slice(None)] * lead
    src = [slice(None)] * lead
    for ax in range(noff):
        d = int(offsets[ax])
        n = a.shape[lead + ax]
        if d == 0 or periodic[ax]:
            dst.append(slice(None))
            src.append(slice(None))
        else:
            # out[z] = a[z + d] for z in [max(-d, 0), min(n - d, n))
            dst.append(slice(max(-d, 0), max(min(n - d, n), 0)))
            src.append(slice(max(d, 0), max(min(n + d, n), 0)))
    res = torch.zeros_like(a)
    res[tuple(dst)] = out[tuple(src)]
    return res


def shift2(a, dz, dw, periodic=(False, False)):
    """2D shift acting on the last two axes."""
    return shift(a, (dz, dw), periodic)


def shift3(a, d0, d1, d2, periodic=(False, False, False)):
    """3D shift acting on the last three axes."""
    return shift(a, (d0, d1, d2), periodic)


def coarse_sample(a: torch.Tensor, offsets, nc, periodic=None) -> torch.Tensor:
    """Sample a fine-grid tensor at ``fine = 2*coarse + offset``.

    Returns ``out[c0, c1, ...] = a[2*c0 + off0, 2*c1 + off1, ...]`` on the
    coarse grid of shape ``nc`` (one entry per trailing axis), with
    out-of-range fine reads 0 (or wrapped, per ``periodic``).
    """
    noff = len(offsets)
    lead = a.ndim - noff
    out = shift(a, offsets, periodic)
    slc = [slice(None)] * lead
    for ax in range(noff):
        slc.append(slice(0, 2 * nc[ax] - 1, 2))
    out = out[tuple(slc)]
    if tuple(out.shape[lead:]) == tuple(nc):
        return out
    # zero-fill where the strided slice came up short of the coarse shape
    res = out.new_zeros(out.shape[:lead] + tuple(nc))
    res[tuple([slice(None)] * lead
              + [slice(0, n) for n in out.shape[lead:]])] = out
    return res
