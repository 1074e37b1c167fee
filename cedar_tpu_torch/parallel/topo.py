"""Process-mesh topology (reference: include/cedar/mpi/grid_topo.h,
src/2d/util/topo.cc, include/cedar/decomp.h).

PyTorch counterpart of :mod:`cedar_tpu.parallel.topo`.  cedar_tpu's mesh
is a ``jax.sharding.Mesh`` of devices; here it is a Cartesian grid of the
ranks of a ``torch.distributed`` process group, one process a rank, each
on its own device: :class:`Mesh` holds the axis names, the mesh shape,
this rank's coordinates, its neighbour ranks along each axis and the
subgroups of each mesh row and column (for gathers along one axis).  Rank
``r`` sits at ``numpy.unravel_index(r, shape)``, the order of cedar_tpu's
``devices.reshape(shape)``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

AXES2 = ("x", "y")
AXES3 = ("x", "y", "z")


def balanced_dims(n: int, ndim: int) -> tuple[int, ...]:
    """Near-balanced factorization of ``n`` into ``ndim`` factors.

    Greedy largest-prime-first assignment to the currently smallest factor —
    the same balancing goal as the reference's `grid_decomp`
    (include/cedar/decomp.h:57-86) / MPI_Dims_create.
    """
    factors = []
    m = n
    p = 2
    while p * p <= m:
        while m % p == 0:
            factors.append(p)
            m //= p
        p += 1
    if m > 1:
        factors.append(m)
    dims = [1] * ndim
    for f in sorted(factors, reverse=True):
        dims[int(np.argmin(dims))] *= f
    return tuple(sorted(dims, reverse=True))


def block_low(index: int, nblocks: int, n: int) -> int:
    """Low global index of a contiguous block partition
    (reference: include/cedar/mpi/block_partition.h:8-34)."""
    return (index * n) // nblocks


def block_size(index: int, nblocks: int, n: int) -> int:
    return block_low(index + 1, nblocks, n) - block_low(index, nblocks, n)


def block_owner(gidx: int, nblocks: int, n: int) -> int:
    return (nblocks * (gidx + 1) - 1) // n


@dataclass
class Mesh:
    """A Cartesian grid of the ranks of ``group`` (None: the default
    group).

    ``shape`` maps each axis name to its extent (as a JAX mesh's does),
    ``dims`` is the same as a tuple, ``coords`` this rank's coordinates,
    ``neighbours[name]`` the ``(previous, next)`` global ranks along an
    axis (None at the mesh edge), ``ring[name]`` the same around the ring
    of the axis (a periodic axis: the last rank's next is the first; None
    on an axis of one rank), ``axis_groups[name]`` the subgroup of
    the ranks that share every other coordinate with this one.
    ``backend`` is the group's own; ``staged`` says that collectives on
    CUDA tensors go through the host (gloo, which lacks them), which
    :mod:`cedar_tpu_torch.parallel.comm` does openly and counts.
    """

    axis_names: tuple
    dims: tuple
    rank: int
    coords: tuple
    device: torch.device
    group: object = None
    backend: str = "gloo"
    ranks: tuple = ()
    neighbours: dict = field(default_factory=dict)
    ring: dict = field(default_factory=dict)
    axis_groups: dict = field(default_factory=dict)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return int(np.prod(self.dims))

    @property
    def staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def coord(self, name: str) -> int:
        return self.coords[self.axis_names.index(name)]


def default_device(device=None) -> torch.device:
    """``device``, or the card of this process's local rank
    (``cuda:{LOCAL_RANK % device_count}``): raises where there is none,
    unless the caller passes a CPU device."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "cedar_tpu_torch: no CUDA device; pass device='cpu' to run the "
            "mesh on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(ndim: int, group=None, shape=None, device=None) -> Mesh:
    """An ``ndim``-axis mesh (axes 'x', 'y'[, 'z']) of the ranks of
    ``group`` (default: the default process group, which must be
    initialised).  ``shape`` overrides the balanced factorization (the
    analogue of the reference's explicit ``grid.np``); ``device`` (default
    the card of the local rank) is where this rank's blocks live.

    Every rank of ``group`` must call it, in the same order as its other
    collective calls: it creates the subgroups of the mesh rows and
    columns.
    """
    if not dist.is_initialized():
        raise RuntimeError("cedar_tpu_torch: make_mesh needs an initialised "
                           "torch.distributed process group")
    ranks = tuple(dist.get_process_group_ranks(group)
                  if group is not None else range(dist.get_world_size()))
    n = len(ranks)
    shape = balanced_dims(n, ndim) if shape is None else tuple(shape)
    if len(shape) != ndim or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks in {ndim} axes")
    names = AXES2 if ndim == 2 else AXES3
    me = dist.get_rank()
    grid = np.asarray(ranks).reshape(shape)
    coords = tuple(int(c) for c in np.argwhere(grid == me)[0])
    backend = dist.get_backend(group)
    mesh = Mesh(names, shape, me, coords, default_device(device), group,
                backend, ranks)
    for d, name in enumerate(names):
        c = coords[d]
        idx = list(coords)

        def at(i):
            idx[d] = i
            return int(grid[tuple(idx)])

        mesh.neighbours[name] = (at(c - 1) if c > 0 else None,
                                 at(c + 1) if c + 1 < shape[d] else None)
        mesh.ring[name] = ((at((c - 1) % shape[d]), at((c + 1) % shape[d]))
                           if shape[d] > 1 else (None, None))
        # every rank creates every subgroup, in the same order
        lines = np.moveaxis(grid, d, -1).reshape(-1, shape[d])
        for line in lines:
            g = (dist.new_group([int(r) for r in line], backend=backend)
                 if shape[d] > 1 else None)
            if me in line:
                mesh.axis_groups[name] = g
    return mesh
