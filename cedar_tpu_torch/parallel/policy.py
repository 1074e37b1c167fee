"""Per-level partition policy — coarse-grid redistribution (reference:
include/cedar/2d/mpi/redist_solver.h, include/cedar/perf/predict.h
`choose_redist`).

PyTorch counterpart of :mod:`cedar_tpu.parallel.policy`.  A level is
block-partitioned over a mesh axis or replicated along it; its
specification is a tuple with, per spatial axis, the mesh axis name it is
partitioned over or None (cedar_tpu's ``PartitionSpec`` as a plain
tuple).  The "coarsen" strategy drops mesh axes one by one as local
extents shrink below ``min_local``; the coarsest levels run fully
replicated (the reference's redundant mode).

Cited behavior: redistribution decision thresholds
(src/multilevel_settings.cc:102-125), redundant solve mode
(2d/mpi/redist_solver.h:330-347).
"""

from __future__ import annotations


def _mesh_axes(mesh, ndim):
    """``(axis names, extents)`` of a :class:`~cedar_tpu_torch.parallel.
    topo.Mesh`, or of a plain tuple of extents (axes 'x', 'y'[, 'z'])."""
    if hasattr(mesh, "axis_names"):
        names = tuple(mesh.axis_names)
        return names, tuple(mesh.shape[a] for a in names)
    dims = tuple(int(n) for n in mesh)
    return ("x", "y", "z")[:len(dims)], dims


def level_specs(shapes, mesh, min_local: int = 8, strategy: str = "coarsen",
                path=None, machine_params=None) -> list[tuple]:
    """The partition of each level of the given shapes: per level a tuple
    of mesh axis names or None.

    strategy "coarsen": partition spatial axis d over mesh axis d while
    the local extent stays >= min_local and divides evenly; replicate
    below that.  strategy "manual": ``path`` lists per-level mesh-axis
    usage as the per-axis process counts (reference
    test/2d/mpi/test-cgredist-1.json), mapped to use/drop of each axis,
    levels past its end taking its last entry.  strategy "astar": the
    A*-searched schedule of the analytic machine model
    (:mod:`cedar_tpu_torch.perf`; reference: perf_factory::astar_vcycle +
    ss/astar.h).  ``mesh`` is a Mesh or a tuple of mesh extents.
    """
    ndim = len(shapes[0])
    axes, dims = _mesh_axes(mesh, ndim)

    def feasible(lvl, d):
        """divisible, and a local extent of at least min_local (cedar_tpu/
        parallel/policy.py:47-53)"""
        nd = dims[d]
        shape = shapes[lvl]
        return nd > 1 and shape[d] % nd == 0 and shape[d] // nd >= min_local

    if strategy == "astar":
        from cedar_tpu_torch.perf import MachineParams, search_schedule

        machine = machine_params or MachineParams()
        allowed = [
            sum(1 << d for d in range(ndim) if feasible(lvl, d))
            for lvl in range(len(shapes))
        ]
        masks, _ = search_schedule(
            shapes, list(dims[:ndim]), allowed, machine,
            stencil_fine=5 if ndim == 2 else 7,
            stencil_coarse=9 if ndim == 2 else 27,
        )
        return [tuple(axes[d] if mask >> d & 1 else None
                      for d in range(ndim)) for mask in masks]

    specs = []
    for lvl in range(len(shapes)):
        names = []
        for d in range(ndim):
            use = feasible(lvl, d)
            if strategy == "manual" and path is not None:
                ent = path[min(lvl, len(path) - 1)]
                use = use and (d < len(ent) and ent[d] >= dims[d])
            names.append(axes[d] if use else None)
        specs.append(tuple(names))
    return specs
