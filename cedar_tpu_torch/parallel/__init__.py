"""Distributed execution over ``torch.distributed``: the PyTorch
counterpart of :mod:`cedar_tpu.parallel` (reference: include/cedar/mpi/*,
include/cedar/{2,3}d/mpi/*).

* ``grid_topo`` + MPI_Dims_create        -> :mod:`.topo` (``make_mesh``)
* MSG/Tausch halo exchange, coarse-grid gathers and the norm's reduction
                                         -> :mod:`.comm` (explicit
  ``batch_isend_irecv``, ``all_gather`` and ``all_reduce`` calls: there is
  no partitioner to insert them)
* coarse-grid redistribution/agglomeration (redist_solver.h)
                                         -> per-level partition policy
  (:mod:`.policy`), the coarsest level replicated (the redundant mode)
* the distributed ops of a cycle and its setup -> :mod:`.halo`, the sweeps
  on halo-extended shards (K1, K6) -> :mod:`.shard_relax`
* distributed solvers                    -> :mod:`.dist`
"""

from cedar_tpu_torch.parallel.dist import DistSolver2, DistSolver3
from cedar_tpu_torch.parallel.policy import level_specs
from cedar_tpu_torch.parallel.topo import make_mesh

__all__ = ["make_mesh", "level_specs", "DistSolver2", "DistSolver3"]
