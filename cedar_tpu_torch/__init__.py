"""cedar_tpu_torch — BoxMG multigrid in PyTorch with CUDA kernels for Hopper.

A port of :mod:`cedar_tpu` (JAX and Pallas on a TPU) to PyTorch on an
NVIDIA H100: everything cedar_tpu does on serial grids, and its
distributed point-relaxation path.  This package holds Cedar-compatible
config and settings, the 2D and 3D galleries, BoxMG setup
(operator-induced interpolation, Galerkin coarsening, the dense coarse
inverse), and the 2D and 3D solves: point, zebra line
(``solver.ml-relax.enabled``: the full-length PCR line solve) and plane
relaxation with any plane-config, V-, W- and F-cycles, the LU or the
inner multigrid coarse solve (``cg-solver: cedar``, or ``redist``, which
a serial grid runs as the same inner solve; nested), on grids with or
without periodic axes, each solve on the card one captured CUDA graph a
cycle.  Beside them: the handle API (:mod:`cedar_tpu_torch.capi`), the
examples (:mod:`cedar_tpu_torch.examples`) and
:func:`cedar_tpu_torch.utils.timing.profile_trace`.  On CUDA tensors the
sweeps, line and plane smooths, restriction and interpolation run
hand-written CUDA C++ kernels (``csrc/``, built at first use); on CPU
tensors they run plain torch versions of the same functions.

:mod:`cedar_tpu_torch.parallel` distributes the point-relaxation solve
over ``torch.distributed`` (``DistSolver2``, ``DistSolver3`` on a
``make_mesh`` process mesh: per-level agglomeration by the coarsen,
manual or A* policy, inert padding, K1 and K6 on halo-extended shards,
the LU, ``cedar`` or ``redist`` coarse solve replicated).  Line and plane
relaxation and periodic axes under a mesh are not ported yet.

It imports neither JAX nor :mod:`cedar_tpu`.
"""

from cedar_tpu_torch.config import Config
from cedar_tpu_torch.settings import MLSettings
from cedar_tpu_torch.core.types import FivePt, NinePt, SevenPt, TwentySevenPt
from cedar_tpu_torch.solver.solver2 import Solver2
from cedar_tpu_torch.solver.solver3 import Solver3
from cedar_tpu_torch import gallery

__version__ = "0.1.0"

__all__ = [
    "Config",
    "MLSettings",
    "FivePt",
    "NinePt",
    "SevenPt",
    "TwentySevenPt",
    "Solver2",
    "Solver3",
    "gallery",
]
