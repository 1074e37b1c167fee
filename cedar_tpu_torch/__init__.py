"""cedar_tpu_torch — BoxMG multigrid in PyTorch with CUDA kernels for Hopper.

A port of :mod:`cedar_tpu` (JAX and Pallas on a TPU) to PyTorch on an
NVIDIA H100.  This package holds the 2D solve (point and line relaxation,
V-, W- and F-cycles) and the 3D point-relaxation solve (7- and 27-point,
V-, W- and F-cycles): Cedar-compatible config and settings, the 2D and 3D
galleries, BoxMG setup (operator-induced interpolation, Galerkin
coarsening, the dense coarse inverse) and the cycles.  On CUDA tensors the
sweeps, restriction and interpolation run hand-written CUDA C++ kernels
(``csrc/``, built at first use); on CPU tensors they run plain torch
versions of the same functions.

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
