"""Multilevel solver settings.

Mirrors the reference's `ml_settings` (reference:
include/cedar/multilevel_settings.h:28-50, src/multilevel_settings.cc:15-61)
including all defaults, so that Cedar `config.json` files drive this
framework unchanged.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from cedar_tpu_torch.config import Config


class RelaxType(enum.Enum):
    point = "point"
    line_x = "line-x"
    line_y = "line-y"
    line_xy = "line-xy"
    plane_xy = "plane-xy"
    plane_xz = "plane-xz"
    plane_yz = "plane-yz"
    plane_xyz = "plane-xyz"


class CycleType(enum.Enum):
    v = "v"
    f = "f"


class CGType(enum.Enum):
    lu = "LU"          # direct (Cholesky) solve on the coarsest grid
    serial = "cedar"   # a (replicated) inner multigrid solver
    redist = "redist"  # agglomerate onto a smaller submesh, recurse


class RedistSearch(enum.Enum):
    manual = "manual"
    coarsen = "coarsen"
    astar = "astar"


@dataclass
class RedistSettings:
    """Reference: redist_settings::init (src/multilevel_settings.cc:102-125)."""

    search_strat: RedistSearch = RedistSearch.coarsen
    path: list = field(default_factory=list)
    min_coarse: int = 3
    machine_bandwidth: float = 177e6
    machine_latency: float = 6.5e-7
    machine_fprate: float = 4.4e-10

    @classmethod
    def from_config(cls, conf: Config) -> "RedistSettings":
        s = cls()
        strat = conf.get("redist.search.strategy", "coarsen")
        try:
            s.search_strat = RedistSearch(strat)
        except ValueError:
            raise ValueError(f"Search strategy not recognized: {strat}")
        if s.search_strat == RedistSearch.manual:
            s.path = conf.getnvec("redist.search.path")
        if s.search_strat == RedistSearch.astar:
            s.min_coarse = conf.get("solver.min-coarse", 3)
            s.machine_bandwidth = conf.get("machine.bandwidth", 177e6)
            s.machine_latency = conf.get("machine.latency", 6.5e-7)
            s.machine_fprate = conf.get("machine.fp_perf", 4.4e-10)
        return s


@dataclass
class MLSettings:
    """Reference: ml_settings::init (src/multilevel_settings.cc:15-61).

    Defaults match the reference exactly: relaxation "point", cycle "v",
    nrelax-pre 2, nrelax-post 1, num-levels -1 (auto), max-iter 10,
    tol 1e-8, min_coarse 3, cg-solver "LU".
    """

    relaxation: RelaxType = RelaxType.point
    cycle: CycleType = CycleType.v
    nrelax_pre: int = 2
    nrelax_post: int = 1
    num_levels: int = -1
    maxiter: int = 10
    tol: float = 1e-8
    min_coarse: int = 3
    coarse_solver: CGType = CGType.lu
    # symmetric relaxation: post-smoothing reverses the sweep order (the
    # reference's IRELAX_SYM UP/DOWN branches in BMG2_SymStd_relax_GS.f90;
    # exposed here as a config knob — kernel_params.h:11-46 carries the flag
    # but the reference's setup code hardcodes it true)
    relax_symmetric: bool = True
    # multilevel line relaxation (reference: solver.ml-relax.* selecting the
    # log-depth "n-level" line solves of include/cedar/2d/mpi/ml_relax.h over
    # the two-level gather).  enabled=True solves every line of 64 points
    # or more by the full-length PCR (ops/lines2.pcr_stride with ``full``,
    # cedar_tpu's ``_pcr_solve``) in the line kernels K4 and K10 and their
    # plain versions; enabled=False (the default) by PCR to a short stride,
    # then Thomas on the interleaved systems; under a mesh enabled=True
    # also keeps the lines off the distributed SPIKE solve (the gather of
    # whole lines on every level, cedar_tpu/parallel/dist.py:292-301).
    # min-gsz and factorize are parsed and read by nothing, in cedar_tpu
    # too (its settings parse them; no solve reads them).
    ml_relax_enabled: bool = False
    ml_relax_min_gsz: int = 3
    ml_relax_factorize: bool = True
    coarse_config: Config | None = None
    rsettings: RedistSettings | None = None
    plane_settings: "MLSettings | None" = None
    cg_settings: "MLSettings | None" = None  # inner solver (cg-solver != LU)
    # "xla" | "pallas": resolved from config "kernels.backend" by the
    # solver constructors (ops/backend.resolve: "auto" picks pallas, the
    # hand-written kernels, on the card); "xla" runs the plain torch
    # versions of the kernels on either device
    kernel_backend: str = "xla"
    # fine-level lane-parity-split resident cycle (ops.pallas2_split).
    # "auto" resolves per backend at solver construction; explicit
    # true/false forces it on/off for supported shapes.
    fine_split: bool = False
    # how many top levels stay lane-parity-split resident (>=1 when
    # fine_split; resolved from "kernels.split-levels")
    split_levels: int = 1

    #: safety backstop on cg-config recursion (the reference recurses until
    #: the process count reaches 1; config nesting is finite in practice)
    MAX_NEST = 12

    @classmethod
    def from_config(cls, conf: Config, _depth: int = 0) -> "MLSettings":
        s = cls()
        relax = conf.get("solver.relaxation", "point")
        try:
            s.relaxation = RelaxType(relax)
        except ValueError:
            raise ValueError(f"invalid relaxation type: {relax}")

        cyc = conf.get("solver.cycle.type", "v")
        try:
            s.cycle = CycleType(cyc)
        except ValueError:
            raise ValueError(f"invalid cycle type: {cyc}")

        s.nrelax_pre = conf.get("solver.cycle.nrelax-pre", 2)
        s.nrelax_post = conf.get("solver.cycle.nrelax-post", 1)
        s.num_levels = conf.get("solver.num-levels", -1)
        s.maxiter = conf.get("solver.max-iter", 10)
        s.tol = conf.get("solver.tol", 1e-8)
        # NB: the reference reads "solver.min_coarse" (underscore), not the
        # schema's "min-coarse" (src/multilevel_settings.cc:42); we accept
        # both, underscore first, to stay behavior-compatible.
        s.min_coarse = conf.get(
            "solver.min_coarse", conf.get("solver.min-coarse", 3)
        )

        s.relax_symmetric = conf.get("solver.relax-symmetric", True)

        # explicit backend in a (possibly nested) config; "auto" resolves
        # at solver construction (device-dependent), so leave the default
        kb = conf.get("kernels.backend", None)
        if kb in ("xla", "pallas"):
            s.kernel_backend = kb

        s.ml_relax_enabled = conf.get("solver.ml-relax.enabled", False)
        s.ml_relax_min_gsz = conf.get("solver.ml-relax.min-gsz", 3)
        s.ml_relax_factorize = conf.get("solver.ml-relax.factorize", True)

        cg = conf.get("solver.cg-solver", "LU")
        try:
            s.coarse_solver = CGType(cg)
        except ValueError:
            raise ValueError("invalid value for solver.cg-solver")
        if _depth >= cls.MAX_NEST:
            raise ValueError(
                f"cg-config nesting exceeds {cls.MAX_NEST} levels"
            )

        explicit_cg_conf = conf.getconf("cg-config")
        s.coarse_config = explicit_cg_conf
        if s.coarse_config is None:
            s.coarse_config = conf.getconf("")

        if s.coarse_solver == CGType.redist:
            s.rsettings = RedistSettings.from_config(conf)

        if s.coarse_solver != CGType.lu:
            # inner multigrid solver on the coarsest grid, configured by the
            # nested cg-config (reference: multilevel_settings.cc:55-57).
            # Nesting recurses arbitrarily when cg-configs are explicit
            # (reference: test/2d/mpi/test-cgredist-1.json nests to depth 3,
            # include/cedar/2d/mpi/redist_solver.h:35-102); when the inner
            # config is just the inherited outer config, its coarse solve is
            # forced direct — the reference's recursion terminates because
            # the process count shrinks to 1, which has no analogue here.
            if explicit_cg_conf is not None:
                inner_conf = explicit_cg_conf
            else:
                inner_conf = conf.getconf("")
                inner_conf.set("solver.cg-solver", "LU")
            s.cg_settings = MLSettings.from_config(
                inner_conf, _depth=_depth + 1
            )

        if s.relaxation in (RelaxType.plane_xy, RelaxType.plane_xz,
                            RelaxType.plane_yz, RelaxType.plane_xyz):
            pconf = conf.getconf("plane-config")
            if pconf is None:
                # reference default plane config (src/kernel_params.cc:72-78)
                pconf = Config({
                    "solver": {"relaxation": "line-xy", "max-iter": 1},
                })
            s.plane_settings = MLSettings.from_config(pconf)
        return s

    def __str__(self) -> str:
        lines = [
            "",
            "-------------------",
            "Multilevel Settings",
            "-------------------",
            f"coarse solver:   {self.coarse_solver.name}",
            f"relaxation:      {self.relaxation.value}",
            f"cycle:           {self.cycle.value.upper()}",
            f"min coarse:      {self.min_coarse}",
            f"nrelax pre:      {self.nrelax_pre}",
            f"nrelax post:     {self.nrelax_post}",
            f"maxiter:         {self.maxiter}",
            f"tol:             {self.tol}",
        ]
        return "\n".join(lines)
