"""Analytic cycle performance model + agglomeration-schedule search.

A copy of :mod:`cedar_tpu.perf` (the port imports nothing of the JAX
package): the counterpart of the reference's C++ performance subsystem
(src/perf/vcycle_model.cc, ss/astar.h, perf/search.cc, redist_generator).
Placements are mesh-axis subsets (sharded or replicated along each axis);
a level's cost combines memory streaming time on the largest shard,
arithmetic, and halo traffic over the interconnect; the optimal MONOTONE
agglomeration schedule (axes only dropped as levels coarsen) is found by
A* over the (level, axis-subset) DAG.  :func:`level_specs
<cedar_tpu_torch.parallel.policy.level_specs>` reads it under
``redist.search.strategy: astar``.

The hot implementation is native C++ (``cedar_tpu_torch/native/
perf_model.cc``), built with g++ at first use into
``cedar_tpu_torch/_build/`` (keyed by a hash of the source; a build goes
to a file of its own and is renamed into place, so processes that build
at once do not race); :func:`search_schedule` and :func:`cycle_time` run
the identical pure-Python model when no C++ toolchain is available, or
with ``native=False``.

:class:`MachineParams`' defaults describe one NVIDIA H100 SXM at 700 W
from its data sheet (HBM3 3.35 TB/s, NVLink 4 450 GB/s a direction, FP32
67 TFLOP/s without tensor cores); the latency of a halo message and the
fixed cost of a launched op are assumptions, not measurements.  The field
names are cedar_tpu's (``ici_*`` is the interconnect).
"""

from __future__ import annotations

import ctypes
import hashlib
import heapq
import math
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "native" / "perf_model.cc"
_BUILD = _PKG / "_build"

_lib = None
_lib_tried = False


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD / f"perf_model-{h}.so"


def _load_native():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        path = _lib_path()
        if not path.exists():
            _BUILD.mkdir(exist_ok=True)
            tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                 str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        c = ctypes
        lib.cedar_perf_cycle_time.restype = c.c_double
        lib.cedar_perf_cycle_time.argtypes = [
            c.POINTER(c.c_int64), c.c_int, c.c_int, c.c_int, c.c_int,
            c.c_int, c.POINTER(c.c_int), c.POINTER(c.c_uint),
            c.c_double, c.c_double, c.c_double, c.c_double, c.c_int,
            c.c_double,
        ]
        lib.cedar_perf_search.restype = c.c_double
        lib.cedar_perf_search.argtypes = [
            c.POINTER(c.c_int64), c.c_int, c.c_int, c.c_int, c.c_int,
            c.c_int, c.POINTER(c.c_int), c.POINTER(c.c_uint),
            c.c_double, c.c_double, c.c_double, c.c_double, c.c_int,
            c.c_double, c.POINTER(c.c_uint),
        ]
        _lib = lib
    except (OSError, subprocess.SubprocessError):
        _lib = None
    return _lib


#: H100 SXM5 80 GB at 700 W, NVIDIA H100 Tensor Core GPU data sheet
H100_HBM_BW = 3.35e12      # B/s, HBM3
H100_NVLINK_BW = 450e9     # B/s a direction (900 GB/s bidirectional)
H100_FP32_RATE = 67e12     # FLOP/s, FP32 without tensor cores
#: assumptions until a measurement on the card replaces them
LINK_LATENCY = 5e-6        # s a halo message
OP_OVERHEAD = 5e-6         # s a launched op


@dataclass
class MachineParams:
    """Machine model (reference: config "machine.*" plus device terms):
    bandwidth -> ici_bw, latency -> ici_lat, fp_perf -> 1/flop_rate, as
    cedar_tpu reads them; the defaults are the H100's above."""

    hbm_bw: float = H100_HBM_BW
    ici_bw: float = H100_NVLINK_BW
    ici_lat: float = LINK_LATENCY
    flop_rate: float = H100_FP32_RATE
    op_overhead: float = OP_OVERHEAD

    @classmethod
    def from_config(cls, conf) -> "MachineParams":
        return cls(
            hbm_bw=conf.get("machine.hbm-bandwidth", H100_HBM_BW),
            ici_bw=conf.get("machine.bandwidth", H100_NVLINK_BW),
            ici_lat=conf.get("machine.latency", LINK_LATENCY),
            flop_rate=1.0 / conf.get("machine.fp_perf", 1.0 / H100_FP32_RATE),
            op_overhead=conf.get("machine.overhead", OP_OVERHEAD),
        )


def _pad3(shape):
    return tuple(shape) + (1,) * (3 - len(shape))


def _shard_points(shape, mesh, mask):
    pts = 1
    for d, n in enumerate(shape):
        if mask >> d & 1:
            n = -(-n // mesh[d])
        pts *= n
    return pts


def _halo_bytes(shape, mesh, mask, bpe):
    total = 0
    for d in range(len(shape)):
        if not (mask >> d & 1) or mesh[d] <= 1:
            continue
        face = 1
        for e, n in enumerate(shape):
            if e == d:
                continue
            if mask >> e & 1:
                n = -(-n // mesh[e])
            face *= n
        total += 2 * face * bpe
    return total


def _level_time(shape, stencil, nsweeps, mesh, mask, m, bpe):
    pts = _shard_points(shape, mesh, mask)
    planes = (stencil + 1) // 2 + 1
    passes = nsweeps + 3
    hbm_t = pts * bpe * (planes + 3) * passes / m.hbm_bw
    comp_t = 2.0 * stencil * pts * passes / m.flop_rate
    comm_t = 0.0
    hb = _halo_bytes(shape, mesh, mask, bpe)
    if hb:
        comm_t = (nsweeps + 2) * (hb / m.ici_bw + m.ici_lat)
    return max(hbm_t, comp_t) + comm_t + passes * m.op_overhead


def _cg_solve_time(shape, mesh, mask, m, bpe):
    """Direct coarse solve: dense inverse applied by matmul on the
    REPLICATED coarse system (the implementation always replicates the
    coarsest level — "redundant" mode); the TPU analogue of the
    reference's DPBTRS term (src/perf/vcycle_model.cc:162 tcgsolve).
    Mask-independent by construction."""
    del mask
    pts = _shard_points(shape, mesh, 0)
    comp_t = 2.0 * pts * pts / m.flop_rate
    hbm_t = pts * pts * bpe / m.hbm_bw
    return max(hbm_t, comp_t) + m.op_overhead


def _agglom_time(shape, mesh, from_mask, to_mask, m, bpe):
    dropped = from_mask & ~to_mask
    if not dropped:
        return 0.0
    shard = _shard_points(shape, mesh, from_mask) * bpe
    t = 0.0
    for d in range(len(shape)):
        if not (dropped >> d & 1) or mesh[d] <= 1:
            continue
        p = mesh[d]
        t += shard * (p - 1.0) / m.ici_bw + (p - 1.0) * m.ici_lat
        shard *= p
    return t


def cycle_time(shapes, mesh, masks, machine: MachineParams,
               stencil_fine=5, stencil_coarse=9, nsweeps=3,
               dtype_bytes=4, native: bool = True) -> float:
    """Predicted seconds per V-cycle for a fixed per-level mask schedule."""
    lib = _load_native() if native else None
    nlevels = len(shapes)
    ndim = len(shapes[0])
    if lib is not None:
        flat = (ctypes.c_int64 * (3 * nlevels))(
            *[v for s in shapes for v in _pad3(s)]
        )
        cmesh = (ctypes.c_int * ndim)(*mesh)
        cmasks = (ctypes.c_uint * nlevels)(*masks)
        return lib.cedar_perf_cycle_time(
            flat, nlevels, ndim, stencil_fine, stencil_coarse, nsweeps,
            cmesh, cmasks,
            ctypes.c_double(machine.hbm_bw), ctypes.c_double(machine.ici_bw),
            ctypes.c_double(machine.ici_lat),
            ctypes.c_double(machine.flop_rate), dtype_bytes,
            ctypes.c_double(machine.op_overhead),
        )
    total = 0.0
    for lvl, shape in enumerate(shapes):
        st = stencil_fine if lvl == 0 else stencil_coarse
        if lvl == nlevels - 1:
            total += _cg_solve_time(shape, mesh, masks[lvl], machine,
                                    dtype_bytes)
        else:
            total += _level_time(shape, st, nsweeps, mesh, masks[lvl],
                                 machine, dtype_bytes)
        if lvl + 1 < nlevels:
            # agglomeration gathers the COARSE level's data; the coarsest
            # level is always replicated (redundant coarse solve)
            to = 0 if lvl + 1 == nlevels - 1 else masks[lvl + 1]
            total += _agglom_time(shapes[lvl + 1], mesh, masks[lvl],
                                  to, machine, dtype_bytes)
    return total


def search_schedule(shapes, mesh, allowed, machine: MachineParams,
                    stencil_fine=5, stencil_coarse=9, nsweeps=3,
                    dtype_bytes=4, native: bool = True):
    """Optimal monotone agglomeration schedule (A*).

    ``allowed[l]`` is a bitmask of mesh axes that may be sharded at level
    l (divisibility/minimum-size constraints); the coarsest level is
    always replicated (redundant coarse solve), so its allowed mask is
    forced to 0.  Returns (masks, seconds).
    """
    lib = _load_native() if native else None
    nlevels = len(shapes)
    ndim = len(shapes[0])
    if lib is not None:
        flat = (ctypes.c_int64 * (3 * nlevels))(
            *[v for s in shapes for v in _pad3(s)]
        )
        cmesh = (ctypes.c_int * ndim)(*mesh)
        callow = (ctypes.c_uint * nlevels)(*allowed)
        out = (ctypes.c_uint * nlevels)()
        cost = lib.cedar_perf_search(
            flat, nlevels, ndim, stencil_fine, stencil_coarse, nsweeps,
            cmesh, callow,
            ctypes.c_double(machine.hbm_bw), ctypes.c_double(machine.ici_bw),
            ctypes.c_double(machine.ici_lat),
            ctypes.c_double(machine.flop_rate), dtype_bytes,
            ctypes.c_double(machine.op_overhead), out,
        )
        return list(out), cost

    # pure-Python A* (identical model)
    nmasks = 1 << ndim

    def lt(lvl, mask):
        if lvl == nlevels - 1:
            return _cg_solve_time(shapes[lvl], mesh, mask, machine,
                                  dtype_bytes)
        st = stencil_fine if lvl == 0 else stencil_coarse
        return _level_time(shapes[lvl], st, nsweeps, mesh, mask, machine,
                           dtype_bytes)

    h = [0.0] * (nlevels + 1)
    full = nmasks - 1
    for lvl in range(nlevels - 1, -1, -1):
        st = stencil_fine if lvl == 0 else stencil_coarse
        pts = _shard_points(shapes[lvl], mesh, full)
        planes = (st + 1) // 2 + 1
        est = pts * dtype_bytes * (planes + 3) * (
            nsweeps + 3) / machine.hbm_bw
        if lvl == nlevels - 1:
            est = 0.0  # the direct coarse solve may be cheaper
        h[lvl] = h[lvl + 1] + est

    dist = {}
    parent = {}
    openq = []
    allow0 = 0 if nlevels == 1 else allowed[0]
    for mk in range(nmasks):
        if mk & ~allow0:
            continue
        c = lt(0, mk)
        dist[(1, mk)] = c
        parent[(1, mk)] = mk
        heapq.heappush(openq, (c + h[1], 1, mk))
    best = (math.inf, 0)
    while openq:
        f, lvl, mask = heapq.heappop(openq)
        if f - h[lvl] > dist[(lvl, mask)] + 1e-18:
            continue
        if lvl == nlevels:
            best = (dist[(lvl, mask)], mask)
            break
        # coarsest level: always replicated (redundant coarse solve)
        allow_l = 0 if lvl == nlevels - 1 else allowed[lvl]
        for mk in range(nmasks):
            if mk & ~allow_l or mk & ~mask:
                continue
            step = _agglom_time(shapes[lvl], mesh, mask, mk, machine,
                                dtype_bytes) + lt(lvl, mk)
            c = dist[(lvl, mask)] + step
            if c < dist.get((lvl + 1, mk), math.inf):
                dist[(lvl + 1, mk)] = c
                parent[(lvl + 1, mk)] = mask
                heapq.heappush(openq, (c + h[lvl + 1], lvl + 1, mk))
    masks = [0] * nlevels
    mk = best[1]
    for lvl in range(nlevels, 0, -1):
        masks[lvl - 1] = mk
        mk = parent[(lvl, mk)]
    return masks, best[0]
