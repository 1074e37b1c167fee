"""``cycle_roofline``: the least HBM bytes a cycle has to move, at the
card's peak bandwidth, over the measured ``cycle_ms``, in %.

The least bytes (:func:`cycle_bytes`) follow from the configuration alone
(its grid, stencil, relaxation, coarsening and precision), not from the
kernels, so a change that fuses, splits or removes a kernel leaves them
as they are.  Over every level, each array that a cycle reads is read
once and each array it writes is written once:

* a level above the coarsest: its stencil planes, 1/diag where point
  relaxation reads it, the right-hand side read, the iterate read and
  written, the restricted right-hand side written, and the interpolation
  weights to the next level (8 a coarse point in 2D, 26 in 3D);
* the coarsest level: its dense inverse, its right-hand side read, its
  iterate written;
* under plane relaxation, each plane's embedded 2D hierarchy, the same
  way, below its finest level (whose stencil, right-hand side and
  iterate are the 3D level's own, counted there).

Any implementation moves at least these bytes, except where an array
stays in the 50 MB L2 between cycles; the coarsest levels of a large grid
hold a small share of them.  The peak is the data sheet's, from
``peaks.json`` by the card's name; a card not listed gives no reading.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = Path(__file__).resolve().parents[1] / "peaks.json"

#: stencil planes of each stencil kind
NDIR = {"five_pt": 3, "nine_pt": 5, "seven_pt": 4, "twenty_seven_pt": 14}
#: interpolation weights a coarse point
WEIGHTS = {2: 8, 3: 26}
#: the normal axes of the planes of each plane relaxation
PLANES = {"plane-xy": (2,), "plane-xz": (1,), "plane-yz": (0,),
          "plane-xyz": (2, 1, 0)}
ITEMSIZE = {"float32": 4, "float64": 8}


def level_shapes(grid, min_coarse: int, num_levels: int = -1) -> list:
    """Cedar's hierarchy: halve (``(n - 1) // 2 + 1``) until an axis falls
    below ``min_coarse`` (``2d/solver.h:57-116``, ``3d/solver.h:68-84``),
    or to ``num_levels`` levels where that is set."""
    grid = tuple(int(n) for n in grid)
    nlev = 0
    while True:
        nlev += 1
        if min((n - 1) // (1 << nlev) + 1 for n in grid) < min_coarse:
            break
    if num_levels > 0:
        nlev = min(nlev, num_levels)
    shapes = [grid]
    for _ in range(nlev - 1):
        shapes.append(tuple((n - 1) // 2 + 1 for n in shapes[-1]))
    return shapes


def _settings(conf: dict) -> dict:
    s = conf.get("solver", {})
    return {"relaxation": s.get("relaxation", "point"),
            "min_coarse": int(s.get("min-coarse", 3)),
            "num_levels": int(s.get("num-levels", -1))}


def hierarchy_words(shapes, fine_ndir: int, coarse_ndir: int,
                    point: bool, fine: bool = True) -> int:
    """Words one cycle moves over the hierarchy ``shapes`` (see the
    module); ``fine`` False leaves out the finest level's stencil,
    right-hand side and iterate (an embedded plane hierarchy's)."""
    words = 0
    for lvl, shape in enumerate(shapes):
        n = math.prod(shape)
        own = lvl > 0 or fine
        if lvl == len(shapes) - 1:
            words += n * n + (2 * n if own else 0)
            continue
        nc = math.prod(shapes[lvl + 1])
        ndir = fine_ndir if lvl == 0 else coarse_ndir
        if own:
            words += ndir * n + 3 * n
        if point:
            words += n
        words += nc + WEIGHTS[len(shape)] * nc
    return words


def cycle_bytes(config: dict) -> int:
    """The least bytes one cycle of ``config`` moves (see the module)."""
    conf = config["solver"]
    outer = _settings(conf)
    shapes = level_shapes(config["grid"], outer["min_coarse"],
                          outer["num_levels"])
    dim = len(shapes[0])
    coarse_kind = "nine_pt" if dim == 2 else "twenty_seven_pt"
    relax = outer["relaxation"]
    words = hierarchy_words(shapes, NDIR[config["stencil"]],
                            NDIR[coarse_kind], relax == "point")
    if relax in PLANES:
        inner = _settings(conf.get("plane-config", {}))
        for shape in shapes[:-1]:
            for normal in PLANES[relax]:
                plane = [n for ax, n in enumerate(shape) if ax != normal]
                sub = level_shapes(plane, inner["min_coarse"],
                                   inner["num_levels"])
                words += shape[normal] * hierarchy_words(
                    sub, NDIR["five_pt"], NDIR["nine_pt"],
                    inner["relaxation"] == "point", fine=False)
    return words * ITEMSIZE[config["dtype"]]


def peak_bytes_per_s(kind: str) -> float | None:
    peaks = json.loads(PEAKS.read_text())
    entry = peaks.get(kind)
    return None if entry is None else float(entry["hbm_bytes_per_s"])


def read(run):
    cycle_ms = _cycle_ms(run)
    peak = peak_bytes_per_s(run.device.get("kind", ""))
    if not cycle_ms or peak is None:
        return None
    least_s = cycle_bytes(run.cell.config) / peak
    return 100.0 * least_s / (cycle_ms * 1e-3)


def _cycle_ms(run):
    from benchmark.harness import load_metric

    return load_metric("cycle_ms").read(run)
