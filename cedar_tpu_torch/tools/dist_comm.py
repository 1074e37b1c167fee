"""The communication of one distributed V-cycle, predicted from the layouts
alone (no process world): the exchanges, the bytes a rank sends in them,
the gathers and the reductions that :mod:`cedar_tpu_torch.parallel.comm`
counts, beside the halo bytes of the analytic model
(:func:`cedar_tpu_torch.perf._halo_bytes`: a halo of one point, both
faces of every partitioned axis, ``nsweeps + 2`` exchanges a level).

    python3 -m cedar_tpu_torch.tools.dist_comm [--n 4096] [--ndim 2]
        [--mesh 2 2] [--itemsize 4] [--pre 1] [--post 1] [--kind 5]
        [--relax point|line-x|line-y|line-xy] [--ml] [--periodic 1 0]

prints one line for the first rank of the mesh (a corner: one neighbour
along each axis of two ranks, two along a periodic one, whose ring
closes).  It mirrors the cycle's calls: ``ncycle``'s pre-sweeps (q a
sweep, b once a level visit, halo ``H``), the residual where the sweep
does not fuse it (halo 1), the restriction (halo ``T``), the gathers
where the next level replicates an axis, the interp-add's coarse halo
(``TC``), the post-sweeps, and the norm's one all-reduce.  Line
relaxation (``--relax``): a zebra sweep along a partitioned line axis
takes the distributed SPIKE solve where :func:`cedar_tpu_torch.parallel.
lines.eligible` says so and ``--ml`` is off (each colour: q extended by
one on every partitioned axis, one interface all-gather, two K4 launches
for the interior solve), else the gather (q's cross-line axis extended by
``H``, its line axis gathered, b's once a level visit; two K4 launches);
each level's residual takes a halo of one.  ``wrap_exchanges`` counts
the exchanges along a periodic axis, ``line_gathers`` and
``spike_gathers`` the gathers of each line path, ``k4`` the K4 launches.
"""

from __future__ import annotations

import argparse

from cedar_tpu_torch.parallel.halo import TC, T, Layout
from cedar_tpu_torch.parallel.policy import level_specs
from cedar_tpu_torch.parallel.shard_relax import H

_AXES = {"point": (), "line-x": ("x",), "line-y": ("y",),
         "line-xy": ("x", "y")}


def _extend(block, parted, neighbours, h, itemsize, periodic=None):
    """(exchanges, bytes sent, wrap exchanges) of one halo_extend of width
    ``h``."""
    dims = list(block)
    ex = nbytes = wrap = 0
    for d, p in enumerate(parted):
        if not p:
            continue
        face = 1
        for e, n in enumerate(dims):
            if e != d:
                face *= n
        ex += 1
        wrap += bool(periodic and periodic[d])
        nbytes += neighbours[d] * min(h, block[d]) * face * itemsize
        dims[d] += 2 * h
    return ex, nbytes, wrap


class _Corner:
    """The mesh of :func:`predict` as :func:`lines.eligible` reads it."""

    def __init__(self, dims):
        self.shape = dict(zip(("x", "y", "z"), dims))


def predict(shapes, specs, mesh_dims, itemsize=4, pre=1, post=1,
            fine_colours=2, coarse_colours=4, relax="point", ml=False,
            periodic=None) -> dict:
    """Per-cycle counts of a V-cycle on the corner rank (coordinates 0)."""
    from cedar_tpu_torch.parallel import lines

    ndim = len(mesh_dims)
    per = tuple(periodic or ()) + (False,) * ndim
    neighbours = [0 if n <= 1 else 2 if per[d] else 1
                  for d, n in enumerate(mesh_dims)]
    out = {"exchanges": 0, "exchange_bytes": 0, "wrap_exchanges": 0,
           "gathers": 0, "line_gathers": 0, "spike_gathers": 0,
           "reductions": 1, "k4": 0, "model_halo_bytes": 0}
    L = len(shapes)
    corner = _Corner(mesh_dims)

    def parted_of(lvl):
        return [specs[lvl][d] is not None and mesh_dims[d] > 1
                for d in range(ndim)]

    def block_of(lvl):
        return [n // mesh_dims[d] if parted_of(lvl)[d] else n
                for d, n in enumerate(shapes[lvl])]

    def add(lvl, h, times=1, only=None):
        parted = parted_of(lvl)
        if only is not None:
            parted = [p and d == only for d, p in enumerate(parted)]
        ex, nb, wr = _extend(block_of(lvl), parted, neighbours, h,
                             itemsize, per)
        out["exchanges"] += ex * times
        out["exchange_bytes"] += nb * times
        out["wrap_exchanges"] += wr * times

    def layout(lvl):
        return Layout(tuple(shapes[lvl]), tuple(
            specs[lvl][d] if parted_of(lvl)[d] else None
            for d in range(ndim)), (0,) * ndim, tuple(shapes[lvl]),
            per[:ndim])

    def line_sweep(lvl, axis):
        d = 0 if axis == "x" else 1
        if not ml and lines.eligible(layout(lvl), corner, axis):
            add(lvl, 1, 2)                 # q by one, each colour
            out["gathers"] += 2
            out["spike_gathers"] += 2
            out["k4"] += 4
            return
        add(lvl, H, only=1 - d)            # q's cross-line halo
        if parted_of(lvl)[d]:
            out["gathers"] += 1
            out["line_gathers"] += 1
        out["k4"] += 2

    def line_b(lvl, axis):
        d = 0 if axis == "x" else 1
        if not ml and lines.eligible(layout(lvl), corner, axis):
            return
        add(lvl, H, only=1 - d)            # b's window, once a visit
        if parted_of(lvl)[d]:
            out["gathers"] += 1
            out["line_gathers"] += 1

    from cedar_tpu_torch.perf import _halo_bytes

    axes = _AXES[relax]
    for lvl in range(L - 1):
        colours = fine_colours if lvl == 0 else coarse_colours
        if axes:
            for axis in axes:
                line_b(lvl, axis)
            for _ in range(pre):
                for axis in axes:
                    line_sweep(lvl, axis)
            add(lvl, 1)                    # the residual
        else:
            fused = colours < H
            add(lvl, H, pre + 1)           # q each pre-sweep, b once
            if not fused:
                add(lvl, 1)                # the residual after the last one
        add(lvl, T)                        # the restriction's residual halo
        pf, pc = parted_of(lvl), parted_of(lvl + 1)
        out["gathers"] += sum(1 for d in range(ndim) if pf[d] and not pc[d])
        ex, nb, wr = _extend(block_of(lvl + 1), pc, neighbours, TC,
                             itemsize, per)
        out["exchanges"] += ex
        out["exchange_bytes"] += nb
        out["wrap_exchanges"] += wr
        if axes:
            for _ in range(post):
                for axis in reversed(axes):
                    line_sweep(lvl, axis)
            if lvl == 0:
                add(lvl, 1)                # the convergence residual
        else:
            add(lvl, H, post)              # q each post-sweep
            if lvl == 0 and not fused:
                add(lvl, 1)                # the convergence residual
        mask = sum(1 << d for d in range(ndim) if pf[d])
        out["model_halo_bytes"] += (pre + post + 2) * _halo_bytes(
            shapes[lvl], list(mesh_dims), mask, itemsize)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=4096)
    p.add_argument("--ndim", type=int, default=2)
    p.add_argument("--mesh", type=int, nargs="+", default=[2, 2])
    p.add_argument("--itemsize", type=int, default=4)
    p.add_argument("--pre", type=int, default=1)
    p.add_argument("--post", type=int, default=1)
    p.add_argument("--kind", type=int, default=5,
                   help="the fine stencil: 5, 9, 7 or 27 points")
    p.add_argument("--min-local", type=int, default=8)
    p.add_argument("--relax", default="point", choices=list(_AXES))
    p.add_argument("--ml", action="store_true",
                   help="solver.ml-relax.enabled: no SPIKE")
    p.add_argument("--periodic", type=int, nargs="+", default=[],
                   help="1 for each periodic axis, e.g. 1 1")
    args = p.parse_args(argv)
    if args.ndim == 2:
        from cedar_tpu_torch.solver.solver2 import (
            compute_num_levels, level_shapes)
    else:
        from cedar_tpu_torch.solver.solver3 import (
            compute_num_levels, level_shapes)
    dims = (args.n,) * args.ndim
    shapes = level_shapes(*dims, compute_num_levels(*dims, 3))
    from cedar_tpu_torch.parallel.dist import periodic_specs

    per = tuple(bool(p) for p in args.periodic)
    specs = level_specs(shapes, tuple(args.mesh), args.min_local)
    specs[-1] = (None,) * args.ndim
    specs = periodic_specs(specs, shapes, _Corner(args.mesh), per)
    colours = {5: 2, 7: 2, 9: 4, 27: 8}
    c = predict(shapes, specs, args.mesh, args.itemsize, args.pre,
                args.post, colours[args.kind], 4 if args.ndim == 2 else 8,
                args.relax, args.ml, per)
    print(f"{args.n}^{args.ndim} mesh {tuple(args.mesh)} V({args.pre},"
          f"{args.post}) {args.kind}-point {args.relax}"
          f"{' ml' if args.ml else ''} periodic {per}, {len(shapes)} "
          f"levels, {sum(1 for s in specs if any(s))} partitioned: {c}")


if __name__ == "__main__":
    main()
