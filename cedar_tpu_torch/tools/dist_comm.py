"""The communication of one distributed V-cycle, predicted from the layouts
alone (no process world): the exchanges, the bytes a rank sends in them,
the gathers and the reductions that :mod:`cedar_tpu_torch.parallel.comm`
counts, beside the halo bytes of the analytic model
(:func:`cedar_tpu_torch.perf._halo_bytes`: a halo of one point, both
faces of every partitioned axis, ``nsweeps + 2`` exchanges a level).

    python3 -m cedar_tpu_torch.tools.dist_comm [--n 4096] [--ndim 2]
        [--mesh 2 2] [--itemsize 4] [--pre 1] [--post 1] [--kind 5]

prints one line for the first rank of the mesh (a corner: one neighbour
along each axis of two ranks).  It mirrors the cycle's calls:
``ncycle``'s pre-sweeps (q a sweep, b once a level visit, halo ``H``),
the residual where the sweep does not fuse it (halo 1), the restriction
(halo ``T``), the gathers where the next level replicates an axis, the
interp-add's coarse halo (``TC``), the post-sweeps, and the norm's one
all-reduce.
"""

from __future__ import annotations

import argparse

from cedar_tpu_torch.parallel.halo import TC, T
from cedar_tpu_torch.parallel.policy import level_specs
from cedar_tpu_torch.parallel.shard_relax import H


def _extend(block, parted, neighbours, h, itemsize):
    """(exchanges, bytes sent) of one halo_extend of width ``h``."""
    dims = list(block)
    ex = nbytes = 0
    for d, p in enumerate(parted):
        if not p:
            continue
        face = 1
        for e, n in enumerate(dims):
            if e != d:
                face *= n
        ex += 1
        nbytes += neighbours[d] * min(h, block[d]) * face * itemsize
        dims[d] += 2 * h
    return ex, nbytes


def predict(shapes, specs, mesh_dims, itemsize=4, pre=1, post=1,
            fine_colours=2, coarse_colours=4) -> dict:
    """Per-cycle counts of a V-cycle on the corner rank (coordinates 0)."""
    ndim = len(mesh_dims)
    neighbours = [1 if n > 1 else 0 for n in mesh_dims]
    out = {"exchanges": 0, "exchange_bytes": 0, "gathers": 0,
           "reductions": 1, "model_halo_bytes": 0}
    L = len(shapes)

    def parted_of(lvl):
        return [specs[lvl][d] is not None and mesh_dims[d] > 1
                for d in range(ndim)]

    def block_of(lvl):
        return [n // mesh_dims[d] if parted_of(lvl)[d] else n
                for d, n in enumerate(shapes[lvl])]

    def add(lvl, h, times=1):
        ex, nb = _extend(block_of(lvl), parted_of(lvl), neighbours, h,
                         itemsize)
        out["exchanges"] += ex * times
        out["exchange_bytes"] += nb * times

    from cedar_tpu_torch.perf import _halo_bytes

    for lvl in range(L - 1):
        colours = fine_colours if lvl == 0 else coarse_colours
        fused = colours < H
        add(lvl, H, pre + 1)          # q each pre-sweep, b once
        if not fused:
            add(lvl, 1)               # the residual after the last one
        add(lvl, T)                   # the restriction's residual halo
        pf, pc = parted_of(lvl), parted_of(lvl + 1)
        out["gathers"] += sum(1 for d in range(ndim) if pf[d] and not pc[d])
        ex, nb = _extend(block_of(lvl + 1), pc, neighbours, TC, itemsize)
        out["exchanges"] += ex
        out["exchange_bytes"] += nb
        add(lvl, H, post)             # q each post-sweep
        if lvl == 0 and not fused:
            add(lvl, 1)               # the convergence residual
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
    args = p.parse_args(argv)
    if args.ndim == 2:
        from cedar_tpu_torch.solver.solver2 import (
            compute_num_levels, level_shapes)
    else:
        from cedar_tpu_torch.solver.solver3 import (
            compute_num_levels, level_shapes)
    dims = (args.n,) * args.ndim
    shapes = level_shapes(*dims, compute_num_levels(*dims, 3))
    specs = level_specs(shapes, tuple(args.mesh), args.min_local)
    specs[-1] = (None,) * args.ndim
    colours = {5: 2, 7: 2, 9: 4, 27: 8}
    c = predict(shapes, specs, args.mesh, args.itemsize, args.pre,
                args.post, colours[args.kind], 4 if args.ndim == 2 else 8)
    print(f"{args.n}^{args.ndim} mesh {tuple(args.mesh)} V({args.pre},"
          f"{args.post}) {args.kind}-point, {len(shapes)} levels, "
          f"{sum(1 for s in specs if any(s))} partitioned: {c}")


if __name__ == "__main__":
    main()
