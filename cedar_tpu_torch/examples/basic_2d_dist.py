"""Distributed 2D Poisson over a process mesh (reference:
examples/basic-2d-mpi/poisson.cc); the counterpart of cedar_tpu's
``examples/basic_2d_dist.py``.

The grid is block-partitioned over a 2-axis mesh of all the ranks; coarse
levels agglomerate by the A*-searched schedule
(``redist.search.strategy: astar``).  Prints the mesh, each level's
partition, the error against the analytic solution and "Finished Test",
as cedar_tpu's example does.  Run:

    torchrun --nproc-per-node N -m cedar_tpu_torch.examples.basic_2d_dist \\
        [nx ny] [--backend nccl|gloo] [--device cpu]
    python -m cedar_tpu_torch.examples.basic_2d_dist [nx ny] --spawn N \\
        [--device cpu|cuda]

``--spawn N`` starts its own world of N processes over gloo (on the card,
the gloo messages go through the host); under ``torchrun`` each rank's
device is the card of its local rank unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from cedar_tpu_torch import FivePt, gallery
from cedar_tpu_torch.config import Config
from cedar_tpu_torch.parallel import DistSolver2, make_mesh
from cedar_tpu_torch.parallel.launch import init_from_env, spawn


def _spec(spec) -> str:
    """A level's partition as cedar_tpu prints its ``PartitionSpec``."""
    return f"PartitionSpec({', '.join(repr(a) for a in spec)})"


def run(rank: int, nx: int, ny: int, device=None) -> list[str]:
    """The example on this rank of the current process group; returns the
    lines rank 0 prints."""
    mesh = make_mesh(2, device=device)
    out = []

    def say(line):
        out.append(line)
        if rank == 0:
            print(line)

    say(f"mesh: {mesh.shape}")
    dev = mesh.device
    so = gallery.poisson(nx, ny, dtype=torch.float32, device=dev)
    b = gallery.poisson_rhs(nx, ny, dtype=torch.float32, device=dev)
    conf = Config({
        "solver": {"tol": 1e-6, "max-iter": 12},
        "redist": {"search": {"strategy": "astar"}},
        "log": ["status", "error"] if rank == 0 else [],
    })
    bmg = DistSolver2(so, FivePt, conf, mesh)
    say(f"per-level placement: {[_spec(s) for s in bmg.specs]}")
    x = bmg.solve(b)
    err = float((x - gallery.poisson_solution(
        nx, ny, dtype=torch.float32, device=dev)).abs().max())
    say(f"Solution norm: {err:g}")
    say("Finished Test")
    return out


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("nx", nargs="?", type=int, default=512)
    p.add_argument("ny", nargs="?", type=int, default=None)
    p.add_argument("--spawn", type=int, default=0,
                   help="start a gloo world of this many processes")
    p.add_argument("--device", default=None,
                   help="torch device of every rank (default: the card)")
    p.add_argument("--backend", default="nccl",
                   help="process group backend under torchrun")
    args = p.parse_args(argv)
    ny = args.nx if args.ny is None else args.ny
    if args.spawn:
        return spawn(run, args.spawn, args.nx, ny, args.device)[0]
    init_from_env(args.backend)
    try:
        return run(dist.get_rank(), args.nx, ny, args.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
