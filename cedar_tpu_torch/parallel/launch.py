"""Start a world of processes on one host: one process a rank.

:func:`spawn` runs ``fn(rank, *args)`` in ``nranks`` fresh processes (the
``spawn`` start method), each in a ``torch.distributed`` process group of
the given backend that rendezvouses through a file in ``init_dir`` (no
network port), and returns the ranks' results in rank order
(:func:`start` returns at once, its :meth:`World.join` waits).  A rank
that fails, or a world that outlasts ``timeout`` seconds, raises at the
join; every process is stopped before it returns.  Under ``torchrun`` the processes
exist already: :func:`init_from_env` joins the group it describes.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, nranks, backend, init_file, timeout, fn, args, out,
               threads):
    try:
        if threads:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", world_size=nranks,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, *args)
        finally:
            dist.barrier()
            dist.destroy_process_group()
        torch.save({"ok": result}, f"{out}.{rank}")
    except BaseException:
        torch.save({"error": traceback.format_exc()}, f"{out}.{rank}")
        raise


class World:
    """A world of rank processes started by :func:`start`; :meth:`join`
    waits for it and returns the ranks' results."""

    def __init__(self, procs, out, timeout):
        self.procs, self.out, self.timeout = procs, out, timeout

    def join(self) -> list:
        try:
            for p in self.procs:
                p.join(self.timeout)
            hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
            if hung:
                raise TimeoutError(f"ranks {hung} still running after "
                                   f"{self.timeout} s")
            results = []
            for r, p in enumerate(self.procs):
                path = f"{self.out}.{r}"
                got = (torch.load(path, weights_only=False)
                       if os.path.exists(path)
                       else {"error": f"exit code {p.exitcode}"})
                if "error" in got:
                    raise RuntimeError(f"rank {r} failed:\n{got['error']}")
                results.append(got["ok"])
            return results
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join()


def start(fn, nranks: int, *args, backend: str = "gloo",
          timeout: float = 300.0, init_dir: str | None = None,
          threads: int | None = 1) -> World:
    """Start ``fn(rank, *args)`` in ``nranks`` processes of a ``backend``
    group; ``fn`` must be importable by name (a module-level function).
    ``threads`` sets each rank's torch thread count (None leaves it).
    The world runs while the caller goes on; :meth:`World.join` waits."""
    tmp = tempfile.mkdtemp(dir=init_dir)
    init_file = os.path.join(tmp, "init")
    out = os.path.join(tmp, "result")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nranks, backend, init_file, timeout, fn,
                               args, out, threads))
             for r in range(nranks)]
    for p in procs:
        p.start()
    return World(procs, out, timeout)


def spawn(fn, nranks: int, *args, **kw) -> list:
    """``[fn(0, *args), ..., fn(nranks - 1, *args)]``: :func:`start`, then
    :meth:`World.join`."""
    return start(fn, nranks, *args, **kw).join()


def init_from_env(backend: str, timeout: float = 300.0):
    """Join the process group of ``backend`` that ``torchrun`` describes in
    the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...)."""
    dist.init_process_group(backend,
                            timeout=datetime.timedelta(seconds=timeout))
