"""The communication of a distributed cycle over ``torch.distributed``.

cedar_tpu needs none of this: XLA's SPMD partitioner turns each shifted
read of a sharded array into a halo exchange, ``lax.ppermute`` moves the
sweeps' halo slabs (cedar_tpu/parallel/shard_relax.py:44-64) and
``with_sharding_constraint`` gathers at the agglomeration points.  Here
each is an explicit call:

* :func:`halo_extend` — one ``batch_isend_irecv`` of an ``H``-wide slab
  each way per partitioned axis, the axes in turn so that the corners
  fill, zeros beyond the mesh edges, or on a periodic axis the wrap from
  the rank at the far end of the ring (a halo wider than a neighbour's
  block takes one more exchange per block, passed on);
* :func:`center` — the block back out of an extended one;
* :func:`all_gather_axis` — agglomeration of one axis onto every rank of
  its mesh row or column (blocks of unequal sizes padded to the largest);
* :func:`all_gather_world` — every rank's block on every rank;
* :func:`all_reduce_sum` — the norms' partial sums.

The backend is the process group's own.  With gloo on CUDA tensors (gloo
has no collectives for them) each message is copied to the host and back
here, openly: ``staged_bytes`` counts those copies.  Nothing here switches
backend or device by itself.

Every call reaches ``torch.distributed`` through :func:`run`, the one
choke point: it gets the call's inputs, the tensors it writes (allocated
before, so that a replay writes the same memory) and whether a CUDA-graph
capture may hold it (:func:`capturable`, the table :data:`CAPTURABLE`).
Inside :func:`recording` it hands the call to a recorder
(:class:`cedar_tpu_torch.solver.graph.RecordedIteration`), which cuts its
capture at each call that a capture may not hold and runs that call
between the replays of the segments.

Counters (module attributes, reset by :func:`reset`): ``exchanges`` (one
``batch_isend_irecv`` call), ``exchange_bytes`` (bytes this rank sent in
them), ``wrap_exchanges`` (the exchanges along a periodic axis, which
carry the wrap at the ends of the ring), ``gathers`` and ``gather_bytes``
(all-gathers and the bytes this rank contributed), ``line_gathers``,
``spike_gathers`` and ``plane_gathers`` (the all-gathers tagged
``"line"``, the whole lines of a line sweep, ``"spike"``, the interface
rows of a distributed SPIKE colour, and ``"plane"``, the whole planes of
a plane sweep's colour or of its setup), ``reductions``,
``staged_bytes``.  They count a call where it runs eagerly or is recorded
(captured, or cut around), never at a replay of a recorded iteration: a
cycle's counts are those of its capture.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

exchanges = 0
exchange_bytes = 0
wrap_exchanges = 0
gathers = 0
gather_bytes = 0
line_gathers = 0
spike_gathers = 0
plane_gathers = 0
reductions = 0
staged_bytes = 0

# Whether a CUDA-graph capture may hold a call, by the group's backend and
# the kind of call ("exchange": batch_isend_irecv, "all_gather",
# "all_reduce").  gloo runs its calls on the host (CUDA tensors staged
# through it), outside any stream: none.  NCCL enqueues its kernels on a
# stream, which torch's ProcessGroupNCCL lets a capture record: all (its
# communicators created before, by an eager iteration).  Decided from the
# backend before anything runs; another backend is refused.
CAPTURABLE = {
    "gloo": {"exchange": False, "all_gather": False, "all_reduce": False},
    "nccl": {"exchange": True, "all_gather": True, "all_reduce": True},
}

_recorder = None


def reset() -> None:
    global exchanges, exchange_bytes, gathers, gather_bytes, reductions
    global staged_bytes, wrap_exchanges, line_gathers, spike_gathers
    global plane_gathers
    exchanges = exchange_bytes = gathers = gather_bytes = reductions = 0
    staged_bytes = wrap_exchanges = line_gathers = spike_gathers = 0
    plane_gathers = 0


def counts() -> dict:
    return {"exchanges": exchanges, "exchange_bytes": exchange_bytes,
            "wrap_exchanges": wrap_exchanges, "gathers": gathers,
            "gather_bytes": gather_bytes, "line_gathers": line_gathers,
            "spike_gathers": spike_gathers, "plane_gathers": plane_gathers,
            "reductions": reductions,
            "staged_bytes": staged_bytes}


def capturable(mesh, kind: str) -> bool:
    """Whether a capture may hold a call of ``kind`` on ``mesh``'s group
    (:data:`CAPTURABLE`)."""
    try:
        return CAPTURABLE[mesh.backend][kind]
    except KeyError:
        raise NotImplementedError(
            f"cedar_tpu_torch: no capture rule for a {kind} call over "
            f"{mesh.backend!r}") from None


@contextlib.contextmanager
def recording(recorder):
    """Calls made inside go to ``recorder.call(fn, inputs, outputs,
    capturable)`` instead of running."""
    global _recorder
    prev, _recorder = _recorder, recorder
    try:
        yield
    finally:
        _recorder = prev


def run(fn, inputs: list, outputs: list, capturable: bool) -> None:
    """The one place a call reaches ``torch.distributed``:
    ``fn(inputs, outputs)`` reads the tensors ``inputs`` and writes the
    result into the tensors ``outputs``, in place; ``capturable`` says
    whether a capture may hold it.  Inside :func:`recording` the recorder
    takes it (and may run ``fn`` again at each replay, on the same
    tensors)."""
    if _recorder is not None:
        _recorder.call(fn, inputs, outputs, capturable)
    else:
        fn(inputs, outputs)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(t: torch.Tensor) -> torch.Tensor:
    """A contiguous host copy of ``t``."""
    return torch.empty(t.shape, dtype=t.dtype, device="cpu").copy_(t)


def _sendrecv(to_prev, to_next, prev, nxt, mesh, wrap=False):
    """One exchange along a mesh axis: ``to_next`` goes to ``nxt``,
    ``to_prev`` to ``prev``; returns what came from ``prev`` and from
    ``nxt`` (zeros where there is no neighbour).

    Messages between two ranks match in the order they were posted, and on
    a ring of two ranks ``prev`` and ``nxt`` are one rank: so every rank
    posts its send to ``nxt`` before its send to ``prev``, and its receive
    from ``prev`` before its receive from ``nxt``."""
    global exchanges, exchange_bytes, wrap_exchanges, staged_bytes
    sends = [(peer, t) for peer, t in ((nxt, to_next), (prev, to_prev))
             if peer is not None]
    recvs = [(key, peer, like) for key, peer, like in (
        ("prev", prev, to_next), ("next", nxt, to_prev)) if peer is not None]
    got = {key: torch.empty(like.shape, dtype=like.dtype, device=like.device)
           for key, _, like in recvs}
    if sends or recvs:
        staged = mesh.staged
        sent = sum(_nbytes(t) for _, t in sends)
        exchanges += 1
        wrap_exchanges += bool(wrap)
        exchange_bytes += sent
        if staged:
            staged_bytes += sent + sum(_nbytes(t) for t in got.values())

        def fn(ins, outs):
            bufs = [_host(o) if staged else o for o in outs]
            ops = [dist.P2POp(dist.isend,
                              _host(t) if staged else t.contiguous(), peer,
                              mesh.group)
                   for (peer, _), t in zip(sends, ins)]
            ops += [dist.P2POp(dist.irecv, buf, peer, mesh.group)
                    for (_, peer, _), buf in zip(recvs, bufs)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            if staged:
                for o, buf in zip(outs, bufs):
                    o.copy_(buf)

        run(fn, [t for _, t in sends], [got[key] for key, _, _ in recvs],
            capturable(mesh, "exchange"))
    return tuple(got[key] if key in got else torch.zeros_like(like)
                 for key, like in (("prev", to_next), ("next", to_prev)))


def _extend_axis(a: torch.Tensor, dim: int, name: str, mesh, H: int,
                 wrap: bool = False):
    m = a.shape[dim]
    prev, nxt = mesh.ring[name] if wrap else mesh.neighbours[name]
    rounds = -(-H // m)
    w = H if rounds == 1 else m
    to_next = a.narrow(dim, m - w, w)
    to_prev = a.narrow(dim, 0, w)
    lows, highs = [], []
    for _ in range(rounds):
        from_prev, from_next = _sendrecv(to_prev, to_next, prev, nxt, mesh,
                                         wrap)
        lows.insert(0, from_prev)
        highs.append(from_next)
        # a halo wider than a block: pass the neighbours' blocks on
        to_next, to_prev = from_prev, from_next
    low = torch.cat(lows, dim) if rounds > 1 else lows[0]
    high = torch.cat(highs, dim) if rounds > 1 else highs[0]
    low = low.narrow(dim, low.shape[dim] - H, H)
    high = high.narrow(dim, 0, H)
    return torch.cat([low, a, high], dim)


def halo_extend(a: torch.Tensor, names, mesh, H: int, lead: int = 0,
                periodic=None):
    """``a`` (a block, its spatial axes after ``lead`` leading axes)
    extended by ``H`` points on both sides of each axis partitioned over a
    mesh axis of more than one rank (``names[d]`` not None), with the
    neighbours' values, zeros beyond the mesh edges, or along a
    ``periodic`` axis the values of the ranks at the other end of the ring
    (the wrap); the axes in turn, so that the corners fill."""
    for d, name in enumerate(names):
        if name is not None and mesh.shape[name] > 1 and H > 0:
            a = _extend_axis(a, d + lead, name, mesh, H,
                             bool(periodic and periodic[d]))
    return a


def center(a: torch.Tensor, names, mesh, H: int, lead: int = 0):
    """The block of an extended ``a`` (cedar_tpu/parallel/shard_relax.py:
    80-85)."""
    idx = [slice(None)] * a.ndim
    for d, name in enumerate(names):
        if name is not None and mesh.shape[name] > 1:
            idx[d + lead] = slice(H, a.shape[d + lead] - H)
    return a[tuple(idx)]


def all_gather_axis(a: torch.Tensor, dim: int, name: str, mesh, sizes,
                    tag: str | None = None):
    """The blocks of ``a`` along mesh axis ``name`` (``sizes[c]`` the
    extent along ``dim`` of the block at coordinate ``c``) concatenated
    along ``dim``, on every rank of the mesh row or column.  ``tag``
    ("line", "spike" or "plane") counts it in ``line_gathers``,
    ``spike_gathers`` or ``plane_gathers`` too."""
    global gathers, gather_bytes, line_gathers, spike_gathers, plane_gathers
    global staged_bytes
    group = mesh.axis_groups[name]
    if group is None:
        return a
    mx = max(sizes)
    if a.shape[dim] < mx:
        pad = list(a.shape)
        pad[dim] = mx - a.shape[dim]
        a = torch.cat([a, a.new_zeros(pad)], dim)
    shape = list(a.shape)
    shape[dim] = sum(sizes)
    out = a.new_empty(shape)
    staged = mesh.staged
    gathers += 1
    gather_bytes += _nbytes(a)
    line_gathers += tag == "line"
    spike_gathers += tag == "spike"
    plane_gathers += tag == "plane"
    if staged:
        staged_bytes += _nbytes(a) + _nbytes(out)

    def fn(ins, outs):
        src = _host(ins[0]) if staged else ins[0].contiguous()
        parts = [torch.empty_like(src) for _ in sizes]
        dist.all_gather(parts, src, group=group)
        pieces = [p.narrow(dim, 0, n) for p, n in zip(parts, sizes)]
        if staged:
            outs[0].copy_(torch.cat(pieces, dim))
        else:
            torch.cat(pieces, dim, out=outs[0])

    run(fn, [a], [out], capturable(mesh, "all_gather"))
    return out


def all_gather_world(a: torch.Tensor, mesh) -> list:
    """Every rank's ``a`` (all of one shape), in rank order of the mesh."""
    global gathers, gather_bytes, staged_bytes
    outs = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
            for _ in range(mesh.size)]
    staged = mesh.staged
    gathers += 1
    gather_bytes += _nbytes(a)
    if staged:
        staged_bytes += _nbytes(a) * (1 + mesh.size)

    def fn(ins, outs):
        src = _host(ins[0]) if staged else ins[0].contiguous()
        parts = [torch.empty_like(src) for _ in outs] if staged else outs
        dist.all_gather(parts, src, group=mesh.group)
        if staged:
            for o, p in zip(outs, parts):
                o.copy_(p)

    run(fn, [a], outs, capturable(mesh, "all_gather"))
    return outs


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, on every rank."""
    global reductions, staged_bytes
    out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
    staged = mesh.staged
    reductions += 1
    if staged:
        staged_bytes += 2 * _nbytes(t)

    def fn(ins, outs):
        buf = _host(ins[0]) if staged else outs[0].copy_(ins[0])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
        if staged:
            outs[0].copy_(buf)

    run(fn, [t], [out], capturable(mesh, "all_reduce"))
    return out
