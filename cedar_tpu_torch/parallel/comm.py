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

Counters (module attributes, reset by :func:`reset`): ``exchanges`` (one
``batch_isend_irecv`` call), ``exchange_bytes`` (bytes this rank sent in
them), ``wrap_exchanges`` (the exchanges along a periodic axis, which
carry the wrap at the ends of the ring), ``gathers`` and ``gather_bytes``
(all-gathers and the bytes this rank contributed), ``line_gathers`` and
``spike_gathers`` (the all-gathers tagged ``"line"``, the whole lines of
a line sweep, and ``"spike"``, the interface rows of a distributed SPIKE
colour), ``reductions``, ``staged_bytes``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

exchanges = 0
exchange_bytes = 0
wrap_exchanges = 0
gathers = 0
gather_bytes = 0
line_gathers = 0
spike_gathers = 0
reductions = 0
staged_bytes = 0


def reset() -> None:
    global exchanges, exchange_bytes, gathers, gather_bytes, reductions
    global staged_bytes, wrap_exchanges, line_gathers, spike_gathers
    exchanges = exchange_bytes = gathers = gather_bytes = reductions = 0
    staged_bytes = wrap_exchanges = line_gathers = spike_gathers = 0


def counts() -> dict:
    return {"exchanges": exchanges, "exchange_bytes": exchange_bytes,
            "wrap_exchanges": wrap_exchanges, "gathers": gathers,
            "gather_bytes": gather_bytes, "line_gathers": line_gathers,
            "spike_gathers": spike_gathers, "reductions": reductions,
            "staged_bytes": staged_bytes}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _to_host(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` where the backend takes it: a host copy under staging."""
    global staged_bytes
    if not mesh.staged:
        return t.contiguous()
    staged_bytes += _nbytes(t)
    return t.to("cpu")


def _from_host(t: torch.Tensor, mesh) -> torch.Tensor:
    global staged_bytes
    if not mesh.staged:
        return t
    staged_bytes += _nbytes(t)
    return t.to(mesh.device)


def _empty_like(t: torch.Tensor, mesh) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype,
                       device="cpu" if mesh.staged else t.device)


def _sendrecv(to_prev, to_next, prev, nxt, mesh, wrap=False):
    """One exchange along a mesh axis: ``to_next`` goes to ``nxt``,
    ``to_prev`` to ``prev``; returns what came from ``prev`` and from
    ``nxt`` (zeros where there is no neighbour).

    Messages between two ranks match in the order they were posted, and on
    a ring of two ranks ``prev`` and ``nxt`` are one rank: so every rank
    posts its send to ``nxt`` before its send to ``prev``, and its receive
    from ``prev`` before its receive from ``nxt``."""
    global exchanges, exchange_bytes, wrap_exchanges
    sends, recvs, got = [], [], {}
    for peer, send in ((nxt, to_next), (prev, to_prev)):
        if peer is not None:
            s = _to_host(send, mesh)
            sends.append(dist.P2POp(dist.isend, s, peer, mesh.group))
            exchange_bytes += _nbytes(s)
    for key, peer, like in (("prev", prev, to_next), ("next", nxt, to_prev)):
        if peer is not None:
            got[key] = _empty_like(like, mesh)
            recvs.append(dist.P2POp(dist.irecv, got[key], peer, mesh.group))
    if sends or recvs:
        exchanges += 1
        wrap_exchanges += bool(wrap)
        for req in dist.batch_isend_irecv(sends + recvs):
            req.wait()
    return tuple(_from_host(got[key], mesh) if key in got
                 else torch.zeros_like(like)
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
    ("line" or "spike") counts it in ``line_gathers`` or
    ``spike_gathers`` too."""
    global gathers, gather_bytes, line_gathers, spike_gathers
    group = mesh.axis_groups[name]
    if group is None:
        return a
    mx = max(sizes)
    if a.shape[dim] < mx:
        pad = list(a.shape)
        pad[dim] = mx - a.shape[dim]
        a = torch.cat([a, a.new_zeros(pad)], dim)
    src = _to_host(a, mesh)
    parts = [torch.empty_like(src) for _ in sizes]
    gathers += 1
    gather_bytes += _nbytes(src)
    line_gathers += tag == "line"
    spike_gathers += tag == "spike"
    dist.all_gather(parts, src, group=group)
    return _from_host(torch.cat([p.narrow(dim, 0, n)
                                 for p, n in zip(parts, sizes)], dim), mesh)


def all_gather_world(a: torch.Tensor, mesh) -> list:
    """Every rank's ``a`` (all of one shape), in rank order of the mesh."""
    global gathers, gather_bytes
    src = _to_host(a, mesh)
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    gathers += 1
    gather_bytes += _nbytes(src)
    dist.all_gather(parts, src, group=mesh.group)
    return [_from_host(p, mesh) for p in parts]


def all_reduce_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the mesh's ranks, on every rank."""
    global reductions
    src = _to_host(t, mesh).clone()
    reductions += 1
    dist.all_reduce(src, op=dist.ReduceOp.SUM, group=mesh.group)
    return _from_host(src, mesh)
