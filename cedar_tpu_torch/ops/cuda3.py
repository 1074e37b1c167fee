"""K6: the 3D multicolour sweep (CUDA) and its plain version.

Counterpart of :mod:`cedar_tpu.ops.pallas3` (``_sweep_kernel`` and its
(x, y)-tiled ``_sweep2d_kernel``).  :func:`sweep` runs one sweep (all
colour phases, and the residual with ``fuse_residual``) on the card, on
the tensors' current stream, on a :func:`plan` that this module computes
from the shapes, in the regime measured fastest there (PERF.md §6):

* ``resident``: a small 27-point level, whose q and stencil planes fit one
  block's shared memory, is swept there in one launch, a thread a point of
  each colour (``csrc/sweep3.cu``);
* ``ring``, ``pass27``: a large level runs on K14's launches
  (:func:`cedar_tpu_torch.ops.cuda_fused3.launch_sweep`: the 7-point ring
  march with its residual epilogue; the 27-point float32 marches, two
  colours a launch, then the residual launch), which compute the same
  function;
* ``phases``: every other level, one launch a colour phase (the first
  writes every point of the new iterate) and one for the residual.

The residual launch after K14's 27-point marches is the edge kernel's
(:func:`cedar_tpu_torch.ops.cuda_fused3.launch_edge`, mode res); after the
per-colour launches, 7- or 27-point, the residual kernel of
``csrc/sweep3.cu`` (:data:`EDGE_RESIDUAL`).  :func:`launch` runs a sweep
on checked operands: the 27-point K14, K15 and K16 sweep through it.

:func:`sweep_plain` computes it in torch ops
(:func:`cedar_tpu_torch.ops.relax3.sweep3_torch`).
:func:`cedar_tpu_torch.ops.relax3.point_relax` picks one by device.

Both return the swept iterate in a new tensor and leave ``q`` as it was,
as the JAX function does.  ``resident_launches`` counts the resident
launches made by :func:`sweep`, ``launches`` its per-colour and residual
launches (its K14 launches count in ``cuda_fused3.sweep_launches``, the
edge kernel's in ``cuda_fused3.edge_launches``), ``plain_calls`` calls of
:func:`sweep_plain`.

``periodic`` wraps the couplings around the marked axes (the periodic mode
of the JAX sweep; its Pallas kernels never run it, cedar_tpu/solver/
cycle3.py:24-25): the kernels' periodic instantiations on the plan's
``resident`` or ``phases`` route (K14's routes and the edge kernel have no
periodic mode).  Along a periodic axis of odd extent the per-colour
launches go from one buffer to another, each writing every point
(:func:`odd_wrap`), so that a phase reads only the values before it.
``periodic_launches`` and ``periodic_resident_launches`` count the
periodic launches among ``launches`` and ``resident_launches``.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, cuda_fused3, relax3
from cedar_tpu_torch.ops.cuda_build import BLOCK_SMEM

launches = 0
resident_launches = 0
periodic_launches = 0
periodic_resident_launches = 0
plain_calls = 0

#: threads of a resident block (csrc/sweep3.cu ``kResThreads``)
THREADS = 512
#: the fewest points of a level on K14's launches: 7-point (the ring, both
#: dtypes), 27-point (the marches, float32); below them, and above the
#: resident levels, the per-colour launches were the faster on the card
#: (PERF.md §6)
RING_POINTS = 200 ** 3
PASS27_POINTS = 96 ** 3
#: the regimes whose 27-point residual launch is the edge kernel's
#: (csrc/edge3.cu); the others' is csrc/sweep3.cu ``residual``: each the
#: faster where it runs on the card (PERF.md §6)
EDGE_RESIDUAL = ("pass27",)


def octant_words(shape) -> int:
    """The words of one array in a resident block: 8 octants of half the
    grid's extents, rounded up (csrc/sweep3.cu ``sweep_resident``)."""
    return 8 * math.prod((n + 1) // 2 for n in shape)


@dataclass(frozen=True)
class Plan:
    """A K6 sweep: its ``route`` ("resident", "ring", "pass27" or
    "phases"); a resident one is one launch of ``threads`` threads and
    ``smem`` bytes."""
    route: str
    smem: int = 0
    threads: int = 0

    @property
    def resident(self) -> bool:
        return self.route == "resident"


def odd_wrap(shape, periodic) -> bool:
    """Whether an extent along a periodic axis is odd: there the wrap
    couples the first and last points, of one colour."""
    return any(p and n % 2 for n, p in zip(shape, periodic))


@functools.lru_cache(maxsize=256)
def plan(itemsize: int, ts: bool, shape,
         build: tuple[int, int] = (THREADS, BLOCK_SMEM),
         periodic: bool = False) -> Plan:
    """The K6 sweep on an ``(nx, ny, nz)`` grid for the kernel ``build``
    (its threads a block and the most shared memory a block may take,
    :func:`_build_of`): resident where a 27-point level's octants (a
    colour each) hold a point a thread at most and its q and 13
    off-diagonal stencil planes fit one block; K14's launches from
    :data:`RING_POINTS` points 7-point (``ring``) and
    :data:`PASS27_POINTS` 27-point float32 (``pass27``), unless an axis
    is ``periodic`` (K14 has no periodic mode); else ``phases``."""
    n = math.prod(shape)
    threads, limit = build
    m = octant_words(shape)
    smem = 14 * m * itemsize
    if ts and m <= 8 * threads and smem <= limit:
        return Plan("resident", smem, threads)
    if periodic:
        return Plan("phases")
    if not ts and n >= RING_POINTS:
        return Plan("ring")
    if ts and itemsize == 4 and n >= PASS27_POINTS:
        return Plan("pass27")
    return Plan("phases")


def launch_list(p: Plan, kind: StencilKind, updown: str,
                fuse_residual: bool, stages: int | None = None):
    """The kernel launches of a sweep on plan ``p`` in order, each
    ``(kernel, what)`` by the name of the count it adds to (chip_smoke.py's
    kernel table): one resident ("sweep3_resident") or ring
    ("sweep3_fused"), whose epilogue computes the residual; a launch a
    colour phase ("sweep3"), or a 27-point march a launch ("sweep3_fused",
    ``stages`` colours, default the built ones), and one more for the
    residual (the edge kernel "edge27" in the regimes of
    :data:`EDGE_RESIDUAL`, 27-point, else "sweep3")."""
    if p.route == "resident":
        return (("sweep3_resident", "sweep"),)
    if p.route == "ring":
        return (("sweep3_fused", "ring"),)
    ts = kind == StencilKind.twenty_seven_pt
    if p.route == "pass27":
        body = tuple(("sweep3_fused", g) for _, g in cuda_fused3.passes(
            stages or cuda_fused3.PASS27_STAGES, kind, updown))
    else:
        body = tuple(("sweep3", c) for c in relax3.color_order(kind, updown))
    res = "edge27" if ts and p.route in EDGE_RESIDUAL else "sweep3"
    return body + (((res, "residual"),) if fuse_residual else ())


def launches_of(p: Plan, kind: StencilKind, fuse_residual: bool,
                stages: int | None = None) -> int:
    """The number of kernel launches of a sweep on plan ``p``
    (:func:`launch_list`)."""
    return len(launch_list(p, kind, "down", fuse_residual, stages))


@functools.lru_cache(maxsize=None)
def _build_of(lib) -> tuple[int, int]:
    """The threads of a resident block and the most shared memory it may
    take in the build ``lib`` on the current card, read once."""
    return lib.cedar_sweep3_threads(), lib.cedar_sweep3_smem()


def _wrap(periodic) -> tuple[int, int, int]:
    """The periodic axes as the C entry points take them."""
    return tuple(int(bool(p)) for p in periodic)


def sweep(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
          kind: StencilKind, updown: str, fuse_residual: bool = False,
          origin=(0, 0, 0), periodic=(False, False, False)):
    """One full multicolour GS sweep on the card, out of place, in the
    regime of :func:`plan`.

    Returns the swept iterate, or ``(q_new, b - A q_new)`` with
    ``fuse_residual``; ``q`` is left as it was."""
    relax3.check_sweep(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    return launch(dt, so, q, b, kind, updown, fuse_residual, origin,
                  periodic=periodic)


def launch(dt: int, so, q, b, kind: StencilKind, updown: str,
           fuse_residual: bool = False, origin=(0, 0, 0), lib14=None,
           periodic=(False, False, False)):
    """The launches of :func:`sweep` on operands already checked
    (:func:`relax3.check_sweep`, :func:`cuda_build.check_operands`, whose
    dtype code is ``dt``), K14's with the build ``lib14`` of
    csrc/fused3.cu (None: the default one): the entry of the 27-point K14,
    K15 and K16 (:mod:`cuda_fused3`)."""
    p = plan(q.element_size(), kind == StencilKind.twenty_seven_pt,
             tuple(q.shape), _build_of(cuda_build.load("sweep3")),
             any(periodic))
    return _launch(p, dt, so, q, b, kind, updown, fuse_residual, origin,
                   lib14, periodic)


def _sweep(p: Plan, so, q, b, kind, updown, fuse_residual=False,
           origin=(0, 0, 0), periodic=(False, False, False)):
    """:func:`sweep` on the plan ``p`` (tools/tune_fused3.py times every
    regime at one shape; chip_smoke.py checks both periodic regimes)."""
    relax3.check_sweep(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    return _launch(p, dt, so, q, b, kind, updown, fuse_residual, origin,
                   periodic=periodic)


def _launch(p: Plan, dt: int, so, q, b, kind, updown, fuse_residual,
            origin, lib14=None, periodic=(False, False, False)):
    """The launches of a sweep on plan ``p`` (operands checked, dtype code
    ``dt``), in the order of :func:`launch_list`."""
    if any(periodic) and p.route not in ("resident", "phases"):
        raise ValueError(f"K6's {p.route} route has no periodic mode")
    if p.route == "resident":
        return _resident(p, dt, so, q, b, kind, updown, fuse_residual,
                         origin, periodic)
    if p.route == "phases":
        q_out = _phases(dt, so, q, b, kind, updown, origin, periodic)
    else:
        # K14: the ring's epilogue computes the residual; after the marches
        # a launch of its own is the faster (PERF.md §6)
        epilogue = p.route == "ring"
        out = cuda_fused3.launch_sweep(dt, so, q, b, kind, updown,
                                       fuse_residual and epilogue, origin,
                                       lib=lib14)
        if epilogue:
            return out
        q_out = out
    if not fuse_residual:
        return q_out
    edge = (kind == StencilKind.twenty_seven_pt
            and p.route in EDGE_RESIDUAL)
    return q_out, _residual(dt, so, q_out, b, kind, edge, periodic)


def _resident(p: Plan, dt: int, so, q, b, kind, updown, fuse_residual,
              origin, periodic=(False, False, False)):
    """A resident sweep: one launch, its residual the epilogue."""
    global resident_launches, periodic_resident_launches
    if kind != StencilKind.twenty_seven_pt:
        raise ValueError("a resident K6 sweep is 27-point")
    q_out = torch.empty_like(q)
    res = torch.empty_like(q) if fuse_residual else None
    cuda_build.check(
        cuda_build.load("sweep3").cedar_sweep3_resident(
            dt, so.data_ptr(), q.data_ptr(), b.data_ptr(), q_out.data_ptr(),
            None if res is None else res.data_ptr(), *q.shape,
            relax3.pack_colors(kind, updown), *(int(o) for o in origin),
            int(fuse_residual), *_wrap(periodic), p.smem,
            cuda_build.stream_of(q)),
        "sweep3_resident",
    )
    resident_launches += 1
    periodic_resident_launches += any(periodic)
    return (q_out, res) if fuse_residual else q_out


def _phases(dt: int, so, q, b, kind, updown, origin,
            periodic=(False, False, False)):
    """A launch a colour phase; the first writes every point of the new
    iterate (its colour updated, the others copied).  Where the wrap
    couples a colour to itself (:func:`odd_wrap`) every phase goes from one
    buffer to another, the last into the new iterate."""
    global launches, periodic_launches
    lib = cuda_build.load("sweep3")
    stream = cuda_build.stream_of(q)
    ts = int(kind == StencilKind.twenty_seven_pt)
    colors = relax3.color_order(kind, updown)
    q_out = torch.empty_like(q)
    outs = [q_out.data_ptr()] * len(colors)
    if odd_wrap(q.shape, periodic):
        scratch = torch.empty_like(q)
        outs = [q_out.data_ptr() if (len(colors) - 1 - k) % 2 == 0
                else scratch.data_ptr() for k in range(len(colors))]
    qi = q.data_ptr()
    for color, qo in zip(colors, outs):
        cuda_build.check(
            lib.cedar_sweep3_phase(dt, so.data_ptr(), qi, qo, b.data_ptr(),
                                   *q.shape, ts, color,
                                   *(int(o) for o in origin),
                                   *_wrap(periodic), stream),
            "sweep3 phase",
        )
        launches += 1
        periodic_launches += any(periodic)
        qi = qo
    return q_out


def _residual(dt: int, so, q, b, kind, edge: bool = False,
              periodic=(False, False, False)):
    """``b - A q`` by the residual kernel, or (``edge``, 27-point,
    non-periodic) by the edge kernel."""
    global launches, periodic_launches
    if edge:
        return cuda_fused3.launch_edge(dt, cuda_fused3.EDGE_MODES["res"], so,
                                       q, b)
    res = torch.empty_like(q)
    cuda_build.check(
        cuda_build.load("sweep3").cedar_residual3(
            dt, so.data_ptr(), q.data_ptr(), b.data_ptr(), res.data_ptr(),
            *q.shape, int(kind == StencilKind.twenty_seven_pt),
            *_wrap(periodic), cuda_build.stream_of(q)),
        "sweep3 residual",
    )
    launches += 1
    periodic_launches += any(periodic)
    return res


def sweep_plain(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                kind: StencilKind, updown: str, fuse_residual: bool = False,
                origin=(0, 0, 0), periodic=(False, False, False),
                recip=None):
    """:func:`sweep` in torch ops, on any device; returns new tensors and
    leaves ``q`` as it was."""
    global plain_calls
    plain_calls += 1
    relax3.check_sweep(so, q, b, kind)
    return relax3.sweep3_torch(so, q, b, recip, kind, updown, fuse_residual,
                               origin, periodic)
