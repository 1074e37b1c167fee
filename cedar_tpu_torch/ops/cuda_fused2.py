"""K11 (fused sweep), K12 (sweep + residual + restriction) and K13
(interp-add + sweep): the fused 2D fine-level kernels (CUDA) and their
plain versions.

Counterpart of :mod:`cedar_tpu.ops.pallas2_split` (``point_relax_split``)
and of the fused half of :mod:`cedar_tpu.ops.pallas_transfer2`
(``sweep_restrict_split``, ``interp_sweep_split``).  :func:`sweep`,
:func:`sweep_restrict` and :func:`interp_sweep` launch ``csrc/fused2.cu``
once each on the tensors' current stream; :func:`sweep_plain`,
:func:`sweep_restrict_plain` and :func:`interp_sweep_plain` compute the
same functions in torch ops (:mod:`cedar_tpu_torch.ops.fused2`), which
picks one by device.

All of them read ``q`` and return a new iterate: a kernel block reads
``q`` over its tile and a halo while other blocks write theirs, so the
kernels work out of place.  ``*_launches`` count kernel launches,
``*_plain_calls`` plain-version calls.

K12 and K13 (the row march) launch on a :func:`plan` that this module
computes from the shapes and the card's SM count and passes to the kernel:
threads a block (a strip of twice as many region columns;
:data:`THREADS`), rows a chunk, the grid and the shared-memory bytes (the
launch checks them against the kernel's own), and so the number of K13's
norm partials.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from cedar_tpu_torch.core.types import StencilKind
from cedar_tpu_torch.ops import cuda_build, fused2, relax2
from cedar_tpu_torch.ops.cuda_build import BLOCK_SMEM, SM_SMEM
from cedar_tpu_torch.ops.cuda_transfer2 import _coarse_shape

sweep_launches = 0
sweep_restrict_launches = 0
interp_sweep_launches = 0
sweep_plain_calls = 0
sweep_restrict_plain_calls = 0
interp_sweep_plain_calls = 0

# output modes of K11 and K13, and K12's epilogue (csrc/fused2.cu)
_NONE, _RES, _NORM, _RESTRICT = 0, 1, 2, 3
#: K12's and K13's threads a block and the steps between a copy and its
#: first read
#: (csrc/fused2.cu ``kRingThreads``, ``kAhead``; tools/tune_fused2.py
#: builds others with ``-DCEDAR_FUSED2_THREADS``, ``-DCEDAR_FUSED2_AHEAD``)
THREADS, AHEAD = 128, 1


def halo(nine: bool, mode: int) -> int:
    """The halo H in rows and columns of K13 (modes ``_NONE``, ``_RES``,
    ``_NORM``: the interpolation stage, the colour phases (2 or 4) and the
    residual or norm epilogue) or K12 (``_RESTRICT``: the colour phases,
    the residual and the restriction's low row and column)."""
    phases = 4 if nine else 2
    if mode == _RESTRICT:
        return phases + 2
    return 1 + phases + (mode != _NONE)


def ring_words(nine: bool, mode: int, nt: int = THREADS,
               ahead: int = AHEAD) -> int:
    """Shared-memory words of a K12 (``mode`` ``_RESTRICT``) or K13 block
    of ``nt`` threads, copies ``ahead`` steps ahead (csrc/fused2.cu
    ``Ring2::WORDS``), in rows of 2 nt columns.  K13: rings of the swept q
    (H + 1 rows), q_pre (3 + ahead), the stencil planes and b (H + 1 +
    ahead slots of 4 or 6 rows), then two coarse rows of the 8 CI weights
    and three of qc over nt + 2 coarse columns.  K12 (SE = H - 1, the
    residual's stage): rings of q (SE + 2 + ahead), the stencil planes and
    b (SE + 1 + ahead slots), the residual (4 rows), then three coarse rows
    of the 8 CI weights, laid out over nt + 2 coarse columns."""
    h = halo(nine, mode)
    nsb = (5 if nine else 3) + 1
    if mode == _RESTRICT:
        se = h - 1
        return (2 * nt * ((se + 2 + ahead) + (se + 1 + ahead) * nsb + 4)
                + 24 * (nt + 2))
    return (2 * nt * ((h + 1) + (3 + ahead) + (h + 1 + ahead) * nsb)
            + 19 * (nt + 2))


@dataclass(frozen=True)
class Plan:
    """A K12 or K13 launch: blocks of ``nt`` threads on strips of ``tw``
    owned columns (``2 nt`` region columns, a halo of ``h``) and chunks of
    ``cz`` rows, a ``(gw, gc)`` grid, ``smem`` bytes a block, ``per_sm``
    blocks resident an SM."""
    nt: int
    tw: int
    h: int
    cz: int
    gw: int
    gc: int
    smem: int
    per_sm: int

    @property
    def blocks(self) -> int:
        """The blocks of the launch, and the norm partials it writes."""
        return self.gw * self.gc


@functools.lru_cache(maxsize=256)
def plan(itemsize: int, nine: bool, mode: int, shape, n_sm: int = 132,
         build: tuple[int, int] = (THREADS, AHEAD)) -> Plan:
    """The launch of K13 (``mode`` an output mode) or K12 (``mode``
    ``_RESTRICT``) on an ``(nx, ny)`` grid for a card of ``n_sm`` SMs, for
    the kernel ``build`` (its threads a block and the steps its copies run
    ahead, :func:`_build_of`): the chunk of rows whose grid runs in whole
    waves of resident blocks (even, so that K12's chunks start at even
    rows)."""
    nx, ny = shape
    nt, ahead = build
    h = halo(nine, mode)
    size = ring_words(nine, mode, nt, ahead) * itemsize
    if size > BLOCK_SMEM:
        raise ValueError(f"a K12/K13 block of {nt} threads does not fit")
    tw = 2 * nt - 2 * h
    per_sm = min(2048 // nt, 32, SM_SMEM // (size + 1024))
    gw = -(-ny // tw)
    cz, gc = cuda_build.chunk(nx, gw, n_sm * per_sm, h)
    return Plan(nt, tw, h, cz, gw, gc, size, per_sm)


@functools.lru_cache(maxsize=None)
def _build_of(lib) -> tuple[int, int]:
    """The threads a K12/K13 block and the steps ahead of their copies in
    the build ``lib``, read once."""
    return lib.cedar_fused2_threads(), lib.cedar_fused2_ahead()



def _check(so, q, b, kind: StencilKind) -> None:
    if kind not in (StencilKind.five_pt, StencilKind.nine_pt):
        raise ValueError(f"fused sweep takes 2D five_pt or nine_pt, not "
                         f"{kind}")
    if q.ndim != 2 or b.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)} and b {tuple(b.shape)}")
    if tuple(so.shape) != (kind.ndirs, *q.shape):
        raise ValueError(
            f"so {tuple(so.shape)} does not fit {kind} on {tuple(q.shape)}"
        )


def _check_qc(ci, qc, fine_shape) -> tuple[int, int]:
    nc = _coarse_shape(ci, fine_shape)
    if tuple(qc.shape) != nc:
        raise ValueError(f"qc {tuple(qc.shape)}, expected {nc}")
    return nc


def _mode(fuse_residual: bool, fuse_norm: bool) -> int:
    return _NORM if fuse_norm else (_RES if fuse_residual else _NONE)


def _outputs(lib, q: torch.Tensor, kind: StencilKind, mode: int,
             partials: int | None = None):
    """``q_out`` and the residual or partials buffer of ``mode`` (passed to
    the kernel as both its res and its partials pointer: it writes the one
    its mode names): K11's partials from ``cedar_fused2_partials``, K13's
    its plan's blocks (``partials``)."""
    nx, ny = q.shape
    extra = None
    if mode == _RES:
        extra = torch.empty_like(q)
    elif mode == _NORM:
        extra = q.new_empty(partials or lib.cedar_fused2_partials(
            int(kind == StencilKind.nine_pt), nx, ny))
    return torch.empty_like(q), extra


def _result(q_out, extra, mode: int):
    return q_out if mode == _NONE else (q_out, extra)


def _ptr(t):
    return None if t is None else t.data_ptr()


def sweep(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
          kind: StencilKind, updown: str, fuse_residual: bool = False,
          origin=(0, 0), fuse_norm: bool = False):
    """K11: one whole multicolour sweep on the card, out of place.

    Returns ``q_new``, ``(q_new, res)`` with ``fuse_residual`` or
    ``(q_new, partials)`` with ``fuse_norm``."""
    global sweep_launches
    _check(so, q, b, kind)
    dt = cuda_build.check_operands(so, q, b)
    lib = cuda_build.load("fused2")
    mode = _mode(fuse_residual, fuse_norm)
    q_out, extra = _outputs(lib, q, kind, mode)
    colors, ncolors = relax2.pack_colors(kind, updown)
    oz, ow = (int(o) for o in origin)
    nx, ny = q.shape
    cuda_build.check(
        lib.cedar_sweep2_fused(dt, so.data_ptr(), q.data_ptr(), b.data_ptr(),
                               q_out.data_ptr(), _ptr(extra), _ptr(extra),
                               nx, ny, int(kind == StencilKind.nine_pt),
                               colors, ncolors, oz, ow, mode,
                               cuda_build.stream_of(q)),
        "sweep2_fused",
    )
    sweep_launches += 1
    return _result(q_out, extra, mode)


def sweep_restrict(so: torch.Tensor, q: torch.Tensor, b: torch.Tensor,
                   ci: torch.Tensor, kind: StencilKind, updown: str,
                   emit_res: bool = True):
    """K12: the sweep, its residual and ``cb = Pᵀ res`` on the card; returns
    ``(q_new, res or None, cb)``."""
    return _sweep_restrict(None, so, q, b, ci, kind, updown, emit_res)


def _sweep_restrict(lib, so, q, b, ci, kind, updown, emit_res=True):
    """:func:`sweep_restrict` with the library ``lib`` (a build of
    csrc/fused2.cu; None: the default one), as tools/tune_fused2.py times
    it."""
    global sweep_restrict_launches
    _check(so, q, b, kind)
    nxc, nyc = _coarse_shape(ci, q.shape)
    dt = cuda_build.check_operands(so, q, b, ci)
    lib = lib or cuda_build.load("fused2")
    nine = kind == StencilKind.nine_pt
    p = plan(q.element_size(), nine, _RESTRICT, tuple(q.shape),
             cuda_build.n_sm(q.device), _build_of(lib))
    q_out = torch.empty_like(q)
    res = torch.empty_like(q) if emit_res else None
    cb = q.new_empty((nxc, nyc))
    colors, _ = relax2.pack_colors(kind, updown)
    nx, ny = q.shape
    cuda_build.check(
        lib.cedar_sweep_restrict2(dt, so.data_ptr(), q.data_ptr(),
                                  b.data_ptr(), ci.data_ptr(),
                                  q_out.data_ptr(), _ptr(res), cb.data_ptr(),
                                  nx, ny, nxc, nyc, int(nine), colors,
                                  int(emit_res), p.nt, p.cz, p.gw, p.gc,
                                  p.smem, cuda_build.stream_of(q)),
        "sweep_restrict2",
    )
    sweep_restrict_launches += 1
    return q_out, res, cb


def interp_sweep(ci: torch.Tensor, qc: torch.Tensor, so: torch.Tensor,
                 b: torch.Tensor, q_pre: torch.Tensor, kind: StencilKind,
                 updown: str, fuse_residual: bool = False,
                 fuse_norm: bool = False):
    """K13: ``q_pre + P qc + (b - A q_pre)/diag``, then one sweep, on the
    card; returns ``q_new`` (plus ``res`` or ``partials``)."""
    return _interp_sweep(None, ci, qc, so, b, q_pre, kind, updown,
                         fuse_residual, fuse_norm)


def _interp_sweep(lib, ci, qc, so, b, q_pre, kind, updown,
                  fuse_residual=False, fuse_norm=False):
    """:func:`interp_sweep` with the library ``lib`` (a build of
    csrc/fused2.cu; None: the default one), as tools/tune_fused2.py times
    it."""
    global interp_sweep_launches
    _check(so, q_pre, b, kind)
    nxc, nyc = _check_qc(ci, qc, q_pre.shape)
    dt = cuda_build.check_operands(ci, qc, so, b, q_pre)
    lib = lib or cuda_build.load("fused2")
    mode = _mode(fuse_residual, fuse_norm)
    nine = kind == StencilKind.nine_pt
    p = plan(q_pre.element_size(), nine, mode, tuple(q_pre.shape),
             cuda_build.n_sm(q_pre.device), _build_of(lib))
    q_out, extra = _outputs(lib, q_pre, kind, mode, p.blocks)
    colors, _ = relax2.pack_colors(kind, updown)
    nx, ny = q_pre.shape
    cuda_build.check(
        lib.cedar_interp_sweep2(dt, ci.data_ptr(), qc.data_ptr(),
                                so.data_ptr(), b.data_ptr(),
                                q_pre.data_ptr(), q_out.data_ptr(),
                                _ptr(extra), _ptr(extra), nx, ny, nxc, nyc,
                                int(nine), colors, mode, p.nt, p.cz, p.gw,
                                p.gc, p.smem, cuda_build.stream_of(q_pre)),
        "interp_sweep2",
    )
    interp_sweep_launches += 1
    return _result(q_out, extra, mode)


def sweep_plain(so, q, b, kind: StencilKind, updown: str,
                fuse_residual: bool = False, origin=(0, 0),
                fuse_norm: bool = False):
    """:func:`sweep` in torch ops, on any device."""
    global sweep_plain_calls
    sweep_plain_calls += 1
    _check(so, q, b, kind)
    return fused2.sweep_split_torch(so, q, b, kind, updown, fuse_residual,
                                    origin, fuse_norm)


def sweep_restrict_plain(so, q, b, ci, kind: StencilKind, updown: str,
                         emit_res: bool = True):
    """:func:`sweep_restrict` in torch ops, on any device."""
    global sweep_restrict_plain_calls
    sweep_restrict_plain_calls += 1
    _check(so, q, b, kind)
    _coarse_shape(ci, q.shape)
    return fused2.sweep_restrict_torch(so, q, b, ci, kind, updown, emit_res)


def interp_sweep_plain(ci, qc, so, b, q_pre, kind: StencilKind, updown: str,
                       fuse_residual: bool = False, fuse_norm: bool = False):
    """:func:`interp_sweep` in torch ops, on any device."""
    global interp_sweep_plain_calls
    interp_sweep_plain_calls += 1
    _check(so, q_pre, b, kind)
    _check_qc(ci, qc, q_pre.shape)
    return fused2.interp_sweep_torch(ci, qc, so, b, q_pre, kind, updown,
                                     fuse_residual, fuse_norm)
