"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers) and loads through
``ctypes``.  The build runs at first use, into ``cedar_tpu_torch/_build/``,
under a name keyed by a hash of the sources and flags, so a changed source
rebuilds and an unchanged one loads at once.  A build failure raises.

Nothing here runs at import: the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: dtype codes of the C entry points (csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.float64: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
#: C entry points of each source, name -> argtypes (all return int)
SIGNATURES = {
    "sweep2": {
        "cedar_sweep2_threads": [],
        # nx, ny, the planes of a batch; ends with the periodic axes, then
        # its plan: smem (0: streamed)
        "cedar_sweep2": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _L, _P],
    },
    "transfer2": {
        # K2 and K3 end with the periodic axes, then their plan: seg,
        # nseg, threads, gy; K5 (nx, ny, nxc, nyc, the planes of a batch)
        # with the periodic axes
        "cedar_restrict2": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _P],
        "cedar_interp_add2": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _P],
        "cedar_interp2": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "lines2": {
        # end with the periodic axes (x, y)
        "cedar_line2_x": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P],
        "cedar_line2_y": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P],
    },
    "fused2": {
        "cedar_fused2_partials": [_I, _I, _I],
        "cedar_sweep2_fused": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _I, _I, _I, _P],
        "cedar_fused2_threads": [],
        "cedar_fused2_ahead": [],
        "cedar_fused2_smem": [_I, _I, _I, _I],
        # K12 and K13 end with their plan: nt, cz, gw, gc, smem
        "cedar_sweep_restrict2": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _L,
                                  _P],
        "cedar_interp_sweep2": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _P],
    },
    "planes2": {
        # nb, nx, ny, nine, up, nsweeps, axes, then the plan: hx, hy, lx,
        # ly, per_plane
        "cedar_line_xy_smooth2": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _L, _P],
    },
    "sweep3": {
        "cedar_sweep3_threads": [],
        "cedar_sweep3_smem": [],
        # each ends with the periodic axes (x, y, z); the resident one
        # then with its plan: the block's smem
        "cedar_sweep3_resident": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _I, _I, _L, _P],
        "cedar_sweep3_phase": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, _I, _P],
        "cedar_residual3": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    },
    "transfer3": {
        # each ends with the periodic axes (x, y, z)
        "cedar_restrict3": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
        "cedar_interp_add3": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P],
        "cedar_interp3": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P],
    },
    "fused3": {
        "cedar_fused3_pass27_stages": [],
        "cedar_fused3_pass27_smem": [_I, _I],
        "cedar_fused3_ring14_blocks": [],
        "cedar_fused3_ring14_rows": [_I],
        "cedar_fused3_smem": [_I, _I, _I, _I],
        # the 7-point K14, K15 and K16 and the 27-point K14 end with their
        # plan: ty, cx, gz, gy, gc, smem
        "cedar_sweep3_ring": [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _P],
        "cedar_pass27": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _I, _I, _I, _L, _P],
        "cedar_sweep_restrict3": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _I, _L, _P],
        "cedar_interp_sweep3": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _I, _L, _P],
    },
    "edge3": {
        "cedar_edge3_threads": [],
        "cedar_edge3_cols": [_I],
        "cedar_edge3_smem": [_I, _I, _I],
        # ends with its plan: ty, cx, gz, gy, gc, smem
        "cedar_edge3": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _I, _I, _L, _P],
    },
}

#: a block's most shared memory on an H100 (227 KB), less 1 KB for a
#: kernel's static shared memory
BLOCK_SMEM = 232448 - 1024
#: an SM's shared memory (228 KB), of which each resident block takes 1 KB
SM_SMEM = 233472

_libs: dict[str, ctypes.CDLL] = {}
#: name -> (seconds spent in nvcc, nvcc's stderr: the ptxas register report)
build_log: dict[str, tuple[float, str]] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    h.update(" ".join([*FLAGS, *defines]).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, path: Path, defines: tuple[str, ...] = ()):
    """Start nvcc on ``csrc/<name>.cu`` (with ``-D`` ``defines``); returns
    what :func:`_finish` takes."""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return _key(name, defines), path, tmp, cmd, time.perf_counter(), proc


def _key(name: str, defines: tuple[str, ...]) -> str:
    """A build's name in :data:`_libs` and :data:`build_log`."""
    return f"{name}:{' '.join(defines)}" if defines else name


def _finish(name, path, tmp, cmd, t0, proc) -> None:
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed building {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{out}{err}"
        )
    os.replace(tmp, path)
    build_log[name] = (time.perf_counter() - t0, err)


def _open(name: str, path: Path, key: str | None = None) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _libs[key or name] = lib
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        _finish(*_start(name, path))
    return _open(name, path)


def load_variant(name: str, defines: tuple[str, ...]) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with the ``-D`` settings ``defines`` (for
    the tools that time a kernel's build settings), beside the default
    build; :func:`load` keeps returning the default one."""
    key = _key(name, defines)
    lib = _libs.get(key)
    if lib is not None:
        return lib
    path = library_path(name, defines)
    if not path.exists():
        _finish(*_start(name, path, defines))
    return _open(name, path, key)


def build_variants(name: str, variants) -> None:
    """Build ``csrc/<name>.cu`` with each tuple of ``-D`` settings in
    ``variants`` that is not built yet, one nvcc each, all started
    together (for :func:`load_variant`)."""
    started = [_start(name, library_path(name, d), d) for d in variants
               if not library_path(name, d).exists()]
    for job in started:
        _finish(*job)


def load_all(names=None) -> None:
    """Load the libraries of ``names`` (default: every source), building
    the missing ones with one nvcc each, all started together.  Every nvcc
    is waited for before a failure is raised."""
    names = list(SIGNATURES if names is None else names)
    started = [_start(n, library_path(n)) for n in names
               if n not in _libs and not library_path(n).exists()]
    failures = []
    for job in started:
        try:
            _finish(*job)
        except RuntimeError as e:
            failures.append(str(e))
    if failures:
        raise RuntimeError("\n".join(failures))
    for n in names:
        load(n)


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    """The current stream of ``t``'s device, as the C entry points take it.

    The libraries launch on the CUDA runtime's current device, so the
    tensor must live there."""
    if t.device.index != torch.cuda.current_device():
        raise ValueError(
            f"tensor on {t.device} but the current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def n_sm(device: torch.device) -> int:
    """The SMs of a CUDA device (the launch plans size their grids by
    it), read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_operands(*tensors: torch.Tensor) -> int:
    """Common wrapper checks; returns the dtype code.

    Every operand must be a contiguous CUDA tensor of one float dtype
    (float32 or float64) on one device."""
    t0 = tensors[0]
    if t0.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or float64, not {t0.dtype}")
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"kernel operand on {t.device}, not on CUDA")
        if t.device != t0.device:
            raise ValueError(f"operands on {t0.device} and {t.device}")
        if t.dtype != t0.dtype:
            raise TypeError(f"mixed dtypes {t0.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return DTYPE_CODES[t0.dtype]


def chunk(n: int, tiles: int, slots: int, h: int) -> tuple[int, int]:
    """The even chunk of the marched axis of length ``n`` (and the number
    of chunks) whose grid of ``tiles`` tiles a chunk runs in the fewest
    steps a block slot, in whole waves of ``slots`` resident blocks: a
    block steps through its chunk and 2H halo steps (the plans of the
    fused kernels that march, csrc/fused2.cu and csrc/fused3.cu)."""
    best = None
    for waves in range(1, 17):
        cx = max(2, -(-n // max(1, waves * slots // tiles)))
        cx += cx & 1
        gc = -(-n // cx)
        steps = -(-(tiles * gc) // slots) * (min(cx, n) + 2 * h)
        if best is None or steps < best[0]:
            best = (steps, cx, gc)
    return best[1], best[2]
