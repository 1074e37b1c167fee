"""Which version of an op runs: the hand-written kernel or its plain torch
version (``kernels.backend``).

cedar_tpu resolves ``kernels.backend`` at solver construction
(cedar_tpu/solver/solver2.py:264-277, solver3.py:221-256): ``auto`` runs
its Pallas kernels where they can run, ``xla`` runs the XLA ops
everywhere, and a ``plane-config`` or ``cg-config`` may pin its own value.
Here the solvers resolve it the same way (:func:`resolve`: ``auto`` is
``pallas``, the hand-written kernels, on the card and ``xla`` on the CPU;
a plane-config or cg-config that does not pin a value inherits the
outer one), and the ops' dispatchers ask :func:`kernels`: a CUDA tensor
launches the kernel unless the innermost :func:`using` block says
``xla``; a CPU tensor always takes the plain version, since no kernel
runs there.  The solvers enter :func:`using` around their setup and
cycles (the captured graphs included), the plane path and the inner
solve around theirs, so the configured value reaches every launch on the
path.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_plain = contextvars.ContextVar("cedar_tpu_torch_plain_ops", default=False)


def kernels(t: torch.Tensor, what: str = "op") -> bool:
    """Whether the op on ``t`` launches its kernel: on a CUDA tensor unless
    the backend is ``xla``; never on a CPU tensor.  Other devices raise."""
    if t.is_cuda:
        return not _plain.get()
    if t.device.type != "cpu":
        raise NotImplementedError(f"no {what} for tensors on {t.device}")
    return False


def resolve(settings, conf, on_card: bool) -> None:
    """Set ``settings.kernel_backend`` (an ``MLSettings`` of ``conf``) and
    its nested settings' from ``kernels.backend``: ``auto`` is
    ``pallas`` where the solve runs ``on_card``, else ``xla``; a
    plane-config or cg-config inherits the value unless it pins its own
    (cedar_tpu/solver/solver3.py:237-256)."""
    kb = conf.get("kernels.backend", "auto")
    if kb not in ("xla", "pallas"):
        kb = "pallas" if on_card else "xla"
    _inherit(settings, conf, kb)


def _inherit(settings, conf, kb: str) -> None:
    own = conf.get("kernels.backend", None) if conf is not None else None
    settings.kernel_backend = own if own in ("xla", "pallas") else kb
    if settings.cg_settings is not None:
        _inherit(settings.cg_settings, settings.coarse_config,
                 settings.kernel_backend)
    if settings.plane_settings is not None:
        _inherit(settings.plane_settings,
                 conf.getconf("plane-config") if conf is not None else None,
                 settings.kernel_backend)


@contextlib.contextmanager
def using(backend: str):
    """Run the block under ``backend``: ``xla`` the plain versions, ``pallas``
    the kernels on CUDA tensors, ``auto`` (or None) the enclosing block's
    choice (at the top level: the kernels on CUDA tensors)."""
    if backend in (None, "auto"):
        yield
        return
    if backend not in ("xla", "pallas"):
        raise ValueError(f"invalid kernels.backend: {backend}")
    token = _plain.set(backend == "xla")
    try:
        yield
    finally:
        _plain.reset(token)
