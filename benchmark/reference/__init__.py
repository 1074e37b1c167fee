"""The benchmark's plain references, one module per operator family.

A configuration names its operator (``"operator"`` in
``configs/<name>.json``); ``reference/<operator>.py`` builds that
operator on the device from the published formula and applies it in plain
torch.  The harness hands the operator it builds to the solver under test
and, after the window, judges the solver's answers by the same module's
:func:`apply`.  Nothing here imports the solver under test.

Each operator module has:

* ``build(coefficients, grid, device, dtype)``: the stencil, Cedar's
  layout (interior points only; the diagonal, then the "lower"
  couplings with a positive sign, ``A = diag - offdiag``);
* ``apply(so, x)``: ``A x``;
* ``rhs_scale(grid)``: the product of the mesh widths, by which the
  gallery scales its sources.
"""

from __future__ import annotations

import importlib


def load(operator: str):
    """The reference module of ``operator``."""
    return importlib.import_module(f"{__name__}.{operator}")
