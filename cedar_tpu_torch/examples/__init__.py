"""The serial examples of cedar_tpu (``examples/*.py``) on the port.

Each module keeps its counterpart's positional size arguments, defaults,
configuration, dtype and printed lines, adds ``--device`` (default the
card; ``--device cpu`` runs the plain torch versions of the kernels), and
has a ``main(argv=None)`` that returns the lines it printed.  Run one with
``python -m cedar_tpu_torch.examples.<name> [sizes] [--device cpu]``
(``capi_poisson`` has no size: 128², as its counterpart).
"""
