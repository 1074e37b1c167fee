"""The benchmark of ``cedar_tpu_torch``, the PyTorch and CUDA port.

``BENCHMARK.json`` (at the root of the repository) lists the cells, each a
configuration (``configs/<name>.json``) under a traffic mix
(``traffic/<name>.json``), and the metrics, each read by
``metrics/<name>.py``.  ``run.py`` runs one cell; ``calibrate.py`` takes
the readings that the correctness limits are set from.  Nothing here
imports JAX or the JAX package, and ``reference/`` imports nothing of the
port either.
"""
