"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything a cell
is made of is found by name: a configuration is
``configs/<name>.json`` (its ``system`` module under ``systems/`` builds
the program, its ``reference`` module under ``reference/`` is the plain
PyTorch version), a traffic mix is ``traffic/<name>.json`` (its
``driver`` module under ``drivers/`` generates the load and runs the
window) and a metric is ``metrics/<name>.py``. Weights, frames and
questions are made here from the seed; the program receives only them.
Nothing here imports ``jax`` or the JAX package.
"""
