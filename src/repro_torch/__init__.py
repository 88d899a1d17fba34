"""Venus on PyTorch and CUDA: the port of the JAX/TPU package ``repro``.

Same layout: ``kernels/`` (hand-written Hopper kernels, their plain
PyTorch versions and the dispatch layer), ``core/`` (memory, ingest
stages, query plans, sessions) and ``data/``. Imports ``torch`` and
``numpy``, never ``jax`` and nothing of ``repro``.
"""
