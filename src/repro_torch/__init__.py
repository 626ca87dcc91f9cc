"""PyTorch + CUDA port of the census-block mapping engine (``repro``).

The layout mirrors ``repro``: ``core/`` holds the host map build, the
index and the engine; ``kernels/`` holds the hand-written CUDA kernels
(``csrc/``), their plain PyTorch twins (``ref.py``) and the dispatch
(``ops.py``).  The package imports neither ``jax`` nor ``repro``.
"""
