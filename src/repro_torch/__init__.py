"""PyTorch + CUDA port of the SparseSwaps pruning system.

Sits beside the JAX package ``repro`` and mirrors its module names
(``configs``, ``core``, ``kernels``, ``models``, ``data``, ``pruning``,
``launch``), so each module's counterpart is found under the same path.
The port imports ``torch`` and ``numpy`` only — never ``jax`` and nothing
of ``repro``. Importing any module needs no CUDA toolchain: the
hand-written kernels under ``csrc/`` build on their first launch.
"""
