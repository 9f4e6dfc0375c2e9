"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

* ``gram``        — fp32-accumulating Xᵀ X for calibration (paper §2.1.2).
* ``swap_topk``   — fused k-best swap search (the k-swap hot path), and
  ``swap_commit``, the candidate-space commit of its candidates: the
  greedy decisions and their Eq. 6 apply, two kernels of one call.
* ``swap_argmin`` — fused 1-swap search (paper Eq. 5).
* ``spmm``        — packed sparse matmul (nm24 / gathered) with the bias
  and activation fused, for serving.

``ops`` holds the public wrappers (checks, output allocation, launch
counters; CPU tensors take the plain versions); ``build`` compiles the
sources under ``csrc/`` on first launch; ``ref`` holds dense oracles.
Importing this package needs no CUDA toolchain.
"""
from . import ops, ref  # noqa: F401
