"""tfmpc-tpu on PyTorch and CUDA: batched iLQR for model-predictive control.

The port of the JAX package ``tfmpc_tpu`` to PyTorch, with the Pallas
kernels of its main path rewritten as hand-written CUDA kernels for Hopper
(``ops/csrc``). The layout mirrors the JAX package (``core``, ``models``,
``solvers``, ``ops``). Kernels are built with ``nvcc`` at their first launch,
never at import, so ``import tfmpc_tpu_torch`` needs neither a GPU nor a
CUDA toolkit.
"""

__version__ = "0.1.0"
