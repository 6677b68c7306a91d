"""hipace_tpu_torch: the PyTorch and CUDA port of hipace_tpu.

The explicit-solver zeta sweep of hipace_tpu rewritten in eager PyTorch for
one NVIDIA H100. The three Pallas kernels of the JAX package become
hand-written CUDA C++ kernels for sm_90a (``csrc/``):

- K1 particle deposit (``ops/deposit.py``),
- K2 fused main-fields gather (``ops/gather.py``),
- K3 multigrid Bx/By solve (``ops/mg_kernel.py``).

Each kernel has a plain PyTorch version beside it. CPU tensors take the
plain version; CUDA tensors launch the kernel or raise. The JAX package is
the reference the port is held to and is never imported here: deck parsing,
constants and geometry are shared through its jax-free modules.
"""

__version__ = "0.1.0"
