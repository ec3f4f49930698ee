"""PyTorch/CUDA port of ``arl_conditional_normalizing_flows_tpu``.

The JAX package is the reference this port is held against; the port never
imports it (nor jax/flax). Module names follow the JAX package, so each
counterpart sits at the same relative path. Flow tensors keep the JAX layout
``(B, H, W, D)`` at every public function.

The hand-written Hopper kernels (``csrc/``) are built with ``nvcc`` at first
use into ``_build/`` and loaded with ``ctypes`` (``ops/kernels/build.py``).
"""
