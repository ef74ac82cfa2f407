"""Trajectory optimization on matrix Lie groups: the PyTorch / CUDA port.

The port of ``trajectory_optimization_matrix_lie_groups_tpu`` (the JAX
package, which stays the reference) to PyTorch, with its TPU kernels
rewritten by hand in CUDA C++ for NVIDIA Hopper (``csrc/``).  Module layout
and function names follow the JAX package so that each module's counterpart
is easy to find.

Conventions kept from the JAX package:
- twists are ordered ``[omega, v]`` (angular first);
- the lane layout puts the batch last, ``(N, 3, 3, B)``, ``(N, 12, 12, B)``:
  on the GPU one thread owns one problem and neighbouring threads read
  neighbouring addresses.

This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
