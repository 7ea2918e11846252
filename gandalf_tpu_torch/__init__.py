"""PyTorch and CUDA port of gandalf_tpu's grad-h SPH, meshless
finite-volume and direct-summation N-body paths.

The JAX package ``gandalf_tpu`` stays the reference.  This package runs
the same steps with plain torch tensors and with kernels written in CUDA
C++ for Hopper (``csrc/``): the structured 27-cell grid (K1-K3), the
KD-bucket Barnes-Hut tree (K4-K7), the active-subset passes of block
timesteps (K8, K9), the meshless finite-volume passes (K10-K12) and
the all-pairs gravity of the N-body stars (K13-K15).

A tensor on the CPU takes each kernel's plain PyTorch version; a tensor
on a CUDA device takes the kernel, or the call raises.

The package imports torch and numpy, never JAX nor anything of
``gandalf_tpu``: it keeps its own copies of the host-only modules it
needs (``params``, ``units``, ``sim.ic``, ``utils``) and of the C++ tree
planner (``native``).
"""

__version__ = "0.1.0"
