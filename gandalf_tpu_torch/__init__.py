"""PyTorch and CUDA port of gandalf_tpu's hydro-only grad-h SPH main path.

The JAX package ``gandalf_tpu`` stays the reference.  This package runs
the same global-timestep grad-h SPH step (predict, wrap, structured
27-shift grid hydro pass, correct, timestep) with plain torch tensors,
and with three kernels written in CUDA C++ for Hopper (``csrc/``):

- K1 ``grid27_bin``: cell id and stable slot rank per particle,
- K2 ``grid27_density``: the grad-h h-rho iteration over 27 cells,
- K3 ``grid27_forces``: the SPH pair forces over 27 cells.

A tensor on the CPU takes each kernel's plain PyTorch version; a tensor
on a CUDA device takes the kernel, or the call raises.

The package imports torch and numpy, never JAX.  It reuses the JAX
package's host-only modules (``params``, ``units``, ``sim.ic``,
``utils``), which import no JAX unless ``GANDALF_PRECISION`` asks
``gandalf_tpu`` for float64 JAX; leave that variable unset when using
this package.
"""

__version__ = "0.1.0"
