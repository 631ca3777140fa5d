"""rails_tpu_torch: the PyTorch + CUDA port of rails_tpu for NVIDIA Hopper.

The module layout mirrors `rails_tpu/`; each module names its JAX
counterpart. The port imports torch and numpy, never jax or flax: the only
piece it shares with `rails_tpu` is the framework-free `rails_tpu.core.config`.

Kernels (`ops/`) are hand-written CUDA for sm_90a, built with nvcc at first
use. Every kernel wrapper dispatches on its inputs' device: CPU tensors take
the kernel's plain PyTorch version, CUDA tensors launch the kernel or raise.
"""

__version__ = "0.1.0"
