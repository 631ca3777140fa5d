"""rails_tpu_torch: the PyTorch + CUDA port of rails_tpu for NVIDIA Hopper.

The module layout mirrors `rails_tpu/`; each module names its JAX
counterpart. The port imports torch and numpy, never jax, flax or any module
of `rails_tpu`: it keeps its own copy of the configuration
(`core/config.py`).

Kernels (`ops/`) are hand-written CUDA for sm_90a, built with nvcc at first
use. Every kernel wrapper dispatches on its inputs' device: CPU tensors take
the kernel's plain PyTorch version, CUDA tensors launch the kernel or raise.
Entry points put their work on the card (`core.device.default_device`) unless
the caller passes `device="cpu"`.
"""

__version__ = "0.1.0"
