"""DeepFlame on PyTorch and CUDA: the port of `deepflame_tpu` to one NVIDIA
H100.

The package mirrors the JAX package's module names. Plain tensor code is
PyTorch; the Pallas TPU kernels of the solver path are hand-written CUDA C++
kernels for Hopper (`ops/kernels.py`, sources in `csrc/`), each with a plain
PyTorch version that CPU tensors take. Entry points run on the CUDA card
unless the caller passes `device="cpu"`; with no card and no such request
they raise. This package imports neither JAX nor `deepflame_tpu`.
"""

__version__ = "0.1.0"
