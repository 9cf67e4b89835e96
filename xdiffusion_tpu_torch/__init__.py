"""PyTorch and CUDA port of xdiffusion_tpu for NVIDIA Hopper (H100).

The JAX package `xdiffusion_tpu` is the reference; this package imports
nothing of it, nor JAX. The same YAML configs drive it. Plain tensor code
is PyTorch; each Pallas kernel of the JAX package on a ported path is a
hand-written Hopper kernel (`csrc/`, built with nvcc at first use).

Entry points run on `cuda` unless the caller passes `device="cpu"`; with
no CUDA device and no explicit CPU request they raise.
"""

__version__ = "0.1.0"
