"""PyTorch/CUDA port of the ternary (W1.58A8) serving system.

The JAX package ``repro`` is the reference; this package computes the same
functions with PyTorch and hand-written Hopper (sm_90a) CUDA kernels.  It
imports neither ``jax`` nor anything of ``repro``.

Importing the package pins TF32 off for float32 matrix products and
convolutions: the pre-decoded ternary GEMM (``core.bitlinear``) is exact
only while every f32 operand and partial sum is an integer below 2^24, and
TF32 would round the operands to 10 mantissa bits.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
