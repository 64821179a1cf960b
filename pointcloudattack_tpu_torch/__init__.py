"""PyTorch/CUDA port of pointcloudattack_tpu for NVIDIA Hopper (H100).

The JAX package ``pointcloudattack_tpu`` is the reference; this package
keeps its module layout and its channels-last ``[B, N, 3]`` public
layout.  Plain tensor code is PyTorch; each TPU kernel on a ported path is
a hand-written CUDA kernel under ``csrc/``, built with ``nvcc`` at first
use (``ops/_build.py``).  On a CPU tensor a kernel's wrapper runs its
plain PyTorch version; on a CUDA tensor it launches the kernel or raises.

Importing the package turns TF32 off for matmuls and cuDNN, so float32
stays float32 on the card, as the reference computes it.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
