"""superdsm_tpu_torch — the segmentation pipeline on PyTorch and CUDA.

A port of :mod:`superdsm_tpu` (JAX on a TPU) to PyTorch on an NVIDIA GPU,
module for module: the host modules are carried over, the batched Newton
solver runs on torch tensors, and the Newton gram reduction — the only
Pallas kernel of the JAX package — is a hand-written CUDA kernel
(``csrc/gram_grad_hess.cu``, built with ``nvcc`` for ``sm_90a`` on first
use). The package never imports JAX nor the JAX package.

The device is explicit (:mod:`superdsm_tpu_torch._device`): CUDA by default,
with no silent CPU fallback; tests select ``'cpu'``.
"""

import torch

# cuDNN convolutions default to TF32, which would cost the Gaussian filters
# ~3 decimal digits; matmuls are pinned the same way so every float32
# product on the card is full float32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ._device import get_device, set_device, use_device  # noqa: E402,F401
from .pipeline import (Pipeline, Stage, create_pipeline,  # noqa: E402,F401
                       create_default_pipeline)
from .config import Config  # noqa: E402,F401
from . import automation  # noqa: E402,F401
