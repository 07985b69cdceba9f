"""papr-tpu-torch: the PyTorch + CUDA port of papr_tpu's render path.

The package mirrors ``papr_tpu/``'s layout (``config.py``, ``nn/``, ``ops/``,
``model/``, ``train/step.py``) so each module's counterpart sits under the
same path. It imports torch, never jax. Every Pallas kernel on the render
path has a hand-written CUDA C++ counterpart under ``csrc/`` (built for
``sm_90a`` on first use by ``kernels/build.py``) beside a plain PyTorch
version in the same module; a wrapper takes the plain version only for
tensors that lie on the CPU.
"""

import torch as _torch

__version__ = "0.1.0"

# fp32 parity (UNet convolutions, plain matmuls) needs full-precision fp32 on
# the card: cuDNN convolutions default to TF32, which keeps ~3 digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
