"""webdgs_tpu_torch — the PyTorch + CUDA port of webdgs_tpu.

The JAX package ``webdgs_tpu`` is the reference this port is held against;
module names mirror it one to one (``webdgs_tpu/ops/binning.py`` <->
``webdgs_tpu_torch/ops/binning.py``).  The port imports torch, numpy and
PIL, never jax.  Its hot kernels are hand-written CUDA C++ for Hopper
(``csrc/``), built at first use by :mod:`webdgs_tpu_torch._build`.

All math is float32: TF32 is switched off for matmuls and cuDNN at import,
so a float32 product on the card keeps its full mantissa, as the JAX
package's "highest" tier does.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
