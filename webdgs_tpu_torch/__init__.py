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

# name -> (module, attribute): the reference's top-level API
# (webdgs_tpu/__init__.py), resolved to the port's objects
_API = {
    "GaussianScene": ("webdgs_tpu_torch.core.scene", "GaussianScene"),
    "Camera": ("webdgs_tpu_torch.core.camera", "Camera"),
    "make_camera": ("webdgs_tpu_torch.core.camera", "make_camera"),
    "RenderSettings": ("webdgs_tpu_torch.config", "RenderSettings"),
    "render": ("webdgs_tpu_torch.render.renderer", "render"),
    "Viewer": ("webdgs_tpu_torch.render.viewer", "Viewer"),
    "Trainer": ("webdgs_tpu_torch.train.trainer", "Trainer"),
    "TrainerConfig": ("webdgs_tpu_torch.train.config", "TrainerConfig"),
    "load_point_cloud": ("webdgs_tpu_torch.io.ply", "load_point_cloud"),
    "save_ply": ("webdgs_tpu_torch.io.ply", "save_ply"),
    "load_cameras": ("webdgs_tpu_torch.io.colmap", "load_cameras"),
    "load_images": ("webdgs_tpu_torch.io.images", "load_images"),
}


def __getattr__(name):
    """The lazy top-level API: ``import webdgs_tpu_torch`` loads none of
    the modules below until a name is used."""
    if name in _API:
        import importlib
        mod, attr = _API[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(
        f"module 'webdgs_tpu_torch' has no attribute {name!r}")


__all__ = ["__version__", *_API]
