"""Render settings (counterpart of webdgs_tpu/config.py:18-182).

Only the semantic fields are carried over.  The TPU execution knobs of the
reference (``tiles_per_step``, ``dma_group``, ``matmul_precision``,
``grad_reduce_threshold``, ``expand_kernel``) have no counterpart: on a
CUDA tensor the port always runs its kernels, in float32.  The gradient path always takes the exact-f32 segment sum
(``ops/segsum.py``), which is the reference's default
(``grad_rows_f16=False``, ``segsum_kernel=True``) without its bf16 hi/lo
split; the f16 row tier has no counterpart.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render settings; defaults match ``webdgs_tpu.config``."""

    # tile size: an execution parameter (the image is the same for any
    # tiling); tile_w * tile_h pixels are one CUDA block of the rasterizer
    tile_w: int = 32
    tile_h: int = 16
    # splat-size multiplier (the viewer's Gaussian-scale slider)
    gaussian_scaling: float = 1.0
    # screen-space radius cap in pixels; <= 0 disables
    max_splat_radius_px: float = 128.0
    # at most this many tiles touched per Gaussian
    max_tiles_per_gaussian: int = 2048
    # sizing heuristic of the tile-entry capacity: average tiles/Gaussian
    avg_tiles_per_gaussian: int = 12
    # hard cap on tile entries
    max_tile_entries: int = 2 ** 25
    # background composited behind the splats
    background: tuple[float, float, float] = (0.0, 0.0, 0.0)
    # entries per rasterizer chunk (shared-memory staging width)
    chunk: int = 128
    # early-termination transmittance threshold (accumulated alpha > 0.99)
    t_threshold: float = 0.01
    # minimum alpha for a splat to contribute
    alpha_min: float = 1.0 / 255.0
    # alpha clamp
    alpha_max: float = 0.99
    # exact per-(gaussian, tile) alpha cull in binning (image-identical)
    tile_cull: bool = True
    # the Gaussian-sharded paths send entry rows between ranks as float16,
    # centers relative to the entry's tile (parallel/sharding.py); the
    # cotangents go back in float32 either way
    exchange_f16: bool = True

    @property
    def tile_px(self) -> int:
        return self.tile_w * self.tile_h


DEFAULT_SETTINGS = RenderSettings()


def quantize_budget(want: int | float, chunk: int, floor: int) -> int:
    """Round a capacity request UP to a coarse geometric ladder (~8 rungs
    per octave), in ``chunk`` multiples (webdgs_tpu/config.py:169).

    The port recompiles nothing when a capacity changes, but the ladder
    still keeps a growing scene from reallocating its entry buffers at
    every frame."""
    want = max(int(want), floor, chunk)
    g = max(1 << max(want.bit_length() - 3, 0), chunk)
    return -(-(-(-want // g) * g) // chunk) * chunk
