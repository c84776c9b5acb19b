"""Operations and bytes that the benchmarked work needs, counted from its
inputs, and the card's peaks.

The pair counts come from the plain reference (``reference/gs.py``:
``composite(..., pairs=True)``): for each pixel, the entries of its tile
list up to its last contributor that fall in their extent box; an entry
outside the box needs no alpha.  Bytes count each input read once and each
output written once.  Peaks: NVIDIA's H100 SXM data sheet at its 700 W
limit, float32 outside the tensor cores, and HBM3; the card's power limit
is printed beside every share.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# float32 operations per (pixel, entry) pair: the alpha test and the
# compositing step forward; the alpha, the transmittance suffix and the
# four attribute gradients backward
FWD_PER_PAIR = 28
BWD_PER_PAIR = 54
# per alive Gaussian: the projection (view and clip transforms, covariance,
# EWA, conic, extents, tile rect), its gradient (about twice the forward),
# Adam on the trained lanes (3 + 4 + 3 + 1 + 3, twelve operations each)
PROJ_FWD = 200
PROJ_BWD = 400
ADAM = 14 * 12
# SH colour: the basis of k coefficients and three k-term sums
SH_BASIS = {0: 1, 1: 8, 2: 25, 3: 50}
SH_COEFFS = {0: 1, 1: 4, 2: 9, 3: 16}
# per pixel: the 5x5 box sums of five moments over three channels (two
# separable passes of four additions), the SSIM and the cotangent
LOSS_PER_PX = 3 * (5 * 2 * 4 + 30)
# floats per entry record (centre 2, conic 3, colour 3, opacity 1,
# extents 2), per pixel out (rgb, transmittance), per entry gradient
# (centre 2, conic 3, colour 3, opacity 1)
ENTRY_FLOATS = 11
PIXEL_OUT_FLOATS = 4
ENTRY_GRAD_FLOATS = 9


def sh_flops(sh_deg: int) -> int:
    return SH_BASIS[sh_deg] + 3 * 2 * SH_COEFFS[sh_deg]


def least_time(flops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, bound): the larger of the compute and memory bounds."""
    tc, tm = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (tc, "flops") if tc >= tm else (tm, "bytes")


def raster_fwd(pairs: float, entries: float, pixels: float,
               tiles: int) -> tuple[float, float]:
    """(flops, bytes) of the forward compositing of one frame."""
    return (FWD_PER_PAIR * pairs,
            4 * (ENTRY_FLOATS * entries + PIXEL_OUT_FLOATS * pixels
                 + tiles + 1))


def raster_bwd(pairs: float, entries: float, pixels: float,
               tiles: int) -> tuple[float, float]:
    """(flops, bytes) of the compositing's gradient of one frame: the
    entries and the pixels' cotangents and outputs in, the entries'
    gradients out."""
    return (BWD_PER_PAIR * pairs,
            4 * ((ENTRY_FLOATS + ENTRY_GRAD_FLOATS) * entries
                 + 2 * PIXEL_OUT_FLOATS * pixels + tiles + 1))


def train_step_flops(alive: int, sh_deg: int, pairs: float,
                     pixels: int) -> float:
    """A training step with DC-only SH: projection and colour forward,
    compositing both ways, the loss, the projection's gradient, Adam."""
    return (alive * (PROJ_FWD + sh_flops(sh_deg) + PROJ_BWD + ADAM)
            + (FWD_PER_PAIR + BWD_PER_PAIR) * pairs + LOSS_PER_PX * pixels)


def frame_flops(alive: int, sh_deg: int, pairs: float) -> float:
    """A viewer frame: projection and colour, forward compositing."""
    return alive * (PROJ_FWD + sh_flops(sh_deg)) + FWD_PER_PAIR * pairs
