"""frame_mfu: the probe frame's share of the card's float32 peak: the
operations counts.py gives for its inputs (alive Gaussians, SH degree and
the (pixel, entry) pairs the plain reference counts) over the frame's
synchronised wall time, host image included, times 67 TFLOP/s."""

import counts


def read(ctx):
    probe = ctx.get("probe")
    if not probe or probe.get("kind") != "view" or "flops" not in probe:
        return None
    return 100.0 * probe["flops"] / (probe["wall_s"] * counts.PEAK_FLOPS)
