"""train_step_mfu: the probe's training step's share of the card's float32
peak: the operations counts.py gives for its inputs (alive Gaussians, SH
degree, pixels, and the (pixel, entry) pairs the plain reference counts)
over its synchronised wall time times 67 TFLOP/s."""

import counts


def read(ctx):
    probe = ctx.get("probe")
    if not probe or probe.get("kind") != "train" or "flops" not in probe:
        return None
    seconds = probe["wall_s"] * probe["units"]
    return 100.0 * probe["flops"] / (seconds * counts.PEAK_FLOPS)
