"""raster_bwd_roofline.train: the backward compositing kernel's share of its roofline in the
probe: its least time (the larger of its operations and bytes over the
card's peaks, counted by counts.py from the pairs the plain reference
finds on the probe's inputs) over its device time in the profiler's trace
of the probe."""


def read(ctx):
    probe = ctx.get("probe")
    if not probe or probe.get("kind") != "train" or "bwd_s" not in probe:
        return None
    device_s = sum(s for name, s in probe["kernels"].items()
                   if "rasterize_bwd_kernel" in name)
    if device_s <= 0:
        return None
    return 100.0 * probe["bwd_s"] / device_s
