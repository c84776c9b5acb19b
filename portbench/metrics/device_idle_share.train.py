"""device_idle_share.train: the share of the profiled slice's wall time in
which no kernel, copy or fill ran on the card (the union of the device
intervals from the profiler's trace)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    tr = ctx["trace"]
    if tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
