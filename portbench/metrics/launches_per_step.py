"""launches_per_step: CUDA kernel launches per training step in the
profiled slice of the window (the runtime's launch calls)."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    tr = ctx["trace"]
    return tr["launches"] / tr["units"] if tr["launches"] else None
