"""launches_per_frame: CUDA kernel launches per viewer frame in the
profiled slice of the window (the runtime's launch calls)."""


def read(ctx):
    if ctx.get("kind") != "view":
        return None
    tr = ctx["trace"]
    return tr["launches"] / tr["units"] if tr["launches"] else None
