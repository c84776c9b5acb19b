"""event_idle_ms: per densify event, the ``densify.event`` span's wall
time less the union of every device interval inside it: how long the
host held the card idle during the event (span slice,
``span_slice.py``)."""

import span_slice


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return span_slice.event_value(ctx, "idle_ms")
