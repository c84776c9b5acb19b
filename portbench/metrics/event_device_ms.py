"""event_device_ms: per densify event, the union of the device intervals
of the work the port launched inside its ``densify.event`` span, from the
span slice (``span_slice.py``)."""

import span_slice


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return span_slice.event_value(ctx, "device_ms")
