"""host_copy_ms.view: device ms per frame of the copies the port launched
inside its ``view.host_copy`` span (the frame to the host), from the span
slice (``span_slice.py``)."""

import span_slice


def read(ctx):
    if ctx.get("kind") != "view":
        return None
    return span_slice.frame_ms(ctx, "view.host_copy", copies=True)
