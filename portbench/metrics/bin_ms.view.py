"""bin_ms.view: device ms per frame of the work the port launched inside
its ``bin`` span under ``view.frame``, from the span slice
(``span_slice.py``)."""

import span_slice


def read(ctx):
    if ctx.get("kind") != "view":
        return None
    return span_slice.frame_ms(ctx, "bin")
