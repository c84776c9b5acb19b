"""bin_ms.train: device ms per plain training step of the work the port
launched inside its ``bin`` span under ``train.step`` (outside
``densify.event``), from the span slice (``span_slice.py``)."""

import span_slice


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return span_slice.step_ms(ctx, "bin")
