"""project_vjp_ms.train: device ms per plain training step of the work
the port launched inside its ``project_vjp`` span under ``train.step``
(the projection's autograd and the gradient routing), from the span
slice (``span_slice.py``)."""

import span_slice


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return span_slice.step_ms(ctx, "project_vjp")
