"""slot_use.train: the port's ``slots.alive`` over its ``slots.capacity``
gauges, in %, over the span slice's plain steps (``span_slice.py``): the
share of the per-slot work that falls on live Gaussians."""

import span_slice


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return span_slice.slot_use(ctx)
