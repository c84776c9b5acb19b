"""event_syncs: per densify event, the blocking runtime calls
(``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize``, a synchronous ``cudaMemcpy``) made inside the
``densify.event`` span, from the span slice (``span_slice.py``)."""

import span_slice


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return span_slice.event_value(ctx, "syncs")
