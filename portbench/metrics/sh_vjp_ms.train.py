"""sh_vjp_ms.train: device ms per plain training step of the work the
port launched inside its ``sh_vjp`` span under ``train.step`` (with full
SH the SH colour's autograd; with DC only the routing of dL/dcolor into
the DC coefficient), from the span slice (``span_slice.py``).  None where
no plain step holds the span: a port without the SH stage."""

import span_slice

PATH = "train.step/sh_vjp"


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    sp = span_slice.spans(ctx)
    if sp is None or not any(PATH in u["host_self_ms"]
                             for u in sp["units"]
                             if u["name"] == "train.step"):
        return None
    return span_slice.step_ms(ctx, "sh_vjp")
