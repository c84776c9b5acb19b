"""densify_event_ms: the densify event's cost, from the harness's own
spans.  In the traced window every step ends in a synchronisation; an
event step's time less the mean of the plain steps since the last event,
averaged over the window's events."""

import statistics


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    out, plain = [], []
    for seconds, event in ctx["steps"]:
        if event:
            if plain:
                out.append((seconds - statistics.mean(plain)) * 1e3)
            plain = []
        else:
            plain.append(seconds)
    return statistics.mean(out) if out else None
