"""The FLOPs of the videos requested (padding left out), counted on the
plain reference, over the summed service time and the peak of the
configuration's dtype."""

UNIT, LAYER, MOVES = "%", "models", "serve_p95_ms"


def read(ctx):
    return ctx["layer"].get("mfu")
