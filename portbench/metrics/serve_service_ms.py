"""Median host time inside GeneratorService.generate per request in the
window, the time the request waited in the queue left out."""

UNIT, LAYER, MOVES = "ms", "service", "serve_p95_ms"


def read(ctx):
    return ctx["layer"].get("serve_service_ms")
