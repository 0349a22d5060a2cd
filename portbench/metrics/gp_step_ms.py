"""Median host time of the window's gradient-penalty steps, each between
two synchronises (traced runs only)."""

UNIT, LAYER, MOVES = "ms", "train step", "train_videos_per_s.f32"


def read(ctx):
    return ctx["layer"].get("gp_step_ms")
