"""Host time the trainer waited on its dataset per step in the bfloat16
training cells: the harness's clock around each batch the trainer asked
for in the window (the loader, the pinned copy to the card), summed and
divided by the window's steps."""

UNIT, LAYER, MOVES = "ms", "trainer and data", "train_videos_per_s.bf16"


def read(ctx):
    return ctx["layer"].get("data_wait_ms")
