"""Host seconds of the program's own set-up: the sum of its `setup.*`
totals (the models' build, init, copy to the card and optimizers; the
dataset and loader; the kernels' build and load). The rest of `setup_s` is
import, the harness's data and weights, and the checked steps."""

from portbench.spans import profiling

UNIT, LAYER, MOVES = "s", "set-up", "setup_s"


def read(ctx):
    module = profiling()
    if module is None or not hasattr(module, "totals"):
        return None
    seconds = [v for n, v in module.totals().items() if n.startswith("setup.")]
    return sum(seconds) if seconds else None
