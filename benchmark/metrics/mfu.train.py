"""mfu.train: the train steps' FLOPs in the traced window (forward and
backward per image, counted on the frozen reference UNet, times the batch
and the steps) over the window and the H100's bf16 dense peak, in %.
Device trace."""

from benchmark.core import yardstick as ys


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0 or "steps" not in tr.units:
        return None
    flops = (ys.train_flops_per_image(run.cfg) * tr.units["batch"]
             * tr.units["steps"])
    return flops / tr.window_s / ys.PEAK_BF16_FLOPS * 100.0
