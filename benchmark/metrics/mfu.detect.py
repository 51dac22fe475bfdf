"""mfu.detect: the UNet forwards' FLOPs in the traced window (per image
counted on the frozen reference UNet of the cell's config, times the batch
and the forwards) over the window and the H100's bf16 dense peak, in %.
Device trace (the traced window's length)."""

from benchmark.core import yardstick as ys


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0 or "forwards" not in tr.units:
        return None
    flops = (ys.forward_flops_per_image(run.cfg) * tr.units["batch"]
             * tr.units["forwards"])
    return flops / tr.window_s / ys.PEAK_BF16_FLOPS * 100.0
