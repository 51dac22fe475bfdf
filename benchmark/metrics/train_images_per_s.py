"""train_images_per_s: images of every train step dispatched in the
window, over the window, which ends at a synchronise after the last
dispatch.  Host clock."""


def read(run):
    if run.traffic["entry"] != "train" or run.window_s <= 0:
        return None
    return run.units / run.window_s
