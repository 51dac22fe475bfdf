"""detect_slices_per_s: slices of every group whose metrics returned in
the window, over the window (whole groups: the window ends when the group
in flight at `--seconds` ends).  Host clock."""


def read(run):
    if run.traffic["entry"] != "detect" or run.window_s <= 0:
        return None
    return run.units / run.window_s
