"""The share of the traced window in which no operation ran on the card
(kernels, copies and sets; their intervals' union is the busy time), in %.
Device trace."""


ENTRY = "detect"


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0 or run.traffic["entry"] != ENTRY:
        return None
    return (1.0 - tr.busy_s / tr.window_s) * 100.0
