"""k2_roofline.detect: the bytes bound of every K2 call in the traced
window (x read once, the output written once, at each of the forward's
sites, from its shape), at 3.35 TB/s, over the summed device time of K2's
kernels, in %.  Silent unless the trace holds one K2 call per site and
forward.  Device trace."""

from benchmark.core import yardstick as ys


def read(run):
    tr = run.trace
    if tr is None or "forwards" not in tr.units:
        return None
    seconds, calls = tr.seconds_of(ys.K2_NAME)
    forwards = tr.units["forwards"]
    if seconds <= 0 or calls != forwards * ys.k2_sites(run.cfg):
        return None
    bound = (ys.k2_bytes_per_forward(run.cfg, tr.units["batch"]) * forwards
             / ys.HBM_BYTES_PER_S)
    return bound / seconds * 100.0
