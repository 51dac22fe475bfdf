"""enqueue_ms_per_step.detect: host time of the `fb` call (the chain:
`diffusion.forward_backward` or `forward_backward_ddim`) per reverse step,
the mean over the window's groups.  The chain makes no host sync, so this
is the host's cost of a step, unless the launch queue is full (then the
host waits for the card inside it).  Program span."""


def read(run):
    spans = run.host.get("enqueue")
    if not spans:
        return None
    tr = run.traffic
    steps = int(tr["ddim_steps"]) if tr["sampler"] == "ddim" else int(tr["lambda"])
    return sum(spans) / len(spans) / steps * 1e3
