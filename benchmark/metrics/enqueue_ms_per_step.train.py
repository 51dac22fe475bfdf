"""enqueue_ms_per_step.train: host time of one dispatch of the train step
(`train.dispatch_of`'s step with the batch's copy), the mean over the
window.  A step makes no host sync, so this is the host's cost of a step,
unless the launch queue is full.  Program span."""


def read(run):
    spans = run.host.get("dispatch")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
