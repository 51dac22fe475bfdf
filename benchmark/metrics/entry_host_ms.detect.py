"""entry_host_ms.detect: the detection entry's own host time per group
(`detect.evaluate_anomaly_batch`): the span around the call less the span
from the call of `fb` to the chain's end (the layout changes, the copies
and `metrics.batched_anomaly_metrics`), the mean over the window's groups.
Program span (the benchmark's spans around the entry and its `fb`)."""


def read(run):
    spans = run.host.get("entry_self")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3
