"""serve_batch_p95_ms: the 95th percentile over every batch of the window,
from the call with the host batch to its proposals on the host."""

from portbench.harness import percentile


def read(rec):
    return percentile(rec["latencies_s"], 95) * 1e3
