"""data.wait_ms: host milliseconds a step of the window spent in next() on
the Prefetcher (the harness's span around it)."""


def read(rec):
    w = rec.get("data_wait_s")
    return 1e3 * sum(w) / len(w) if w else None
