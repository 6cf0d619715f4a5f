"""radtran_call_p95_ms: the 95th percentile of every batch call's latency in
the window, from the call to its synced outputs, in ms."""

import statistics


def read(window):
    return 1e3 * statistics.quantiles(window["latencies_s"], n=20, method="inclusive")[18]
