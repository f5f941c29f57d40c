"""``latency_p95_ms``: the 95th percentile, over every piece of an open-loop
window, of the time from when the piece's last sample fell due to when the
output that covers that sample (by the rate ratio, ``benchmark/readings.py``) was
written."""

from benchmark.readings import p95_ms, piece_times


def read(run):
    t = piece_times(run)
    if t is None:
        return None
    due, _, written = t
    return p95_ms(written - due)
