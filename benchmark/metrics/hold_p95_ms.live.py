"""``hold_p95_ms.live`` (the run loop): the 95th percentile of the time
from the read that took a piece's last byte to the write of the output
that covers its last sample."""

from benchmark.readings import p95_ms, piece_times


def read(run):
    t = piece_times(run)
    if t is None:
        return None
    _, taken, written = t
    return p95_ms(written - taken)
