"""``input_wait_p95_ms.live`` (read and framing): the 95th percentile of
the time from a piece falling due to the return of the read that took its
last byte."""

from benchmark.readings import p95_ms, piece_times


def read(run):
    t = piece_times(run)
    if t is None:
        return None
    due, taken, _ = t
    return p95_ms(taken - due)
