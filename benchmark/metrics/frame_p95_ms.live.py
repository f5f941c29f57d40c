"""``frame_p95_ms.live`` (read and framing): the 95th percentile, over
every chunk of the timed call, of the program's ``read`` span: how long the
run loop waits for a chunk's blocks to arrive."""

from benchmark.readings import p95_ms
from benchmark.spans import by_chunk, open_loop, recorder


def read(run):
    rec = recorder()
    if rec is None or not open_loop(run):
        return None
    return p95_ms([t1 - t0 for t0, t1 in by_chunk(rec, "read").values()])
