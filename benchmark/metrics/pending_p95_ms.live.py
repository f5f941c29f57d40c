"""``pending_p95_ms.live`` (run loop): the 95th percentile, over every
chunk of the timed call, of the time from the end of the chunk's ``launch``
span to the start of its ``wait`` span: how long a launched chunk waits
for its emit, which comes once its copy is done, at a block of the next
chunk's read (else after the next chunk's launch)."""

from benchmark.readings import p95_ms
from benchmark.spans import by_chunk, open_loop, recorder


def read(run):
    rec = recorder()
    if rec is None or not open_loop(run):
        return None
    launch, wait = by_chunk(rec, "launch"), by_chunk(rec, "wait")
    return p95_ms([wait[k][0] - t1 for k, (_, t1) in launch.items()
                   if k in wait])
