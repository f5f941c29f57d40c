"""``channel_cascade_roofline`` (kernels): the channel cascade's share of
its bound over a traced stretch, where it is the whole route (every stage
fused, i16 pairs out): the least time of a launch (``benchmark/roofline.py``
over the configuration's stages, at the chunk geometry the stretch counted)
times the ``cascade_kernel`` launches recorded, over their device time.
None outside ``channels`` mode, on the split route (a ``window_kernel``
in the stretch), which ``split_roofline`` reads, and where the channels
keep more than one output rate."""

from benchmark.check import channel_rates, stages_of
from benchmark.readings import chunk_geometry, kernel_events
from benchmark.roofline import bound_s


def read(run):
    st = run.stretch
    if st is None or run.cell.config["mode"] != "channels":
        return None
    if len(set(channel_rates(run.cell.config))) > 1:
        return None
    if kernel_events(st, "window_kernel"):
        return None
    launches = kernel_events(st, "cascade_kernel")
    geometry = chunk_geometry(run)
    if not launches or geometry is None:
        return None
    stages = [(s.P, s.Q, s.T) for s in stages_of(run.cell.config)]
    bound, _ = bound_s(*geometry, stages, out_bytes=4)
    spent = sum(b - a for _, a, b in launches)
    return 100.0 * bound * len(launches) / spent if spent > 0 else None
