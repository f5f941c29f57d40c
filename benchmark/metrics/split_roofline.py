"""``split_roofline`` (kernels): the split route's share of its bound over
a traced stretch: the channel cascade's front (``cascade_kernel``) and the
rational tail (``window_kernel``), summed, against the least time of the
whole route a chunk (``benchmark/roofline.py`` over every stage, float32
planes out) times the chunks recorded.  None where the channels keep more
than one output rate: one set of stages does not bound their chunk."""

from benchmark.check import channel_rates, stages_of
from benchmark.readings import chunk_geometry, kernel_events
from benchmark.roofline import bound_s


def read(run):
    st = run.stretch
    if st is None or run.cell.config["mode"] != "channels":
        return None
    if len(set(channel_rates(run.cell.config))) > 1:
        return None
    front = kernel_events(st, "cascade_kernel")
    tail = kernel_events(st, "window_kernel")
    geometry = chunk_geometry(run)
    if not front or not tail or geometry is None:
        return None
    stages = [(s.P, s.Q, s.T) for s in stages_of(run.cell.config)]
    bound, _ = bound_s(*geometry, stages, out_bytes=8)
    spent = sum(b - a for _, a, b in front + tail)
    return 100.0 * bound * len(front) / spent if spent > 0 else None
