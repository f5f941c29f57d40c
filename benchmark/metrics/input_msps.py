"""``input_msps``: capture samples the program consumed (wideband samples
in channels mode) over the whole timed call, in millions a second."""


def read(run):
    if run.wall_s <= 0 or run.n_in <= 0:
        return None
    return run.n_in / run.wall_s / 1e6
