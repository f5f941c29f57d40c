"""``host_plan_share.replay`` (host plan and stage): the pipeline's own
``host_s`` counter, from the CLI's ``done`` line, over the timed call's
wall time, in percent."""

import math


def read(run):
    if run.wall_s <= 0 or not math.isfinite(run.host_s):
        return None
    return 100.0 * run.host_s / run.wall_s
