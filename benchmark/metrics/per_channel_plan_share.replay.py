"""``per_channel_plan_share.replay`` (host plan and stage): the
channel-chunks of the timed call that the channels planner sent to one
``plan_blocks`` a channel (``chan_plans_per_channel``) over all it planned
(that and ``chan_plans_periodic`` and ``chan_plans_uniform``, the two
vectorised lanes), in percent: the share the lanes miss."""

from benchmark.spans import recorder

LANES = ("chan_plans_periodic", "chan_plans_uniform", "chan_plans_per_channel")


def read(run):
    rec = recorder()
    if rec is None or not all(k in rec.counters for k in LANES):
        return None
    total = sum(rec.counters[k] for k in LANES)
    if total <= 0:
        return None
    return 100.0 * rec.counters["chan_plans_per_channel"] / total
