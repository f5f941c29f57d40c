"""``schedule_us_per_eval.replay`` (host plan and stage): the program's
``schedule`` span, its total over the timed call, over the instants the
track channels' schedulers propagated (the ``track_evals`` counter), in
microseconds.  None without the counter (no track channel, or a program
that does not count them)."""

from benchmark.spans import recorder


def read(run):
    rec = recorder()
    if rec is None:
        return None
    evals = rec.counters.get("track_evals", 0)
    spent = rec.totals.get("schedule", (0, 0.0))[1]
    return 1e6 * spent / evals if evals > 0 else None
