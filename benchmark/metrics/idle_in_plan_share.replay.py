"""``idle_in_plan_share.replay`` (host plan and stage): seconds of the
traced stretch in which the card was idle (no kernel, copy or fill) while
the program's run loop was in a ``schedule`` or ``plan`` span, over the
stretch's seconds, in percent."""

from benchmark.spans import idle_in_share


def read(run):
    return idle_in_share(run, ("schedule", "plan"))
