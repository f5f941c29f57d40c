"""``idle_in_stage_share.replay`` (host plan and stage): seconds of the
traced stretch in which the card was idle while the program's run loop was
in a ``stage`` span (the input and plan words into pinned buffers), over
the stretch's seconds, in percent."""

from benchmark.spans import idle_in_share


def read(run):
    return idle_in_share(run, ("stage",))
