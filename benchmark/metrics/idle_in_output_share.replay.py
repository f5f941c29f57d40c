"""``idle_in_output_share.replay`` (run loop): seconds of the traced
stretch in which the card was idle while the program's run loop was in a
``cut`` or ``write`` span (the output into each channel's bytes, and the
files written), over the stretch's seconds, in percent."""

from benchmark.spans import idle_in_share


def read(run):
    return idle_in_share(run, ("cut", "write"))
