"""``device_wait_share.replay`` (device): seconds of the traced stretch in
the program's ``wait`` spans, the host blocked until a chunk's
device-to-host copy was done, over the stretch's seconds, in percent.  It
rises once the card, not the host, sets the pace."""

from benchmark.spans import in_share


def read(run):
    return in_share(run, ("wait",))
