"""``setup_s``: host seconds from the harness's start to the timed call
(imports, the card, the capture, the kernels' build on a first run, the
warm call)."""


def read(run):
    return run.setup_s
