"""``device_idle_share.replay`` (device): one minus the union of the
kernels, copies and fills on the card over a traced stretch of the window,
in percent."""

from benchmark.readings import busy_s


def read(run):
    st = run.stretch
    if st is None or st.seconds <= 0 or not st.events:
        return None
    return 100.0 * (1.0 - busy_s(st) / st.seconds)
