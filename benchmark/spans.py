"""What the readers of the program's own spans share.

The port's run loops record every chunk's spans (``read``, ``schedule``,
``plan``, ``stage``, ``launch``, ``wait``, ``cut``, ``write``) on
``time.perf_counter``, each with the chunk's number, in a recorder that
``doppler_tpu_torch.runtime.telemetry.last_spans()`` returns after the call.
The traced stretch's device events are mapped onto the same clock
(:mod:`.trace`), so the two are compared directly.  A program without the
recorder gives None here, and so does every reader of it.
"""

from __future__ import annotations

from benchmark.trace import idle_gaps

__all__ = ["recorder", "intervals", "overlap_s", "idle_in_share",
           "in_share", "by_chunk", "open_loop"]


def recorder():
    """The recorder of the newest run loop (the timed call's), or None."""
    from doppler_tpu_torch.runtime import telemetry

    last = getattr(telemetry, "last_spans", None)
    rec = last() if last is not None else None
    return rec if rec is not None and len(rec.records) else None


def intervals(rec, names, lo: float, hi: float) -> list:
    """The spans of ``names`` cut to ``[lo, hi]``, merged, in time order."""
    out: list = []
    for a, b in sorted((max(t0, lo), min(t1, hi))
                       for name, _, t0, t1 in rec.records if name in names):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_s(xs, ys) -> float:
    """Seconds covered by both of two time-ordered lists of disjoint
    ``(start, end)`` intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _stretch_and_spans(run):
    st = run.stretch
    if st is None or st.seconds <= 0:
        return None, None
    rec = recorder()
    return (st, rec) if rec is not None else (None, None)


def idle_in_share(run, names) -> float | None:
    """Seconds of the traced stretch in which the card ran no kernel, copy
    or fill while the loop was in a span of ``names``, over the stretch's
    seconds, in percent."""
    st, rec = _stretch_and_spans(run)
    if st is None or not st.events:
        return None
    gaps = idle_gaps(st.events, st.t_start, st.t_end)
    spans = intervals(rec, names, st.t_start, st.t_end)
    return 100.0 * overlap_s(gaps, spans) / st.seconds


def in_share(run, names) -> float | None:
    """Seconds of the traced stretch in spans of ``names``, over the
    stretch's seconds, in percent."""
    st, rec = _stretch_and_spans(run)
    if st is None:
        return None
    spans = intervals(rec, names, st.t_start, st.t_end)
    return 100.0 * sum(b - a for a, b in spans) / st.seconds


def by_chunk(rec, name: str) -> dict:
    """``{chunk: (t0, t1)}`` of the spans of ``name``."""
    return {k: (t0, t1) for n, k, t0, t1 in rec.records if n == name}


def open_loop(run) -> bool:
    """Was the window fed by a live source (pieces falling due)?"""
    return hasattr(getattr(run, "source", None), "due")
