"""Device traces of steady stretches of the traced window.

``torch.profiler`` (CPU and CUDA activity) records a stretch inside the
window; the chrome trace it exports gives each kernel, copy and fill on the
card with its start and duration.  An annotation at the stretch's start
ties the trace's clock to the host clock, so the device's idle gaps can be
set beside what the benchmark's own source and sink were doing.

The profiler is known to lose records: the first few of a session once
other sessions have run in the process, and now and then more.  As the
port's ``tools/common.device_us`` does, a session opens with spin kernels
that take those first places, an empty session runs before the window, and
a stretch counts as complete only when its trace holds as many fused-kernel
records as the program's own launch counters rose by; the run says so on
standard error.  One stretch is recorded (see :class:`Tracer`).  A stretch that lost records is not rescaled: the kernel
shares are taken over the launches it recorded.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

__all__ = ["Stretch", "Tracer", "DEVICE_CATS", "union_s", "idle_gaps",
           "breakdown"]

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_SPIN = "spin_kernel"       # torch.cuda._sleep's kernel
_SPINS = 32
_ANCHOR = "benchmark_stretch_anchor"


@dataclass
class Stretch:
    """One recorded stretch: host times, the device events in host time
    ``(name, start, end)``, the program's launch counters over it, and the
    input bytes the source handed out over it (None if the window closed
    inside it)."""

    t_start: float = 0.0
    t_end: float = 0.0
    events: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)
    bytes_in: int | None = None
    complete: bool = False

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


def union_s(events, t_lo: float, t_hi: float) -> float:
    """Seconds of ``[t_lo, t_hi]`` covered by at least one event."""
    total, cur_lo, cur_hi = 0.0, None, None
    for _, a, b in sorted(events, key=lambda e: e[1]):
        a, b = max(a, t_lo), min(b, t_hi)
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total


def idle_gaps(events, t_lo: float, t_hi: float) -> list:
    """``(start, end)`` of every stretch of ``[t_lo, t_hi]`` with no event."""
    gaps, cur = [], t_lo
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if a > cur:
            gaps.append((cur, min(a, t_hi)))
        cur = max(cur, b)
        if cur >= t_hi:
            break
    if cur < t_hi:
        gaps.append((cur, t_hi))
    return [g for g in gaps if g[1] > g[0]]


class Tracer:
    """Records one stretch of the window from inside the source's reads.

    ``start``, ``length``: the stretch in host time; ``counters()``: the
    program's launch counters now; ``spans``: the source's and sink's span
    recorders, switched on for the stretch; ``workdir``: where the trace is
    written and read back (removed after).  One stretch, read after the
    window: a session exported after a later session has run reads every
    device event as zero."""

    def __init__(self, start: float, length: float, counters, spans,
                 workdir: str):
        self._start, self._len = start, length
        self._counters = counters
        self._spans = spans
        self._workdir = workdir
        self._prof = None
        self._done = None          # (Stretch, profiler, anchor host time)
        self._seen = None          # the counters' sum at the last due read
        self.stretch = None

    @staticmethod
    def warm() -> None:
        """An empty session before the window: starts the tracer's
        machinery in set-up, and what it leaves behind lands there."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.cuda._sleep(1)
            torch.cuda.synchronize()

    def poll(self, now: float, nbytes: int) -> None:
        """Called as every read starts, with the bytes read so far: start or
        stop the stretch when it is due, at the first read after the
        program launched, so that the stretch holds whole chunks and the
        bytes read over it are the input of the launches it counted."""
        opening = (self._prof is None and self._done is None
                   and now >= self._start)
        closing = (self._prof is not None
                   and now >= self._cur.t_start + self._len)
        if not (opening or closing):
            self._seen = None      # the counters are read only when due
            return
        total = sum(self._counters().values())
        launched = self._seen is not None and total != self._seen
        self._seen = total
        if launched:
            (self._stop if closing else self._begin)(nbytes)

    def close(self) -> None:
        """End the stretch if it is still open when the window closes."""
        if self._prof is not None:
            self._stop(None)

    def _begin(self, nbytes: int) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        for _ in range(_SPINS):
            torch.cuda._sleep(1)
        with torch.profiler.record_function(_ANCHOR):
            anchor = time.perf_counter()
        self._cur = Stretch(t_start=anchor, launches=self._counters(),
                            bytes_in=nbytes)
        self._anchor = anchor
        for s in self._spans:
            s.on = True

    def _stop(self, nbytes: int | None) -> None:
        for s in self._spans:
            s.on = False
        self._cur.t_end = time.perf_counter()
        self._cur.bytes_in = (None if nbytes is None
                              else nbytes - self._cur.bytes_in)
        end_counts = self._counters()
        self._cur.launches = {k: end_counts[k] - v
                              for k, v in self._cur.launches.items()}
        self._prof.stop()
        self._done = (self._cur, self._prof, self._anchor)
        self._prof = None

    def read_back(self, complete) -> None:
        """Export and read the stretch into ``self.stretch`` (None when
        none was recorded); ``complete(stretch)`` says whether its records
        are whole."""
        if self._done is None:
            return
        st, prof, anchor = self._done
        path = os.path.join(self._workdir, "stretch.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        os.remove(path)
        evs = trace.get("traceEvents", []) if isinstance(trace, dict) else trace
        ts_anchor = next((e["ts"] for e in evs
                          if e.get("name") == _ANCHOR and "ts" in e), None)
        if ts_anchor is None:
            return
        off = anchor - float(ts_anchor) * 1e-6
        st.events = [
            (e.get("name", ""), float(e["ts"]) * 1e-6 + off,
             (float(e["ts"]) + float(e.get("dur", 0.0))) * 1e-6 + off)
            for e in evs
            if e.get("cat") in DEVICE_CATS and "ts" in e
            and _SPIN not in e.get("name", "")]
        st.complete = bool(complete(st))
        self.stretch = st


class _Cover:
    """How much of an interval a sorted list of disjoint spans covers."""

    def __init__(self, spans):
        import numpy as np

        arr = np.asarray(sorted(spans), dtype=np.float64).reshape(-1, 2)
        self._s, self._e = arr[:, 0], arr[:, 1]
        self._c = np.concatenate([[0.0], np.cumsum(self._e - self._s)])

    def __call__(self, a: float, b: float) -> float:
        import numpy as np

        i0 = int(np.searchsorted(self._e, a, "right"))
        i1 = int(np.searchsorted(self._s, b, "left"))
        if i1 <= i0:
            return 0.0
        tot = self._c[i1] - self._c[i0]
        tot -= max(0.0, a - self._s[i0]) + max(0.0, self._e[i1 - 1] - b)
        return float(max(0.0, tot))


def breakdown(stretch, read_spans, write_spans) -> dict:
    """The device operations that took most time in the stretch, and its
    idle time by what the benchmark was doing meanwhile: in its source's
    ``read``, in its sink's ``write``, or neither ("program"); first each
    kind's total, then the longest single gaps.  At most 10 entries each."""
    by_name: dict = {}
    for name, a, b in stretch.events:
        key = name if len(name) <= 120 else name[:117] + "..."
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    totals = {"read": 0.0, "write": 0.0, "program": 0.0}
    gaps = []
    in_read, in_write = _Cover(read_spans), _Cover(write_spans)
    for a, b in idle_gaps(stretch.events, stretch.t_start, stretch.t_end):
        r, w = in_read(a, b), in_write(a, b)
        kind = ("read" if r >= max(w, 0.5 * (b - a)) else
                "write" if w >= 0.5 * (b - a) else "program")
        totals[kind] += b - a
        gaps.append((f"longest, in {kind}", b - a))
    out = [[f"all, in {k}", v] for k, v in totals.items() if v > 0]
    out += [list(g) for g in sorted(gaps, key=lambda g: -g[1])]
    return {"device_ops": [list(o) for o in ops], "idle_gaps": out[:10]}
