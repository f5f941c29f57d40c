"""Reading a traced stretch: the device events on the host's clock, the busy
union, and the idle gaps named by what the benchmark was doing."""

from __future__ import annotations

import json

import pytest

from benchmark.trace import Stretch, Tracer, breakdown, idle_gaps, union_s

_ANCHOR_TS = 1_416_529_485_900.0       # µs on the trace's clock


class FakeProfile:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def _ev(cat, name, t_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": _ANCHOR_TS + t_us,
            "dur": dur_us}


def test_a_stretch_is_read_on_the_host_clock(tmp_path):
    tracer = Tracer(0.0, 1.0, lambda: {}, [], str(tmp_path))
    st = Stretch(t_start=50.0, t_end=50.001)
    tracer._done = (st, FakeProfile([
        _ev("user_annotation", "benchmark_stretch_anchor", 0.0, 90.0),
        _ev("kernel", "at::cuda::spin_kernel(long)", 1.0, 1.0),
        _ev("kernel", "cascade_kernel<false>", 100.0, 20.0),
        _ev("gpu_memcpy", "Memcpy HtoD", 110.0, 40.0),
        _ev("cpu_op", "aten::copy_", 0.0, 500.0)]), 50.0)
    tracer.read_back(lambda s: len(s.events) == 2)
    got = tracer.stretch
    assert got.complete and [e[0] for e in got.events] == [
        "cascade_kernel<false>", "Memcpy HtoD"]
    assert got.events[0][1] == pytest.approx(50.0001, abs=1e-9)
    assert union_s(got.events, got.t_start, got.t_end) == pytest.approx(
        50e-6, abs=1e-9)


def test_idle_gaps_are_named_by_the_benchmarks_own_spans():
    st = Stretch(t_start=0.0, t_end=10.0,
                 events=[("k", 1.0, 2.0), ("k", 1.5, 3.0), ("c", 6.0, 7.0)])
    assert union_s(st.events, 0.0, 10.0) == pytest.approx(3.0)
    assert idle_gaps(st.events, 0.0, 10.0) == [(0.0, 1.0), (3.0, 6.0),
                                              (7.0, 10.0)]
    out = breakdown(st, read_spans=[(3.0, 5.5)], write_spans=[(7.0, 9.0)])
    assert out["device_ops"] == [["k", 2.5], ["c", 1.0]]
    totals = dict((k, v) for k, v in out["idle_gaps"] if k.startswith("all"))
    assert totals == {"all, in read": 3.0, "all, in write": 3.0,
                      "all, in program": 1.0}
    assert len(out["idle_gaps"]) <= 10


def test_a_stretch_holds_whole_chunks_and_gives_the_launched_geometry(
        monkeypatch, tmp_path):
    import time
    import types

    import torch

    from benchmark.readings import chunk_geometry

    class NoProfile:
        def __init__(self, **kwargs):
            pass

        def start(self):
            pass

        def stop(self):
            pass

    monkeypatch.setattr(torch.profiler, "profile", NoProfile)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    counts = {"cascade_channels": 0, "window": 0}
    t = time.perf_counter()        # the stretch's anchor is on this clock
    tracer = Tracer(t + 1.0, 2.0, lambda: dict(counts), [], str(tmp_path))
    # the program reads a chunk of 4 blocks of 100 bytes, then launches
    nbytes = 0
    for _ in range(30):
        for _ in range(4):
            tracer.poll(t, nbytes)
            nbytes += 100
            t += 0.03
        counts["cascade_channels"] += 1
        counts["window"] += 1
    tracer.close()
    st = tracer._done[0]
    assert st.bytes_in == 400 * st.launches["cascade_channels"] > 0
    run = types.SimpleNamespace(stretch=st, outputs=[0, 1, 2],
                                cell=types.SimpleNamespace(
                                    config={"block_bytes": 100}))
    assert chunk_geometry(run) == (3, 4, 25)
