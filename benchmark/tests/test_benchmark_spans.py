"""The readers of the program's own spans, on a hand-built run: a traced
stretch with known device events and a recorder with known spans, each
metric against the number worked out by hand."""

from __future__ import annotations

import types

import pytest

from benchmark.cell import load_metric_reader
from benchmark.drive import Run
from benchmark.trace import Stretch
from benchmark.traffic import ReplaySource
from doppler_tpu_torch.runtime import telemetry

REPLAY = ("idle_in_plan_share.replay", "idle_in_stage_share.replay",
          "idle_in_output_share.replay", "device_wait_share.replay")
LIVE = ("pending_p95_ms.live", "frame_p95_ms.live")


def _recorder(monkeypatch, spans):
    rec = telemetry.Spans()
    for name, k, t0, t1 in spans:
        rec.add(name, k, t0, t1)
    monkeypatch.setattr(telemetry, "_last", rec)
    return rec


# the card busy over [12, 13] and [16, 16.5] of a stretch [10, 20]: idle
# over [10, 12], [13, 16] and [16.5, 20]
STRETCH = dict(t_start=10.0, t_end=20.0,
               events=[("cascade_kernel", 12.0, 13.0),
                       ("Memcpy DtoH", 16.0, 16.5)])
# two chunks' spans tiling the loop's thread from 9.5 on
SPANS = [("read", 0, 9.5, 10.5), ("schedule", 0, 10.5, 11.0),
         ("plan", 0, 11.0, 12.5), ("stage", 0, 12.5, 13.5),
         ("launch", 0, 13.5, 14.0),
         ("read", 1, 14.0, 14.2), ("schedule", 1, 14.2, 14.4),
         ("plan", 1, 14.4, 16.2), ("stage", 1, 16.2, 16.8),
         ("launch", 1, 16.8, 17.0),
         ("wait", 0, 17.0, 17.5), ("cut", 0, 17.5, 18.0),
         ("write", 0, 18.0, 19.0), ("read", 2, 19.0, 21.0)]
BY_HAND = {
    # idle in schedule/plan: [10.5, 11] + [11, 12] + [14.2, 14.4] + [14.4, 16]
    "idle_in_plan_share.replay": 100.0 * (0.5 + 1.0 + 0.2 + 1.6) / 10.0,
    # idle in stage: [13, 13.5] + [16.5, 16.8]
    "idle_in_stage_share.replay": 100.0 * (0.5 + 0.3) / 10.0,
    # idle in cut and write: [17.5, 19]
    "idle_in_output_share.replay": 100.0 * 1.5 / 10.0,
    # in wait: [17, 17.5]
    "device_wait_share.replay": 100.0 * 0.5 / 10.0,
}


def _replay_run(stretch=True):
    run = Run(cell=None, seed=0)
    run.source = ReplaySource(b"\0" * 64)
    run.stretch = Stretch(**STRETCH) if stretch else None
    return run


@pytest.mark.parametrize("name", REPLAY)
def test_a_replay_reader_gives_the_share_worked_out_by_hand(monkeypatch, name):
    _recorder(monkeypatch, SPANS)
    got = load_metric_reader(name)(_replay_run())
    assert got == pytest.approx(BY_HAND[name], abs=1e-9)


def test_the_spans_cover_every_idle_second_of_the_stretch(monkeypatch):
    from benchmark.spans import idle_in_share

    _recorder(monkeypatch, SPANS)
    run = _replay_run()
    every = idle_in_share(run, telemetry.SPAN_NAMES)
    # idle 2 + 3 + 3.5 s of 10 s, every second of it inside some span
    assert every == pytest.approx(85.0, abs=1e-9)
    assert load_metric_reader("device_idle_share.replay")(run) == (
        pytest.approx(every, abs=1e-9))


@pytest.mark.parametrize("name", REPLAY)
def test_a_replay_reader_needs_a_stretch_and_the_programs_spans(monkeypatch,
                                                                name):
    reader = load_metric_reader(name)
    _recorder(monkeypatch, SPANS)
    assert reader(_replay_run(stretch=False)) is None
    # a program that records no spans (no recorder, or none kept)
    monkeypatch.setattr(telemetry, "_last", None)
    assert reader(_replay_run()) is None
    monkeypatch.delattr(telemetry, "last_spans")
    assert reader(_replay_run()) is None


# 20 chunks of a live run: chunk k's read takes 60 + k ms and it waits
# 70 + k ms between its launch and its wait
LIVE_SPANS = []
for _k in range(20):
    _t = 1.0 * _k
    LIVE_SPANS += [("read", _k, _t, _t + 0.060 + 0.001 * _k),
                   ("launch", _k, _t + 0.2, _t + 0.25),
                   ("wait", _k, _t + 0.25 + 0.070 + 0.001 * _k, _t + 0.5)]
# numpy's 95th percentile of a + k ms, k = 0 … 19: a + 0.95 · 19 ms
LIVE_BY_HAND = {"frame_p95_ms.live": 60.0 + 18.05,
                "pending_p95_ms.live": 70.0 + 18.05}


def _live_run():
    run = Run(cell=None, seed=0)
    run.source = types.SimpleNamespace(due=lambda k: k)
    return run


@pytest.mark.parametrize("name", LIVE)
def test_a_live_reader_gives_the_p95_worked_out_by_hand(monkeypatch, name):
    _recorder(monkeypatch, LIVE_SPANS)
    got = load_metric_reader(name)(_live_run())
    assert got == pytest.approx(LIVE_BY_HAND[name], abs=1e-6)


@pytest.mark.parametrize("name", LIVE)
def test_a_live_reader_gives_none_for_a_closed_loop(monkeypatch, name):
    reader = load_metric_reader(name)
    _recorder(monkeypatch, LIVE_SPANS)
    assert reader(_replay_run()) is None
    monkeypatch.delattr(telemetry, "last_spans")
    assert reader(_live_run()) is None
