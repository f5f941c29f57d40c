"""The live source's schedule and the latency arithmetic, on a fake clock."""

from __future__ import annotations

import types

import numpy as np
import pytest

from benchmark.readings import p95_ms, piece_times
from benchmark.traffic import LiveSource, ReplaySource, Sink, make_source


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t
        self.slept = []

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.slept.append(dt)
        self.t += dt


def _live(clock, seconds=1.0, rate=1024.0, piece=64):
    buf = bytes(range(256)) * 4          # 1 KiB, cycled
    return LiveSource(buf, rate_sps=rate, piece_bytes=piece,
                      bytes_per_sample=4, t0=clock(), deadline=clock() + seconds,
                      clock=clock, sleep=clock.sleep)


def test_live_source_waits_for_each_piece_and_never_slows():
    clock = FakeClock()
    src = _live(clock)              # 16 samples a piece: due every 1/64 s
    assert src.n_pieces == 64
    assert src.read(32) == bytes(range(32))     # half of piece 0
    assert clock.t == pytest.approx(100.0 + 1 / 64)
    assert np.isnan(src.taken[0])
    src.read(32)                                 # the rest: taken now
    assert src.taken[0] == pytest.approx(100.0 + 1 / 64)
    # a reader that falls behind gets every piece already due at once
    clock.t += 0.25
    data = src.read(10_000)
    assert len(data) == 64 * (int(0.25 * 64) + 1) - 64
    assert np.all(src.taken[1:17] == clock.t)
    assert src.late[1:17].max() == 0.0          # no sleep: nothing late


def test_live_source_ends_the_stream_at_the_deadline():
    clock = FakeClock()
    src = _live(clock, seconds=0.1)
    total = b""
    while True:
        piece = src.read(64)
        if not piece:
            break
        total += piece
    assert len(total) == 64 * src.n_pieces == 64 * 6
    assert clock.t <= 100.0 + 0.1


def test_replay_source_cycles_the_capture_until_the_deadline():
    clock = FakeClock()
    src = ReplaySource(b"abcdef", deadline=101.0, clock=clock)
    assert bytes(src.read(4)) == b"abcd"
    assert bytes(src.read(4)) == b"ef"           # the loop's seam
    assert bytes(src.read(4)) == b"abcd"
    clock.t = 101.0
    assert bytes(src.read(4)) == b""
    assert src.bytes == 10


def test_latency_is_due_to_the_write_of_the_output_covering_the_piece():
    clock = FakeClock(0.0)
    # 1.024 Msps, pieces of 4096 samples; the estcube cascade (3/64)
    src = make_source({"loop": "open", "piece_bytes": 16384}, b"\0" * 65536,
                      t0=0.0, seconds=0.02, bytes_per_sample=4,
                      samplerate=1024000)
    src._clock, src._sleep = clock, clock.sleep
    sink = Sink(4, clock=clock)
    # read everything as it falls due, then write all outputs at 0.1 s
    while src.read(8192):
        pass
    clock.t = 0.1
    sink.write(b"\0" * 4 * 960)      # the outputs due for 20480 inputs
    run = types.SimpleNamespace(
        source=src, sink=sink,
        cell=types.SimpleNamespace(config={
            "samplerate": 1024000, "resample_to": 48000,
            "resample_stages": "auto"}))
    due, taken, written = piece_times(run)
    assert len(due) == 5                     # 0.02 s / 4 ms
    np.testing.assert_allclose(taken, due)
    np.testing.assert_allclose(written, 0.1)
    assert p95_ms(written - due) == pytest.approx(
        1e3 * np.percentile(0.1 - due, 95))
    # piece k ends at sample 4096 (k + 1) - 1, covered by output
    # floor((4096 (k + 1) - 1) * 3 / 64): 191, 383, ...; with 192 written
    # only piece 0 has its time
    sink.writes[-1] = (0.1, 192)
    _, _, written = piece_times(run)
    assert np.isfinite(written[:1]).all() and np.isnan(written[1:]).all()
    sink.writes[-1] = (0.1, 191)
    assert np.isnan(piece_times(run)[2]).all()
