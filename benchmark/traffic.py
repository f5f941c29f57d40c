"""The one traffic generator: a traffic file's parameters -> a source.

The program reads its input from the source through ``read(n)``, as it
reads a pipe; the source hands out the capture, cycled, with the stream's
time running on, and ends the stream (an empty read) once the measured
window is over.

- ``"loop": "closed"`` (a replayed recording): every read is served at
  once; the program sets the pace.
- ``"loop": "open"`` (a live receiver): the capture arrives in pieces of
  ``piece_bytes`` at the configuration's sample rate; piece k falls due
  when its last sample has arrived, ``t0 + (k + 1) * piece / rate``.  A read
  waits until the bytes it returns are due and never slows the schedule.
  The source keeps, for every piece, when it fell due, when the read that
  took its last byte returned, and how late the source woke for it.

:class:`Sink` takes the program's output in memory and keeps when each
write ended and how many samples had been written by then.
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["make_source", "ReplaySource", "LiveSource", "Sink"]


class _Spans:
    """``(start, end)`` host times of the source's or sink's calls, kept
    only while ``on`` (the traced stretch)."""

    def __init__(self):
        self.on = False
        self.spans: list = []

    def add(self, t0: float, t1: float) -> None:
        if self.on:
            self.spans.append((t0, t1))


class ReplaySource:
    """Closed loop: the capture ``buf``, cycled, until ``deadline`` (host
    seconds; None: until ``limit`` bytes).  A read returns a view of the
    capture, not a copy, so the source costs the window as little as it
    can."""

    def __init__(self, buf: bytes, *, deadline: float | None = None,
                 limit: int | None = None, clock=time.perf_counter,
                 on_read=None):
        self._buf = memoryview(buf)
        self._deadline = deadline
        self._limit = limit
        self._clock = clock
        self._on_read = on_read
        self.bytes = 0
        self.spans = _Spans()

    def read(self, n: int = -1) -> memoryview:
        t0 = self._clock()
        if self._on_read is not None:
            self._on_read(t0)
        if ((self._deadline is not None and t0 >= self._deadline)
                or (self._limit is not None and self.bytes >= self._limit)):
            return memoryview(b"")
        size = len(self._buf)
        off = self.bytes % size
        take = min(n if n and n > 0 else size, size - off)
        if self._limit is not None:
            take = min(take, self._limit - self.bytes)
        data = self._buf[off:off + take]
        self.bytes += take
        self.spans.add(t0, self._clock())
        return data


class LiveSource:
    """Open loop: pieces of ``piece_bytes`` at ``rate_sps`` from ``t0``;
    pieces falling due after ``deadline`` are not sent."""

    def __init__(self, buf: bytes, *, rate_sps: float, piece_bytes: int,
                 bytes_per_sample: int, t0: float, deadline: float,
                 clock=time.perf_counter, sleep=time.sleep, on_read=None):
        self._buf = buf
        self._piece = int(piece_bytes)
        self.bytes_per_piece = self._piece
        self._period = piece_bytes / bytes_per_sample / float(rate_sps)
        self.t0 = float(t0)
        self._clock = clock
        self._sleep = sleep
        self._on_read = on_read
        self.n_pieces = max(0, int((deadline - t0) / self._period))
        self.bytes = 0
        self.taken = np.full(self.n_pieces, np.nan)   # read that took it
        self.late = np.zeros(self.n_pieces)            # the source's own lag
        self.spans = _Spans()

    def due(self, k) -> np.ndarray:
        """When piece k falls due (its last sample has arrived)."""
        return self.t0 + (np.asarray(k, dtype=np.float64) + 1) * self._period

    def read(self, n: int = -1) -> bytes:
        t_call = self._clock()
        if self._on_read is not None:
            self._on_read(t_call)
        k = self.bytes // self._piece
        if k >= self.n_pieces:
            return b""
        due = float(self.due(k))
        now = t_call
        if now < due:
            self._sleep(due - now)
            now = self._clock()
            self.late[k] = max(0.0, now - due)
        # every piece already due may go out in this read
        n_due = max(k + 1, min(self.n_pieces,
                               int((now - self.t0) / self._period)))
        end = n_due * self._piece
        if n is not None and n > 0:
            end = min(end, self.bytes + n)
        size = len(self._buf)
        out = bytearray()
        pos = self.bytes
        while pos < end:
            off = pos % size
            take = min(end - pos, size - off)
            out += self._buf[off:off + take]
            pos += take
        t1 = self._clock()
        for j in range(k, end // self._piece):
            self.taken[j] = t1
        self.bytes = end
        self.spans.add(t_call, t1)
        return bytes(out)


class Sink:
    """The program's output stream, in memory."""

    def __init__(self, bytes_per_sample: int, clock=time.perf_counter,
                 keep: bool = True):
        self._bps = bytes_per_sample
        self._clock = clock
        self._keep = keep
        self.data = bytearray()
        self.n = 0
        self.writes: list = []            # (end time, samples written so far)
        self.spans = _Spans()

    def write(self, b) -> int:
        t0 = self._clock()
        if self._keep:
            self.data += b
        self.n += len(b)
        t1 = self._clock()
        self.writes.append((t1, self.n // self._bps))
        self.spans.add(t0, t1)
        return len(b)

    def flush(self) -> None:
        pass


def make_source(traffic: dict, buf: bytes, *, t0: float, seconds: float,
                bytes_per_sample: int, samplerate: int, on_read=None):
    """The source a traffic file describes, for a window of ``seconds``
    from host time ``t0``."""
    deadline = t0 + seconds
    if traffic["loop"] == "closed":
        return ReplaySource(buf, deadline=deadline, on_read=on_read)
    if traffic["loop"] == "open":
        return LiveSource(buf, rate_sps=samplerate,
                          piece_bytes=traffic["piece_bytes"],
                          bytes_per_sample=bytes_per_sample, t0=t0,
                          deadline=deadline, on_read=on_read)
    raise ValueError(f"unknown traffic loop {traffic['loop']!r}")
