"""Telemetry & logging — stderr-only, data-plane/telemetry-plane separation.

The reference logs via fern to **stderr** with format
``Y-m-dTH:M:S.mmm [LEVEL  module  line]  msg`` (main.rs:212-233) while the
corrected IQ stream goes to **stdout**; that strict separation is preserved:
nothing in this framework may ever print to stdout except IQ bytes.
"""

from __future__ import annotations

import collections
import logging
import math
import sys
import time as _time

__all__ = ["setup_logger", "get_logger", "Counters", "Spans", "SPAN_NAMES",
           "start_spans", "last_spans"]

_LOGGER_NAME = "doppler_tpu_torch"


class _FernishFormatter(logging.Formatter):
    """``2015-05-13T14:28:48.123 [INFO   doppler_tpu_torch.cli  42]  msg``."""

    def format(self, record: logging.LogRecord) -> str:
        t = _time.localtime(record.created)
        ms = int(record.msecs)
        return (
            f"{_time.strftime('%Y-%m-%dT%H:%M:%S', t)}.{ms:03d} "
            f"[{record.levelname:<6} {record.name:<30} {record.lineno:>3}]  "
            f"{record.getMessage()}"
        )


class _JsonFormatter(logging.Formatter):
    """Structured telemetry: one JSON object per line (SURVEY §5 metrics)."""

    def format(self, record: logging.LogRecord) -> str:
        import json

        return json.dumps({
            "ts": round(record.created, 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "line": record.lineno,
            "msg": record.getMessage(),
        })


def setup_logger(level: int = logging.INFO, fmt: str = "fern") -> logging.Logger:
    """Install the stderr handler once and return the root framework logger.

    ``fmt``: ``"fern"`` (the reference's human format, main.rs:212-233) or
    ``"json"`` (one object per line for log pipelines).
    """
    logger = logging.getLogger(_LOGGER_NAME)
    formatter = _JsonFormatter() if fmt == "json" else _FernishFormatter()
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        logger.addHandler(handler)
        logger.propagate = False
    logger.handlers[0].setFormatter(formatter)
    logger.setLevel(level)
    return logger


def get_logger(name: str | None = None) -> logging.Logger:
    base = logging.getLogger(_LOGGER_NAME)
    return base.getChild(name) if name else base


class Counters:
    """Lightweight throughput counters for the profiling hooks (SURVEY §5).

    Tracks samples and bytes moved plus wall time since construction.
    """

    def __init__(self) -> None:
        self.samples = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.blocks = 0
        self._t0 = _time.perf_counter()

    def add(self, samples: int, bytes_in: int, bytes_out: int, blocks: int = 1) -> None:
        self.samples += samples
        self.bytes_in += bytes_in
        self.bytes_out += bytes_out
        self.blocks += blocks

    def elapsed(self) -> float:
        return _time.perf_counter() - self._t0


# what a run loop does with one chunk, in the order the loop's thread does it
SPAN_NAMES = ("read", "schedule", "plan", "stage", "launch", "wait", "cut",
              "write")
RING = 65536


class Spans:
    """Chunk-keyed spans of one ``run()`` on ``time.perf_counter``.

    A span is ``(name, chunk, t0, t1)``; ``chunk`` is the chunk's sequence
    number within the run, from 0, and every span of a chunk carries it.
    The run loops record :data:`SPAN_NAMES`, which follow each other on
    the loop's thread:

    - ``read``: the chunk's blocks from the input (with a prefetching
      reader, the take from its queue);
    - ``schedule``: the Doppler schedulers' shifts for the chunk's blocks;
    - ``plan``: the NCO plan words;
    - ``stage``: the input bytes (and, in channels mode, the plan words)
      into pinned host buffers;
    - ``launch``: the host→device copies, the kernels and the device→host
      copies enqueued;
    - ``wait``: the host blocked until the chunk's device→host copies are
      done (inside the next chunk's ``read`` once they are, else after
      the next chunk's launch);
    - ``cut``: the device's output into each channel's bytes;
    - ``write``: the bytes to the output stream or files.

    The newest ``capacity`` records are kept in a ring (the oldest are
    dropped first, so a long run holds constant memory); ``totals`` keeps
    each name's exact ``[count, seconds]`` over the whole run, and
    ``counters`` the run's counts (``chunks``; ``emits_early``, the chunks
    emitted during the next chunk's read, once one was; in channels mode
    ``chan_plans_periodic``, ``chan_plans_uniform`` and
    ``chan_plans_per_channel``, the channel-chunks planned by the two
    vectorised lanes and by one planner a channel, ``plans_uniform`` and
    ``plans_per_channel``, the chunks in which no channel, and at least
    one, was planned by its own planner, and with track channels
    ``track_evals``, ``track_steps`` and ``chan_plans_split``, the
    instants their schedulers propagated, the channel-chunks whose shift
    changes inside the chunk, and those of them that the lanes planned a
    segment at a time).
    """

    def __init__(self, capacity: int = RING) -> None:
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.totals: dict = {}
        self.counters: dict = {}

    def add(self, name: str, chunk, t0: float, t1: float) -> None:
        self.records.append((name, chunk, t0, t1))
        tot = self.totals.get(name)
        if tot is None:
            self.totals[name] = [1, t1 - t0]
        else:
            tot[0] += 1
            tot[1] += t1 - t0

    def bump(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def seconds(self, *names: str) -> float:
        """Total seconds of the spans of ``names``, over the whole run."""
        return sum(self.totals[n][1] for n in names if n in self.totals)

    def summary(self) -> str:
        """Each name's count, total seconds and 95th percentile (over the
        records the ring still holds), then the counters: the CLI's
        ``spans:`` line."""
        durations: dict = {}
        for name, _, t0, t1 in self.records:
            durations.setdefault(name, []).append(t1 - t0)
        names = [n for n in SPAN_NAMES if n in self.totals]
        names += sorted(n for n in self.totals if n not in SPAN_NAMES)
        parts = []
        for n in names:
            count, secs = self.totals[n]
            d = sorted(durations.get(n, ()))
            p95 = (f"{1e3 * d[max(0, math.ceil(0.95 * len(d)) - 1)]:.3f} ms"
                   if d else "n/a")
            parts.append(f"{n} {count} in {secs:.6f} s (p95 {p95})")
        counts = ", ".join(f"{k} {v}" for k, v in self.counters.items())
        return "; ".join(parts) + (f"; {counts}" if counts else "")


_last: Spans | None = None


def start_spans() -> Spans:
    """A fresh recorder for one ``run()``; :func:`last_spans` returns it
    until the next one starts."""
    global _last
    _last = Spans()
    return _last


def last_spans() -> Spans | None:
    """The recorder of the newest ``run()`` in this process (None before
    the first): how a caller of ``cli.main``, which returns only its exit
    code, reads the spans of the run it made."""
    return _last
