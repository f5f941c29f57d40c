"""Telemetry & logging — stderr-only, data-plane/telemetry-plane separation.

The reference logs via fern to **stderr** with format
``Y-m-dTH:M:S.mmm [LEVEL  module  line]  msg`` (main.rs:212-233) while the
corrected IQ stream goes to **stdout**; that strict separation is preserved:
nothing in this framework may ever print to stdout except IQ bytes.
"""

from __future__ import annotations

import logging
import sys
import time as _time

__all__ = ["setup_logger", "get_logger", "Counters"]

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

    Tracks samples and bytes moved plus wall time; ``rate()`` reports
    samples/s — the framework's primary per-chip metric (BASELINE.md).
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

    def rate(self) -> float:
        dt = self.elapsed()
        return self.samples / dt if dt > 0 else 0.0
