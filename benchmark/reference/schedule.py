"""Each channel's shifts, worked out again from a configuration's own
parameters, as the ratio segments of :mod:`benchmark.reference.nco`.

- ``const``: one shift for the whole stream, ``f32(shift) + f32(center)``
  added in float32.
- ``track`` with a fixed start time: the binary's recorded-overpass
  staircase (``src/main.rs:156-183`` of cubehub/doppler).  Block k (of
  ``block_samples``) is corrected with the Doppler curve at
  ``start + dt_(k-1)``, where ``dt_j = trunc(f32(f32(j * block) / f32(fs)))``
  and ``dt_(-1) = 0`` (the binary's one-block lag); the shift is
  ``f32(doppler) + f32(offset)`` (+ ``f32(center)`` in channels mode).

NumPy for the schedule, :mod:`.orbit` for the curve; nothing of the program.
"""

from __future__ import annotations

import calendar
import time

import numpy as np

from benchmark.reference import orbit
from benchmark.reference.nco import ratio_f32

__all__ = ["parse_time_utc", "expand_channels", "channel_ratios"]


def parse_time_utc(text: str) -> float:
    """``%Y-%m-%dT%H:%M:%S`` UTC -> unix seconds."""
    return float(calendar.timegm(time.strptime(text, "%Y-%m-%dT%H:%M:%S")))


def expand_channels(config: dict) -> list:
    """The configuration's channels as a list: ``channels`` is a list of
    channel entries, or ``{"grid": {"count", "first_hz", "spacing_hz",
    "name"}}``, constant channels at ``first + k * spacing`` Hz."""
    chans = config["channels"]
    if isinstance(chans, list):
        return list(chans)
    g = chans["grid"]
    return [{"name": g["name"].format(k),
             "shift": g["first_hz"] + k * g["spacing_hz"]}
            for k in range(int(g["count"]))]


def _segments(shifts: np.ndarray, block_starts: np.ndarray, n_in: int,
              fs: int) -> list:
    """Runs of blocks with one float32 shift -> ``(start, length, r32)``."""
    out = []
    cut = np.flatnonzero(np.concatenate([[True], shifts[1:] != shifts[:-1]]))
    for i, b in enumerate(cut):
        start = int(block_starts[b])
        end = int(block_starts[cut[i + 1]]) if i + 1 < len(cut) else n_in
        out.append((start, end - start, ratio_f32(float(shifts[b]), fs)))
    return out


def channel_ratios(channel: dict, n_in: int, fs: int,
                   block_samples: int) -> list:
    """The ``(start, length, r32)`` segments of one channel over the first
    ``n_in`` input samples.  ``channel`` holds ``shift`` (const) or
    ``track`` (``tle``, ``location``, ``time``, ``frequency``, ``offset``),
    and optionally ``center_offset``."""
    center = np.float32(channel.get("center_offset", 0.0))
    if "shift" in channel:
        return [(0, n_in, ratio_f32(float(np.float32(channel["shift"])
                                          + center), fs))]
    tr = channel["track"]
    n_blocks = -(-n_in // block_samples)
    k = np.arange(n_blocks, dtype=np.int64)
    prev = np.maximum(k - 1, 0) * block_samples
    dt = (prev.astype(np.float32) / np.float32(fs)).astype(np.int64)
    dt[0] = 0
    uniq, inverse = np.unique(dt, return_inverse=True)
    loc = tr["location"]
    tle = orbit.Tle.from_lines(tr["name"], tr["tle"][0], tr["tle"][1])
    dop = orbit.doppler_hz(
        tle, orbit.Observer(loc["lat"], loc["lon"], loc["alt"]),
        parse_time_utc(tr["time"]) + uniq.astype(np.float64),
        tr["frequency"])
    shifts = ((dop.astype(np.float32) + np.float32(tr.get("offset", 0.0)))
              [inverse] + center).astype(np.float32)
    return _segments(shifts, k * block_samples, n_in, fs)
