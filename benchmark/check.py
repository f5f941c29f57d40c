"""The comparison that decides ``correct``.

After the window, the program's outputs (every channel's i16 samples, as it
wrote them) are held to the plain reference of :mod:`benchmark.reference`
over the input the window consumed, each channel at its own output rate
(its ``resample_to``, or the configuration's where it gives none):

- ``count_gap``: over every channel, how many outputs the program wrote
  beyond or short of those due at the channel's rate for the input it
  consumed (every output whose newest input arrived).  Exact: the limit
  is 0.
- ``rms_lsb``: the root mean square, in i16 steps, of the program's
  outputs less the reference's (float64, encoded as the binary encodes),
  over regions of consecutive outputs drawn from the seed: the first and
  the last region of each compared channel (the stream's start and its
  EOF chunk) and more at random, on the first, the middle, the last and
  more channels drawn from the seed.  The limit is the configuration's
  ``check.limits.rms_lsb``, set between the program's readings and the
  control's (bfloat16) ones, as ``PERF.md`` records.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.design import design_stages
from benchmark.reference.nco import counter_segments
from benchmark.reference.schedule import channel_ratios, expand_channels
from benchmark.reference.stream import due_count, encode_i16, region

__all__ = ["stages_of", "channel_rates", "channel_stages", "pick_regions",
           "check_outputs"]


def _design(config: dict, rate: float) -> list:
    return design_stages(config["samplerate"], float(rate),
                         config.get("resample_stages", "auto"),
                         config.get("atten_db", 70.0))


def stages_of(config: dict) -> list:
    """The configuration's resampler stages, worked out from its rates."""
    return _design(config, config["resample_to"])


def channel_rates(config: dict) -> list:
    """Each channel's output rate: the channel's ``resample_to`` (list
    form), else the configuration's.  A channel with neither is an error."""
    default = config.get("resample_to")
    rates = []
    for ch in expand_channels(config):
        rate = ch.get("resample_to", default)
        if rate is None:
            raise ValueError(f"channel {ch.get('name')!r} has no output rate: "
                             "the check holds resampled i16 outputs; give it "
                             "or the configuration a resample_to")
        rates.append(float(rate))
    return rates


def channel_stages(config: dict) -> list:
    """Each channel's resampler stages, designed once a rate: channels of
    one rate share one list."""
    rates = channel_rates(config)
    designs = {rate: _design(config, rate) for rate in set(rates)}
    return [designs[rate] for rate in rates]


def pick_regions(seed: int, due: list, check: dict) -> dict:
    """``{channel index: [(m_lo, m_hi), ...]}`` drawn from the seed, each
    channel's regions inside its first ``due[c]`` outputs."""
    n_channels = len(due)
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    want = min(n_channels, int(check.get("channels", n_channels)))
    base = sorted({0, n_channels // 2, n_channels - 1})[:want]
    rest = [c for c in range(n_channels) if c not in base]
    k = min(len(rest), want - len(base))
    extra = rng.choice(rest, size=k, replace=False).tolist() if k > 0 else []
    chans = sorted(set(base) | set(extra))
    out = {}
    for c in chans:
        size = min(int(check["region_outputs"]), due[c])
        starts = {0, due[c] - size}
        extra = max(0, int(check["regions"]) - 2)
        if due[c] > size and extra:
            starts |= set(rng.integers(0, due[c] - size, size=extra).tolist())
        out[c] = [(s, s + size) for s in sorted(starts) if size > 0]
    return out


def check_outputs(config: dict, capture: np.ndarray, n_in: int,
                  outputs: list, seed: int, device,
                  dtype=torch.float64) -> dict:
    """Hold ``outputs`` (per channel, ``(n, 2)`` i16 as written; or None to
    put the reference computed in ``dtype`` in the program's place) to the
    float64 reference over the first ``n_in`` input samples of the cyclic
    ``capture`` (``(N, 2)`` int16).  Returns the numbers compared, and the
    counts of outputs due and of outputs missing or extra."""
    dev = torch.device(device)
    rates = channel_rates(config)
    stages = channel_stages(config)
    channels = expand_channels(config)
    fs = int(config["samplerate"])
    block = int(config["block_bytes"]) // 4
    due = [due_count(n_in, st) for st in stages]
    written = [len(o) for o in outputs] if outputs is not None else due
    gap = int(sum(abs(w - d) for w, d in zip(written, due)))
    # regions lie inside what every channel of the rate group wrote
    room = {}
    for rate, d, w in zip(rates, due, written):
        room[rate] = min(room.get(rate, d), w)
    cap = torch.from_numpy(np.ascontiguousarray(capture)).to(dev)
    sumsq, count = 0.0, 0
    for c, regions in pick_regions(seed, [room[r] for r in rates],
                                   config["check"]).items():
        segs = counter_segments(
            channel_ratios(channels[c], n_in, fs, block), dev)
        for lo, hi in regions:
            want = encode_i16(*region(cap, segs, stages[c], lo, hi))
            if outputs is None:
                got = encode_i16(*region(cap, segs, stages[c], lo, hi, dtype))
            else:
                got = np.asarray(outputs[c][lo:hi], dtype=np.int64)
            d = (got - want).astype(np.float64)
            sumsq += float(np.sum(d * d))
            count += d.size
    rms = math.sqrt(sumsq / count) if count else float("inf")
    return {"numbers": {"count_gap": gap, "rms_lsb": rms},
            "attempted": sum(due), "failed": gap,
            "compared": count // 2}
