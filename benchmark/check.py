"""The comparison that decides ``correct``.

After the window, the program's outputs (every channel's i16 samples, as it
wrote them) are held to the plain reference of :mod:`benchmark.reference`
over the input the window consumed:

- ``count_gap``: over every channel, how many outputs the program wrote
  beyond or short of those due for the input it consumed (every output
  whose newest input arrived).  Exact: the limit is 0.
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

__all__ = ["stages_of", "pick_regions", "check_outputs"]


def stages_of(config: dict) -> list:
    """The configuration's resampler stages, worked out from its rates."""
    return design_stages(config["samplerate"], float(config["resample_to"]),
                         config.get("resample_stages", "auto"),
                         config.get("atten_db", 70.0))


def pick_regions(seed: int, n_channels: int, due: int, check: dict) -> dict:
    """``{channel index: [(m_lo, m_hi), ...]}`` drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x5EED])
    want = min(n_channels, int(check.get("channels", n_channels)))
    base = sorted({0, n_channels // 2, n_channels - 1})[:want]
    rest = [c for c in range(n_channels) if c not in base]
    k = min(len(rest), want - len(base))
    extra = rng.choice(rest, size=k, replace=False).tolist() if k > 0 else []
    chans = sorted(set(base) | set(extra))
    size = min(int(check["region_outputs"]), due)
    out = {}
    for c in chans:
        starts = {0, due - size}
        extra = max(0, int(check["regions"]) - 2)
        if due > size and extra:
            starts |= set(rng.integers(0, due - size, size=extra).tolist())
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
    stages = stages_of(config)
    channels = expand_channels(config)
    fs = int(config["samplerate"])
    block = int(config["block_bytes"]) // 4
    due = due_count(n_in, stages)
    written = ([len(o) for o in outputs] if outputs is not None
               else [due] * len(channels))
    gap = int(sum(abs(w - due) for w in written))
    cap = torch.from_numpy(np.ascontiguousarray(capture)).to(dev)
    sumsq, count = 0.0, 0
    for c, regions in pick_regions(seed, len(channels), min(due, *written),
                                   config["check"]).items():
        segs = counter_segments(
            channel_ratios(channels[c], n_in, fs, block), dev)
        for lo, hi in regions:
            want = encode_i16(*region(cap, segs, stages, lo, hi))
            if outputs is None:
                got = encode_i16(*region(cap, segs, stages, lo, hi, dtype))
            else:
                got = np.asarray(outputs[c][lo:hi], dtype=np.int64)
            d = (got - want).astype(np.float64)
            sumsq += float(np.sum(d * d))
            count += d.size
    rms = math.sqrt(sumsq / count) if count else float("inf")
    return {"numbers": {"count_gap": gap, "rms_lsb": rms},
            "attempted": due * len(channels), "failed": gap,
            "compared": count // 2}
