"""The reference binary's NCO, stated plainly.

Per sample the binary mixes by ``exp(-2*pi*i * r*n)`` with ``r`` the
float32 ratio ``f32(f32(shift) / f32(fs))`` of the block's shift and ``n``
its ``samplenum`` counter (u32, starting at 0), which it steps as

    n = 1 if f32(r * f32(n)) is a whole number else n + 1

(``src/dsp.rs:117-134`` of cubehub/doppler).  This module follows that
counter exactly over a stream whose ratio changes only between *segments*
(a track schedule's whole-second staircase, or one segment for a constant
shift) and gives the mix phase ``frac(r * n)`` in exact integer arithmetic
(``r`` is a dyadic rational).  Within a segment the counter is known in
closed form once its first reset and the period after it are found, so a
segment costs one or two vectorized scans, not a loop over samples.

PyTorch only (any device); imports nothing of the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ratio_f32", "first_reset", "Segment", "counter_segments",
           "counter_values", "phase_cycles"]

_WINDOW = 1 << 20       # counter values tested in one vectorized pass


def ratio_f32(shift_hz: float, samplerate: int) -> np.float32:
    """``f32(f32(shift) / f32(fs))``, the ratio the binary mixes by."""
    return np.float32(np.float32(shift_hz) / np.float32(samplerate))


def _resets(r32: np.float32, n: torch.Tensor) -> torch.Tensor:
    """Does the counter reset after emitting value ``n`` (int64)?"""
    r = torch.tensor(float(r32), dtype=torch.float32, device=n.device)
    prod = r * n.to(torch.float32)          # one rounding, as the binary's
    return prod == torch.floor(prod)


def first_reset(r32: np.float32, n_from: int, count: int,
                device) -> int | None:
    """The least counter value in ``[n_from, n_from + count)`` at which the
    counter resets, or None."""
    lo, end = int(n_from), int(n_from) + int(count)
    while lo < end:
        hi = min(end, lo + _WINDOW)
        n = torch.arange(lo, hi, dtype=torch.int64, device=device)
        hit = torch.nonzero(_resets(r32, n))
        if hit.numel():
            return lo + int(hit[0, 0])
        lo = hi
    return None


@dataclass(frozen=True)
class Segment:
    """``length`` samples from absolute index ``start`` mixed at ratio
    ``r32``.  ``n0`` is the counter at the first sample; ``reset`` the
    value at which it first resets inside the segment (None: it does not);
    ``period`` the value at which it resets again after restarting at 1
    (None: not inside the segment)."""

    start: int
    length: int
    r32: np.float32
    n0: int
    reset: int | None
    period: int | None

    def next_counter(self) -> int:
        if self.reset is None:
            return self.n0 + self.length
        rest = self.length - (self.reset - self.n0 + 1)
        return (rest % self.period) + 1 if self.period else rest + 1


def counter_segments(ratios, device) -> list:
    """``ratios``: ``[(start, length, r32), ...]`` in stream order, from
    sample 0 on.  Returns the :class:`Segment` of each, the counter carried
    from one to the next, starting at 0."""
    out, n = [], 0
    for start, length, r32 in ratios:
        if n >= 1 << 32:
            raise ValueError("the u32 counter would wrap inside the stream")
        reset = first_reset(r32, n, length, device)
        period = None
        if reset is not None:
            rest = length - (reset - n + 1)
            period = first_reset(r32, 1, rest, device) if rest > 0 else None
        seg = Segment(int(start), int(length), r32, n, reset, period)
        out.append(seg)
        n = seg.next_counter()
    return out


def counter_values(seg: Segment, k: torch.Tensor) -> torch.Tensor:
    """The counter at absolute sample indices ``k`` (int64) of ``seg``."""
    j = k - seg.start
    if seg.reset is None:
        return seg.n0 + j
    first = seg.reset - seg.n0          # offset of the sample that resets
    j2 = j - (first + 1)
    after = (torch.remainder(j2, seg.period) + 1) if seg.period else j2 + 1
    return torch.where(j <= first, seg.n0 + j, after)


def phase_cycles(r32: np.float32, n: torch.Tensor) -> torch.Tensor:
    """``frac(r * n)`` exactly, as float64 cycles in [0, 1)."""
    mant, exp = math.frexp(float(r32))
    if mant == 0.0:
        return torch.zeros(n.shape, dtype=torch.float64, device=n.device)
    m_int, e = int(mant * (1 << 24)), exp - 24          # r = m_int * 2^e
    if e >= 0:
        return torch.zeros(n.shape, dtype=torch.float64, device=n.device)
    if -e >= 62:    # |m_int * n| < 2^56 <= 2^-e: the product is below 1
        return torch.remainder((m_int * n).to(torch.float64) * 2.0 ** e, 1.0)
    mod = 1 << (-e)
    return torch.remainder(m_int * n, mod).to(torch.float64) / float(mod)
