"""The resampler's stages and filter banks, worked out again from a cell's
rates: a frozen copy of the port's design rules (``ops/filters.py`` and the
stage plan of ``ops/multistage.py``), NumPy only, importing nothing of the
program.  A Kaiser windowed-sinc prototype (float64 design, float32 bank,
as the program states its taps), factored into a ``(P, T)`` polyphase bank
with ``y[m] = sum_l bank[(m*Q) % P, l] * x[(m*Q) // P - l]``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction

import numpy as np

__all__ = ["Stage", "design_stages", "design_polyphase_bank"]


def kaiser_beta(atten_db: float) -> float:
    """Kaiser's empirical β for a target stopband attenuation (dB)."""
    a = float(atten_db)
    if a > 50.0:
        return 0.1102 * (a - 8.7)
    if a >= 21.0:
        return 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    return 0.0


def _i0(x: np.ndarray) -> np.ndarray:
    """Modified Bessel function of the first kind, order 0 (series form)."""
    x = np.asarray(x, dtype=np.float64)
    result = np.ones_like(x)
    term = np.ones_like(x)
    half_x_sq = (x / 2.0) ** 2
    for k in range(1, 30):
        term = term * half_x_sq / (k * k)
        result = result + term
    return result


def kaiser_window(n_taps: int, beta: float) -> np.ndarray:
    m = n_taps - 1
    k = np.arange(n_taps, dtype=np.float64)
    arg = beta * np.sqrt(np.clip(1.0 - (2.0 * k / m - 1.0) ** 2, 0.0, None))
    return _i0(arg) / _i0(np.array(beta))


def design_lowpass(n_taps: int, cutoff: float, beta: float) -> np.ndarray:
    """Windowed-sinc lowpass, ``cutoff`` in cycles/sample (0 < fc ≤ 0.5).

    Unit DC gain; linear phase with group delay (n_taps−1)/2 samples.
    """
    if not 0.0 < cutoff <= 0.5:
        raise ValueError(f"cutoff {cutoff} out of (0, 0.5]")
    m = (n_taps - 1) / 2.0
    k = np.arange(n_taps, dtype=np.float64) - m
    h = 2.0 * cutoff * np.sinc(2.0 * cutoff * k)
    h = h * kaiser_window(n_taps, beta)
    return h / np.sum(h)


def polyphase_taps_needed(P: int, Q: int, atten_db: float) -> int:
    """Taps-per-phase for a single-stage P/Q prototype.

    Kaiser length estimate N ≈ (A − 7.95)/(2.285·Δω) with the transition
    band tb = fc/2 centered on the target Nyquist fc = 0.5/max(P,Q) (flat
    passband to 0.75·Nyquist-out, −6 dB at Nyquist-out, full attenuation at
    1.25·Nyquist-out).  The cost scales with max(P,Q): sharp large-factor
    decimation genuinely needs a long filter in one stage (liquid-dsp's
    msresamp goes multi-stage instead; a halfband cascade is a planned
    optimization — the contract here is the frequency response).
    """
    tb = 0.25 / max(P, Q)                 # transition band, cycles/sample
    n = (max(atten_db, 21.0) - 7.95) / (2.285 * 2.0 * math.pi * tb)
    return max(8, int(math.ceil(n / P)) + 1)


def design_polyphase_bank(
    P: int,
    Q: int,
    taps_per_phase: int | None = None,
    atten_db: float = 70.0,
) -> np.ndarray:
    """Polyphase bank for rational P/Q resampling.

    The prototype runs at the upsampled rate ``fs·P`` with cutoff
    ``0.5·min(1/P, 1/Q)`` (anti-image for interpolation, anti-alias for
    decimation) and is scaled by P to preserve amplitude through
    zero-stuffing.  Returns shape ``(P, taps_per_phase)`` float32 where
    ``bank[p, l] = P · h[p + l·P]`` — output m of the resampler is

        y[m] = Σ_l bank[(m·Q) mod P, l] · x[⌊m·Q/P⌋ − l].

    ``taps_per_phase=None`` auto-sizes for ``atten_db`` via
    :func:`polyphase_taps_needed`.
    """
    if P < 1 or Q < 1:
        raise ValueError("P and Q must be ≥ 1")
    if math.gcd(P, Q) != 1:
        raise ValueError("P/Q must be in lowest terms")
    if taps_per_phase is None:
        taps_per_phase = polyphase_taps_needed(P, Q, atten_db)
    n_taps = taps_per_phase * P
    cutoff = 0.5 / max(P, Q)
    beta = kaiser_beta(atten_db)
    h = design_lowpass(n_taps, cutoff, beta) * P
    return h.reshape(taps_per_phase, P).T.astype(np.float32).copy()


def stage_taps_needed(stage_rate: float, q: int, pass_hz: float,
                      atten_db: float) -> int:
    """Kaiser length of a decimate-by-q stage that protects ``pass_hz``
    (odd, at least 7)."""
    dv = (stage_rate / q - 2.0 * pass_hz) / stage_rate
    if dv <= 0.0:
        raise ValueError(f"passband too wide for a /{q} stage")
    n = (max(atten_db, 21.0) - 7.95) / (2.285 * 2.0 * math.pi * dv)
    n = max(7, int(math.ceil(n)))
    return n + 1 if n % 2 == 0 else n


@dataclass(frozen=True)
class Stage:
    """One resampler stage: ``P/Q`` and its ``(P, T)`` float32 bank."""

    P: int
    Q: int
    bank: np.ndarray

    @property
    def T(self) -> int:
        return int(self.bank.shape[1])


def _rational(in_rate: int, out_rate: float, max_denominator: int) -> tuple:
    if float(out_rate).is_integer():
        g = math.gcd(int(in_rate), int(out_rate))
        return int(out_rate) // g, int(in_rate) // g
    frac = Fraction(float(out_rate) / float(in_rate)).limit_denominator(
        max_denominator)
    return frac.numerator, frac.denominator


def _single(in_rate: int, out_rate: float, atten_db: float,
            taps_per_phase=None, max_denominator: int = 1 << 16) -> Stage:
    P, Q = _rational(in_rate, out_rate, max_denominator)
    return Stage(P, Q, design_polyphase_bank(P, Q, taps_per_phase, atten_db))


def design_stages(in_rate: int, out_rate: float, stages: str = "auto",
                  atten_db: float = 70.0) -> list:
    """The stage list for ``in_rate -> out_rate``: one rational stage
    (``single``), or greedy decimate-by-16/8/4/2 stages, each designed
    10*log10(q) dB deeper and at most 129 taps, then a rational tail
    (``multi``, and ``auto`` when decimating by 4 or more)."""
    heavy = float(out_rate) * 4.0 <= float(in_rate)
    if not (stages == "multi" or (stages == "auto" and heavy)):
        return [_single(in_rate, out_rate, atten_db)]
    pass_hz = 0.5 * float(out_rate)
    out: list = []
    rate = float(in_rate)
    while rate / 2.0 >= 2.0 * out_rate and float(rate / 2.0).is_integer():
        for q in (16, 8, 4, 2):
            if rate / q < 2.0 * out_rate or not float(rate / q).is_integer():
                continue
            atten_s = atten_db + 10.0 * math.log10(q)
            try:
                taps = stage_taps_needed(rate, q, pass_hz, atten_s)
            except ValueError:
                continue
            if taps > 129:
                continue
            break
        else:
            break
        out.append(_single(int(rate), rate / q, atten_s, taps_per_phase=taps))
        rate = rate / q
    fin_ratio = max(1.0, rate / float(out_rate))
    out.append(_single(int(rate), out_rate,
                       atten_db + 10.0 * math.log10(fin_ratio)))
    return out
