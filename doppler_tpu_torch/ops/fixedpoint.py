"""Host half of the exact 64-bit fixed-point phase arithmetic.

The reference NCO's emitted phase is a pure function of the absolute sample
index ``n`` (SURVEY §3.4; reference ``src/dsp.rs:117-134``):

    phase(n) = -2π · frac(r · n),   r = shift_hz / samplerate.

``frac(r)`` is an unsigned Q0.64 word ``D``; the device computes
``(n · D) mod 2^64`` exactly (``ops.nco.phase_q24`` and ``csrc/nco.cuh``).
This module holds the host-side helpers the planner uses — a copy of
``doppler_tpu/ops/fixedpoint.py:39-68`` with the logic unchanged.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

__all__ = ["rate_to_q64", "split_u64", "mul64_mod"]


def mul64_mod(n: int, d: int) -> int:
    """Host-side exact ``(n · d) mod 2^64`` (python ints)."""
    return (int(n) * int(d)) % (1 << 64)


def rate_to_q64(shift_hz, samplerate, *, quantize_f32: bool = True) -> int:
    """Host-side: frequency ratio → unsigned Q0.64 phase increment.

    ``quantize_f32=True`` (default) first rounds ``shift_hz/samplerate`` to
    f32, mirroring the reference's ``shift_hz / samplerate as f32`` divide
    (dsp.rs:121) so long streams do not drift relative to the reference
    binary.  With integer inputs and ``quantize_f32=False`` the increment is
    the exactly-rounded rational ``frac(shift/fs)·2^64``.
    """
    if quantize_f32:
        r = float(np.float32(np.float32(shift_hz) / np.float32(samplerate)))
        frac = Fraction(r) % 1  # f64/f32 values are exact rationals
    else:
        frac = (Fraction(shift_hz) / Fraction(samplerate)) % 1
    d = round(frac * (1 << 64))
    return int(d % (1 << 64))


def split_u64(v: int) -> tuple[np.uint32, np.uint32]:
    """Host-side: 64-bit int → (hi32, lo32) numpy uint32 scalars."""
    v = int(v) % (1 << 64)
    return np.uint32(v >> 32), np.uint32(v & 0xFFFFFFFF)
