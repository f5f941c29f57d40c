"""Bit-faithful NumPy model of the reference ``doppler`` binary.

This module is the *golden model* for the framework's tests: a direct,
sequential, f32-arithmetic re-statement of the reference's observable
semantics, written against the behavior documented in SURVEY.md with
file:line citations into the reference's sources (cubehub/doppler 1.1.10).
A copy of ``doppler_tpu/oracle.py`` plus a vectorized :func:`resample_oracle`;
it imports NumPy only, so it runs where jax does not:

- i16 IQ decode: little-endian int16 pairs, scaled by 1/32768
  (``src/dsp.rs:85-99``).
- f32 IQ decode: little-endian bit reinterpretation (``src/dsp.rs:101-115``).
- NCO mix: per sample ``corrector = cexpf(i * (-2π * f32(f32(shift/fs) * n)))``
  with the ``samplenum``-reset-to-1 quirk when ``frac((shift/fs)*n) == 0``
  (``src/dsp.rs:117-134``, ``src/complex.c:33-39``).
- i16 IQ encode: ``(x * 32767.0) as i16`` — f32 multiply, then Rust's
  saturating float→int cast (truncate toward zero, clamp to i16 range,
  NaN → 0) (``src/main.rs:76-84``).
- f32 IQ encode: raw little-endian memory image (``src/main.rs:89-93``).

Everything here is host NumPy and intentionally *slow and obvious*; the
framework's device kernels are validated against it within the SNR bound.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "decode_i16_bytes",
    "decode_f32_bytes",
    "encode_i16_bytes",
    "encode_f32_bytes",
    "shift_frequency_oracle",
    "resample_oracle",
    "snr_db",
]


def decode_i16_bytes(buf: bytes | np.ndarray) -> np.ndarray:
    """LE interleaved i16 IQ bytes → complex64, scale 1/32768 (dsp.rs:85-99)."""
    raw = np.frombuffer(bytes(buf), dtype="<i2")
    assert raw.size % 2 == 0, "i16 IQ stream must contain whole IQ pairs"
    x = raw.astype(np.float32) / np.float32(32768.0)
    return (x[0::2] + 1j * x[1::2]).astype(np.complex64)


def decode_f32_bytes(buf: bytes | np.ndarray) -> np.ndarray:
    """LE interleaved f32 IQ bytes → complex64, bit reinterpret (dsp.rs:101-115)."""
    raw = np.frombuffer(bytes(buf), dtype="<f4")
    assert raw.size % 2 == 0, "f32 IQ stream must contain whole IQ pairs"
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


def _saturating_trunc_i16(v: np.ndarray) -> np.ndarray:
    """Rust `as i16` on f32: truncate toward zero, saturate, NaN→0 (main.rs:77-78)."""
    v = np.trunc(v)
    v = np.where(np.isnan(v), np.float32(0.0), v)
    v = np.clip(v, np.float32(-32768.0), np.float32(32767.0))
    return v.astype(np.int16)


def encode_i16_bytes(x: np.ndarray) -> bytes:
    """complex64 → LE interleaved i16 bytes, ×32767 then saturating trunc (main.rs:76-84)."""
    x = np.asarray(x, dtype=np.complex64)
    i = _saturating_trunc_i16(x.real * np.float32(32767.0))
    q = _saturating_trunc_i16(x.imag * np.float32(32767.0))
    out = np.empty(2 * x.size, dtype="<i2")
    out[0::2] = i
    out[1::2] = q
    return out.tobytes()


def encode_f32_bytes(x: np.ndarray) -> bytes:
    """complex64 → LE interleaved f32 bytes, raw memory image (main.rs:89-93)."""
    x = np.asarray(x, dtype=np.complex64)
    out = np.empty(2 * x.size, dtype="<f4")
    out[0::2] = x.real
    out[1::2] = x.imag
    return out.tobytes()


def shift_frequency_oracle(
    x: np.ndarray,
    samplenum: int,
    shift_hz: float,
    samplerate: int,
) -> tuple[np.ndarray, int]:
    """Sequential f32 mirror of ``dsp::shift_frequency`` (dsp.rs:117-134).

    Per sample (with ``n`` the mutable ``samplenum`` counter):

        ratio  = f32(shift_hz) / f32(samplerate)          # f32 divide
        inner  = f32(ratio * f32(n))                      # f32 product
        phase  = f32(f32(-2.0 * PI_f32) * inner)
        out    = sample * cexpf(i * phase)
        n      = 1 if frac_f32(ratio * f32(n)) == 0 else n + 1

    Returns ``(output complex64, final samplenum)``.  The reset-to-1 branch is
    the reference's f32-precision guard; SURVEY §3.4 verifies the emitted
    phase is a pure function of absolute sample index up to f32 rounding.
    """
    x = np.asarray(x, dtype=np.complex64)
    ratio = np.float32(shift_hz) / np.float32(samplerate)
    neg_two_pi = np.float32(-2.0) * np.float32(np.pi)  # f32 constant product

    out = np.empty_like(x)
    n = np.uint32(samplenum)
    for k in range(x.size):
        inner = np.float32(ratio * np.float32(n))
        phase = np.float32(neg_two_pi * inner)
        # cexpf(0 + i*phase) = cos(phase) + i*sin(phase) (complex.c:33-39)
        corr = np.complex64(complex(np.cos(phase), np.sin(phase)))
        out[k] = x[k] * corr
        frac = np.float32(ratio * np.float32(n)) % np.float32(1.0)
        if frac == np.float32(0.0):
            n = np.uint32(1)
        else:
            n = np.uint32(n + np.uint32(1))
    return out, int(n)


def resample_oracle(x: np.ndarray, P: int, Q: int, bank: np.ndarray,
                    slab: int = 4096) -> np.ndarray:
    """NumPy golden model: y[m] = Σ_l bank[(mQ)%P, l] · x[⌊mQ/P⌋ − l].

    The formula of ``doppler_tpu/ops/resample.py:342-363`` as a vectorized
    float64 dot (``slab`` outputs per gather).  Produces every output whose
    newest input exists; negative input indices read zeros, matching the
    streaming implementation's zero history.
    """
    x = np.asarray(x).astype(np.complex128)
    T = bank.shape[1]
    n_out = (len(x) * P + Q - 1) // Q  # m with floor(mQ/P) <= len(x)-1
    while n_out > 0 and (n_out - 1) * Q // P > len(x) - 1:
        n_out -= 1
    # zero history in front: xp[k + T − 1] = x[k]
    xp = np.concatenate([np.zeros(T - 1, dtype=np.complex128), x])
    taps = bank.astype(np.float64)
    l = np.arange(T)
    y = np.empty(n_out, dtype=np.complex128)
    for m_lo in range(0, n_out, slab):
        m = np.arange(m_lo, min(n_out, m_lo + slab), dtype=np.int64)
        n = (m * Q) // P
        p = (m * Q) % P
        win = xp[(n + T - 1)[:, None] - l[None, :]]      # x[n − l]
        y[m_lo:m_lo + m.size] = np.sum(win * taps[p], axis=1)
    return y


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-error ratio in dB between a reference and a test signal."""
    ref = np.asarray(ref, dtype=np.complex128)
    test = np.asarray(test, dtype=np.complex128)
    err = np.sum(np.abs(ref - test) ** 2)
    sig = np.sum(np.abs(ref) ** 2)
    if err == 0.0:
        return float("inf")
    if sig == 0.0:
        return float("-inf")
    return float(10.0 * np.log10(sig / err))
