"""IQ format codecs — device-side (torch) and host-side (NumPy staging).

Reproduces the reference's IQ wire formats exactly (SURVEY §2 #3-4):

- **i16**: little-endian interleaved int16 pairs; decode scales by 1/32768
  (reference ``src/dsp.rs:85-99``), encode multiplies by 32767 and applies
  Rust's saturating truncate-toward-zero float→i16 cast
  (``src/main.rs:76-84``).
- **f32**: little-endian interleaved float32 pairs, raw bit image
  (``src/dsp.rs:101-115``, ``src/main.rs:89-93``).

On the device IQ is **planar**: separate float32 tensors for I and Q.  An
i16 IQ pair is exactly one little-endian int32 word, so decode is a bitwise
unpack of an int32 tensor and encode is the inverse pack.  Every step is one
separately rounded float32 operation, so these functions give the same bits
on the CPU and on the card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "unpack_i16_words",
    "pack_i16_words",
    "i16_words_to_iq",
    "iq_to_i16_words",
    "encode",
    "f32_pairs_to_iq",
    "iq_to_f32_pairs",
    "saturating_trunc_i16",
    "bytes_to_i16_words",
    "i16_words_to_bytes",
    "bytes_to_f32_pairs",
    "f32_pairs_to_bytes",
]

_INV_32768 = float(np.float32(1.0 / 32768.0))  # exact power of two
_SCALE_OUT = 32767.0                            # exact in float32


def unpack_i16_words(words: torch.Tensor):
    """int32 words (one LE i16 IQ pair each) → the (i, q) components as
    int32 tensors in [−32768, 32767]."""
    words = words.to(torch.int32)
    lo = words & 0xFFFF
    i = torch.where(lo >= 0x8000, lo - 0x10000, lo)   # sign-extend low half
    q = words >> 16                                   # arithmetic shift
    return i, q


def pack_i16_words(iv: torch.Tensor, qv: torch.Tensor) -> torch.Tensor:
    """(i, q) integer components in [−32768, 32767] → int32 words.

    The pack runs in int64 so no signed shift can overflow; the final
    narrowing is the explicit two's-complement wrap of ``[0, 2^32)``.
    """
    word = (iv.to(torch.int64) & 0xFFFF) | ((qv.to(torch.int64) & 0xFFFF) << 16)
    word = torch.where(word >= (1 << 31), word - (1 << 32), word)
    return word.to(torch.int32)


def i16_words_to_iq(words: torch.Tensor):
    """int32 words (one LE i16 IQ pair each) → planar (i, q) float32.

    Decode contract of dsp.rs:85-99: int16 value / 32768.
    """
    i, q = unpack_i16_words(words)
    return (i.to(torch.float32) * _INV_32768,
            q.to(torch.float32) * _INV_32768)


def saturating_trunc_i16(v: torch.Tensor) -> torch.Tensor:
    """Rust `as i16` on f32: truncate toward zero, saturate, NaN→0 (main.rs:77-78)."""
    v = torch.trunc(v)
    v = torch.where(torch.isnan(v), torch.zeros_like(v), v)
    v = torch.clamp(v, -32768.0, 32767.0)
    return v.to(torch.int32)


def iq_to_i16_words(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Planar (i, q) float32 → int32 words of LE i16 pairs (main.rs:76-84)."""
    return pack_i16_words(saturating_trunc_i16(i * _SCALE_OUT),
                          saturating_trunc_i16(q * _SCALE_OUT))


def encode(i: torch.Tensor, q: torch.Tensor, outtype: str) -> torch.Tensor:
    """Planar (i, q) float32 → the device output layout of ``outtype``: the
    int32 words of i16 pairs, or the f32 planes stacked as ``(2, …)``."""
    if outtype == "i16":
        return iq_to_i16_words(i, q)
    return torch.stack([i, q])


def f32_pairs_to_iq(pairs: torch.Tensor):
    """(…, N, 2) float32 interleaved pairs → planar (i, q) views."""
    return pairs[..., 0], pairs[..., 1]


def iq_to_f32_pairs(i: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Planar (i, q) → (…, N, 2) float32 interleaved pairs."""
    return torch.stack([i, q], dim=-1)


# ---------------------------------------------------------------------------
# Host-side staging (NumPy; zero-copy views where possible) — the same
# helpers as doppler_tpu/ops/codec.py:86-102
# ---------------------------------------------------------------------------

def bytes_to_i16_words(buf: bytes | bytearray | memoryview) -> np.ndarray:
    """Raw LE i16 IQ bytes → int32 word vector (one word per IQ pair)."""
    n = len(buf) - len(buf) % 4
    return np.frombuffer(buf, dtype="<i4", count=n // 4)


def i16_words_to_bytes(words: np.ndarray) -> bytes:
    return np.ascontiguousarray(words, dtype="<i4").tobytes()


def bytes_to_f32_pairs(buf: bytes | bytearray | memoryview) -> np.ndarray:
    """Raw LE f32 IQ bytes → (N, 2) float32 array."""
    n = len(buf) - len(buf) % 8
    flat = np.frombuffer(buf, dtype="<f4", count=n // 4)
    return flat.reshape(-1, 2)


def f32_pairs_to_bytes(pairs: np.ndarray) -> bytes:
    return np.ascontiguousarray(pairs, dtype="<f4").tobytes()
