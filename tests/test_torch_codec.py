"""The port's torch codec against the JAX codec and the reference oracle.

Decode and encode are integer unpacks and single float32 roundings, so every
comparison is bitwise — including ±full-scale saturation, ±inf and NaN → 0.
"""

import numpy as np
import jax.numpy as jnp
import torch

from doppler_tpu import oracle as j_oracle
from doppler_tpu.ops import codec as j_codec
from doppler_tpu_torch import oracle
from doppler_tpu_torch.ops import codec

torch.set_num_threads(1)   # leave the other test workers their cores

RNG = np.random.default_rng(0xC0DE)


def _words(n):
    w = RNG.integers(-(1 << 31), 1 << 31, size=n, dtype=np.int64).astype(np.int32)
    # the corners: both halves at ±full scale and zero
    corners = np.array([0, -1, 0x7FFF7FFF, -0x80008000, 0x00008000,
                        0x7FFF8000, -0x7FFF8001], dtype=np.int64).astype(np.int32)
    return np.concatenate([w, corners])


def test_decode_bitwise_vs_jax_and_oracle():
    w = _words(50000)
    ti, tq = codec.i16_words_to_iq(torch.from_numpy(w))
    ji, jq = j_codec.i16_words_to_iq(jnp.asarray(w))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    ref = j_oracle.decode_i16_bytes(w.astype("<i4").tobytes())
    assert np.array_equal(ti.numpy(), ref.real) and np.array_equal(tq.numpy(), ref.imag)
    assert np.array_equal(oracle.decode_i16_bytes(w.astype("<i4").tobytes()), ref)


def test_encode_bitwise_with_saturation_and_nan():
    v = (RNG.standard_normal(40000) * 0.7).astype(np.float32)
    special = np.array([1.0, -1.0, 1.5, -1.5, 32767 / 32767, -32768 / 32767,
                        np.inf, -np.inf, np.nan, -0.0, 0.99999994, -1.0000001],
                       dtype=np.float32)
    i = np.concatenate([v, special])
    q = np.concatenate([v[::-1], special[::-1]])
    got = codec.iq_to_i16_words(torch.from_numpy(i), torch.from_numpy(q)).numpy()
    want = np.asarray(j_codec.iq_to_i16_words(jnp.asarray(i), jnp.asarray(q)))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    x = np.empty(i.size, dtype=np.complex64)   # (i + 1j·q would turn inf into NaN)
    x.real, x.imag = i, q
    ref = oracle.encode_i16_bytes(x)
    assert got.astype("<i4").tobytes() == ref
    assert ref == j_oracle.encode_i16_bytes(x)
    # saturation and NaN → 0 as the reference's `as i16` cast
    s = got.view(np.int16).reshape(-1, 2)[len(v):, 0]
    assert list(s[:4]) == [32767, -32767, 32767, -32768]
    assert s[6] == 32767 and s[7] == -32768 and s[8] == 0


def test_host_staging_helpers_equal():
    raw = RNG.integers(0, 256, size=8 * 1001 + 5, dtype=np.uint8).tobytes()
    assert np.array_equal(codec.bytes_to_i16_words(raw), j_codec.bytes_to_i16_words(raw))
    assert np.array_equal(codec.bytes_to_f32_pairs(raw), j_codec.bytes_to_f32_pairs(raw),
                          equal_nan=True)
    w = codec.bytes_to_i16_words(raw)
    assert codec.i16_words_to_bytes(w) == j_codec.i16_words_to_bytes(w)
    p = codec.bytes_to_f32_pairs(raw)
    assert codec.f32_pairs_to_bytes(p) == j_codec.f32_pairs_to_bytes(p)
