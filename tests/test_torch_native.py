"""The port's native host library against the JAX package's.

Both load a library built from ``native/src/*.cpp``: the JAX package the
tracked ``native/build/libdoppler_native.so``, the port its own build into
``doppler_tpu_torch/_build/``.  The codecs, the counter loop and the
reference NCO are integer or single-operation float code: bitwise.  The
SGP4 is double-precision transcendental code, so two builds may round a
libm call apart: within 1e-9 relative.  The float32 Doppler staircase the
pipeline runs is bitwise.  Skips where the machine has no ``g++``.
"""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from doppler_tpu import oracle as j_oracle
from doppler_tpu.ops import codec as j_codec
from doppler_tpu.orbit import Observer as JObserver
from doppler_tpu.orbit import Predictor as JPredictor
from doppler_tpu.orbit import Tle as JTle
from doppler_tpu.orbit import TrackScheduler as JTrackScheduler
from doppler_tpu.orbit.tle import _checksum
from doppler_tpu.runtime import native as j_native
from doppler_tpu_torch.ops import codec
from doppler_tpu_torch.orbit import Observer, Predictor, Tle, TrackScheduler
from doppler_tpu_torch.runtime import native
from doppler_tpu_torch.runtime.pipeline import stage_chunk

torch.set_num_threads(1)   # leave the other test workers their cores

REPO = Path(__file__).resolve().parents[1]
TRACKED = REPO / "native" / "build" / "libdoppler_native.so"
RNG = np.random.default_rng(0xC1)


def _fix(line):
    line = line.ljust(68)[:68]
    return line + str(_checksum(line))


TLE_L1 = _fix("1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8")
TLE_L2 = _fix("2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105")
GEO_L1 = _fix("1 11111U          80275.98708465  .00000000  00000-0  00000-0 0    8")
GEO_L2 = _fix("2 11111   0.0500  75.0000 0002000 120.0000 240.0000  1.00270000  105")
SITE = (58.26541, 26.46667, 76.0)
FREQ = 437505000.0
START_UNIX = float(int((2444514.48708465 - 2440587.5) * 86400.0 + 3600.0))


@pytest.fixture(scope="module", autouse=True)
def built():
    """The port's library (built here if need be), and the tracked JAX
    library unchanged by it."""
    if not native.available():
        pytest.skip("no g++ to build the native host library")
    if not j_native.available():
        pytest.skip("the JAX package's native library is not built")
    before = hashlib.sha256(TRACKED.read_bytes()).hexdigest()
    info = native.build_info()
    yield info
    assert hashlib.sha256(TRACKED.read_bytes()).hexdigest() == before


def test_library_lands_in_the_package_build_dir(built):
    path = Path(built["path"])
    assert path.exists() and path != TRACKED
    assert path.parent.parent == REPO / "doppler_tpu_torch" / "_build"
    assert path.parent.name.startswith("native-")


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCES", (bad,))
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    native.build_info.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*bad.cpp.*error"):
            native.build_info()
    finally:
        native.build_info.cache_clear()
    assert not list((tmp_path / "_build").rglob("*.so"))


def test_codecs_bitwise_jax():
    buf = RNG.integers(-32768, 32768, size=2 * 5001, dtype=np.int16).tobytes()
    for a, b in zip(native.i16_to_planar(buf), j_native.i16_to_planar(buf)):
        assert np.array_equal(a, b)
    x = np.concatenate([RNG.normal(scale=0.6, size=5000),
                        [1.5, -1.5, 1.0, -1.0, 0.0, np.nan, np.inf]]).astype(np.float32)
    assert np.array_equal(native.planar_to_i16(x, x[::-1]),
                          j_native.planar_to_i16(x, x[::-1]))
    pairs = RNG.normal(size=(777, 2)).astype("<f4")
    outs = []
    for lib in (native, j_native):
        i_out, q_out = np.full(1024, 7, "<f4"), np.full(1024, 7, "<f4")
        lib.f32_pairs_to_planar_into(pairs, i_out, q_out)
        outs.append((i_out, q_out))
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
    assert np.array_equal(outs[0][0][:777], pairs[:, 0])
    back = native.planar_to_f32_pairs(outs[0][0][:777], outs[0][1][:777])
    assert np.array_equal(back, j_native.planar_to_f32_pairs(pairs[:, 0], pairs[:, 1]))
    assert np.array_equal(back, pairs)


def test_f32_split_into_a_strided_buffer_takes_numpy():
    pairs = RNG.normal(size=(10, 2)).astype("<f4")
    dst = np.zeros((2, 20), "<f4")
    native.f32_pairs_to_planar_into(pairs, dst[0, ::2], dst[1, ::2])
    assert np.array_equal(dst[0, ::2], pairs[:, 0])
    with pytest.raises(ValueError):      # too short: NumPy's assignment raises
        native.f32_pairs_to_planar_into(pairs, np.zeros(5, "<f4"), np.zeros(5, "<f4"))
    with pytest.raises(ValueError, match="planes"):
        native.planar_to_f32_pairs(pairs[:, 0], pairs[:5, 1])


def test_reference_counter_blocks_bitwise_jax():
    shifts = RNG.uniform(-40000, 40000, size=400).astype(np.float32)
    counts = RNG.integers(1, 4096, size=400).astype(np.uint32)
    for sn, fs in [(0, 256000), (123456789, 1024000), ((1 << 32) - 5000, 48000)]:
        got = native.reference_counter_blocks(shifts, counts, sn, fs)
        want = j_native.reference_counter_blocks(shifts, counts, sn, fs)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]


def test_reference_mix_bitwise_jax_and_the_oracle():
    n = 30000   # crosses the 9660.609375/256000 rounding reset at 20802
    x = (0.3 * (RNG.normal(size=n) + 1j * RNG.normal(size=n))).astype(np.complex64)
    oi, oq, sn = native.reference_mix(x.real, x.imag, 0, 9660.609375, 256000)
    ji, jq, jsn = j_native.reference_mix(x.real, x.imag, 0, 9660.609375, 256000)
    assert sn == jsn
    assert np.array_equal(oi, ji) and np.array_equal(oq, jq)
    want, want_sn = j_oracle.shift_frequency_oracle(x, 0, 9660.609375, 256000)
    assert sn == want_sn
    assert j_oracle.snr_db(want, oi + 1j * oq) > 120.0


def test_native_sgp4_within_1e9_of_jax():
    tle_t, tle_j = (Tle.from_lines("TEST SAT", TLE_L1, TLE_L2),
                    JTle.from_lines("TEST SAT", TLE_L1, TLE_L2))
    cc, jc = native.NativeSGP4(tle_t), j_native.NativeSGP4(tle_j)
    ts = np.array([0.0, 47.3, 123.456, 359.9, 720.0, 1440.0 * 3])
    for a, b in zip(cc.propagate(ts), jc.propagate(ts)):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()
    times = START_UNIX + np.arange(0.0, 86400.0, 97.0)
    got = cc.doppler_curve(times, *SITE, FREQ)
    want = jc.doppler_curve(times, *SITE, FREQ)
    for a, b in zip(got, want):
        assert np.abs(a - b).max() <= 1e-9 * np.abs(b).max()


def test_predictor_auto_staircase_bitwise_jax():
    """``Predictor('auto')`` runs the C++ curve in both packages, and the
    float32 shifts the pipeline plans from are the same bits."""
    pt = Predictor(Tle.from_lines("TEST SAT", TLE_L1, TLE_L2), Observer(*SITE))
    pj = JPredictor(JTle.from_lines("TEST SAT", TLE_L1, TLE_L2), JObserver(*SITE))
    assert pt.native and pj._native is not None
    times = START_UNIX + np.arange(0.0, 3600.0, 0.5)
    dt, _ = pt.doppler_hz(times, FREQ)
    dj, _ = pj.doppler_hz(times, FREQ)
    assert np.abs(dt - dj).max() <= 1e-9 * np.abs(dj).max()
    st = TrackScheduler(pt, FREQ, 5000.0, 1024000, START_UNIX, telemetry=False)
    sj = JTrackScheduler(pj, FREQ, 5000.0, 1024000, START_UNIX, telemetry=False)
    for n in (50, 125, 3, 400):
        counts = [2048] * n
        assert np.array_equal(st.shifts(counts), sj.shifts(counts))


def test_predictor_native_and_numpy_agree():
    """The two SGP4s of the port, on the staircase: the same float32 shifts."""
    tle = Tle.from_lines("TEST SAT", TLE_L1, TLE_L2)
    a = TrackScheduler(Predictor(tle, Observer(*SITE), use_native=True), FREQ,
                       5000.0, 1024000, START_UNIX, telemetry=False)
    b = TrackScheduler(Predictor(tle, Observer(*SITE), use_native=False), FREQ,
                       5000.0, 1024000, START_UNIX, telemetry=False)
    counts = [2048] * 500
    assert np.array_equal(a.shifts(counts), b.shifts(counts))


def test_deep_space_takes_sdp4_in_both():
    """A GEO TLE: the C++ SGP4 refuses it (rc −3), ``'auto'`` runs the NumPy
    SDP4 in both packages — the same curve — and ``True`` raises."""
    pt = Predictor(Tle.from_lines("GEO", GEO_L1, GEO_L2), Observer(*SITE))
    pj = JPredictor(JTle.from_lines("GEO", GEO_L1, GEO_L2), JObserver(*SITE))
    assert not pt.native and pj._native is None and pt.sgp4.deep
    times = START_UNIX + np.arange(0.0, 7200.0, 60.0)
    assert np.array_equal(pt.doppler_hz(times, FREQ)[0], pj.doppler_hz(times, FREQ)[0])
    with pytest.raises(native.NativeInitError, match="deep-space") as e:
        Predictor(Tle.from_lines("GEO", GEO_L1, GEO_L2), Observer(*SITE),
                  use_native=True)
    assert e.value.rc == -3
    with pytest.raises(ValueError, match="use_native"):
        Predictor(Tle.from_lines("GEO", GEO_L1, GEO_L2), Observer(*SITE),
                  use_native="yes")


def test_stage_chunk_f32_split_is_the_numpy_one():
    """The pipeline's f32 staging through the C++ split: the planes NumPy's
    strided copy gives, zero past the data."""
    B, L = 4, 1024
    pairs = RNG.normal(size=(B * L - 100, 2)).astype("<f4")
    host = stage_chunk(pairs.tobytes(), "f32", B, L, torch.device("cpu")).numpy()
    planes = host.reshape(2, -1)
    assert np.array_equal(planes[0, :B * L - 100], pairs[:, 0])
    assert np.array_equal(planes[1, :B * L - 100], pairs[:, 1])
    assert not planes[:, B * L - 100:].any()


def test_codec_pair_helpers_equal_jax():
    pairs = RNG.normal(size=(3, 50, 2)).astype(np.float32)
    i, q = codec.f32_pairs_to_iq(torch.from_numpy(pairs))
    ji, jq = j_codec.f32_pairs_to_iq(pairs)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    back = codec.iq_to_f32_pairs(i, q)
    assert np.array_equal(back.numpy(), np.asarray(j_codec.iq_to_f32_pairs(ji, jq)))
    assert np.array_equal(back.numpy(), pairs)
