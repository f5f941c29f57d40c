"""The port's copied host layers equal the JAX package's originals.

``doppler_tpu_torch`` cannot import ``doppler_tpu`` (that runs
``import jax``), so it carries NumPy copies of the host layers.  Every
comparison here is exact: the copies must give the same integers, the same
float64/float32 bits and the same framing as the originals.
"""

import io
import logging

import numpy as np
import pytest

from doppler_tpu.ops import filters as j_filters
from doppler_tpu.ops import fixedpoint as j_fxp
from doppler_tpu.ops import phase_plan as j_plan
from doppler_tpu.ops.multistage import MultiStageResampler as JMultiStage
from doppler_tpu.ops.pallas import chain as j_chain
from doppler_tpu.ops.resample import RationalResampler as JRational
from doppler_tpu.parallel import sharded as j_sharded
from doppler_tpu.orbit import Observer as JObserver
from doppler_tpu.orbit import Predictor as JPredictor
from doppler_tpu.orbit import Tle as JTle
from doppler_tpu.orbit import TrackScheduler as JTrackScheduler
from doppler_tpu.runtime import stream as j_stream
from doppler_tpu.runtime import telemetry as j_tel
from doppler_tpu_torch.ops import filters, fixedpoint, phase_plan
from doppler_tpu_torch.ops.cuda import cascade
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.resample import RationalResampler
from doppler_tpu_torch.parallel import sharded
from doppler_tpu_torch.ops.nco import PLAN_FIELDS
from doppler_tpu_torch.orbit import Observer, Predictor, Tle, TrackScheduler
from doppler_tpu_torch.orbit.tle import _checksum
from doppler_tpu_torch.runtime import stream, telemetry


def _fix(line):
    line = line.ljust(68)[:68]
    return line + str(_checksum(line))


# the conformance harness's test TLE (tools/conformance.py:47-50)
TLE_L1 = _fix("1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8")
TLE_L2 = _fix("2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105")
START_UNIX = (2444514.48708465 - 2440587.5) * 86400.0 + 3600.0
SITE = (58.26541, 26.46667, 76.0)
FREQ = 437505000.0


def _plan_pair(shift_chunks, counts_chunks, fs, L):
    """Plan the same chunk sequence through both planners; return both
    (per-chunk word arrays, final state)."""
    s_t, s_j = phase_plan.NCOState(), j_plan.NCOState()
    out_t, out_j = [], []
    for shifts, counts in zip(shift_chunks, counts_chunks):
        pt = phase_plan.plan_blocks(shifts, counts, fs, s_t, L)
        pj = j_plan.plan_blocks(shifts, counts, fs, s_j, L)
        out_t.append(np.stack([getattr(pt, f) for f in PLAN_FIELDS]))
        out_j.append(np.stack([getattr(pj, f) for f in PLAN_FIELDS]))
    return out_t, out_j, s_t, s_j


@pytest.mark.parametrize("L", [2048, 131072])
@pytest.mark.parametrize("fs,shift", [
    (256000, -15000.0),          # dyadic ratio: exact resets only
    (1024000, 327843.76),        # rounding-reset-heavy ratio
    (1024000, 5000.0),
    (100000000, 3141592.0),      # huge exact period
])
def test_plan_blocks_const_bitwise(L, fs, shift):
    chunks = [[shift] * 5, [shift] * 7, [shift] * 3]
    counts = [[L] * 5, [L] * 7, [L] * 2 + [L // 3]]
    out_t, out_j, s_t, s_j = _plan_pair(chunks, counts, fs, L)
    for a, b in zip(out_t, out_j):
        assert a.dtype == np.uint32 and np.array_equal(a, b)
    assert (s_t.samplenum, s_t.abs_offset) == (s_j.samplenum, s_j.abs_offset)


@pytest.mark.parametrize("L", [2048, 131072])
def test_plan_blocks_track_bitwise(L):
    """A real TLE staircase (many distinct shifts, switching mid-chunk)."""
    fs = 1024000
    pred = Predictor(Tle.from_lines("TEST SAT", TLE_L1, TLE_L2), Observer(*SITE))
    sched = TrackScheduler(pred, FREQ, 5000.0, fs, START_UNIX, telemetry=False)
    shift_chunks, counts_chunks = [], []
    for n in ((40, 1500, 17) if L == 2048 else (40, 300, 17)):
        counts = [L] * n
        shift_chunks.append(list(sched.shifts(counts)))
        counts_chunks.append(counts)
    assert len(np.unique(np.concatenate(shift_chunks))) > 3
    out_t, out_j, s_t, s_j = _plan_pair(shift_chunks, counts_chunks, fs, L)
    for a, b in zip(out_t, out_j):
        assert np.array_equal(a, b)
    assert (s_t.samplenum, s_t.abs_offset) == (s_j.samplenum, s_j.abs_offset)


@pytest.mark.parametrize("fs,base,step", [
    (1024000, 9000.37, 173.3),            # the closed-form lane carries all
    (100000000, -2000000.37, 15625.7),    # config 5's rate, 256 channels
])
def test_plan_fields_uniform_bitwise_at_256_channels(fs, base, step):
    """The batched (C, B) planner the channels pipeline plans with: the
    copy's words and final states equal the original's over three chunks.
    Where the original refuses the lane (a None: its caller runs
    ``plan_blocks`` a channel) the copy refuses channel by channel, and
    every channel's words, from its lane or its ``plan_blocks``, are the
    original ``plan_blocks``'."""
    C, L = 256, 2048
    shifts = [float(np.float32(base + step * c)) for c in range(C)]
    st_t = [phase_plan.NCOState() for _ in range(C)]
    st_j = [j_plan.NCOState() for _ in range(C)]
    took_lane = 0
    for counts in ([L] * 4, [L] * 4, [L] * 3 + [L // 2]):
        a, refused = phase_plan.plan_fields_uniform(shifts, counts, fs,
                                                    st_t, L)
        b = j_plan.plan_fields_uniform(shifts, counts, fs, st_j, L)
        assert a.shape == (7, C, len(counts)) and a.dtype == np.uint32
        if b is None:
            for c in range(C):     # advance both as the pipeline would
                pj = j_plan.plan_blocks([shifts[c]] * len(counts), counts,
                                        fs, st_j[c], L)
                if c in refused:
                    pt = phase_plan.plan_blocks([shifts[c]] * len(counts),
                                                counts, fs, st_t[c], L)
                    a[:, c] = np.stack([getattr(pt, f) for f in PLAN_FIELDS])
                assert np.array_equal(
                    a[:, c], np.stack([getattr(pj, f) for f in PLAN_FIELDS]))
            continue
        took_lane += 1
        assert refused == [] and np.array_equal(a, b)
    assert took_lane >= 1
    assert [(s.samplenum, s.abs_offset) for s in st_t] == \
        [(s.samplenum, s.abs_offset) for s in st_j]


def test_plan_blocks_no_reset_quirk_bitwise():
    shifts = [1234.5, 1234.5, -777.0]
    a = phase_plan.plan_blocks(shifts, [2048] * 3, 256000,
                               phase_plan.NCOState(), 2048, reset_quirk=False)
    b = j_plan.plan_blocks(shifts, [2048] * 3, 256000,
                           j_plan.NCOState(), 2048, reset_quirk=False)
    for f in PLAN_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("P,Q", [(3, 64), (1, 2), (3, 8), (147, 160)])
def test_polyphase_bank_bitwise(P, Q):
    a = filters.design_polyphase_bank(P, Q)
    b = j_filters.design_polyphase_bank(P, Q)
    assert a.dtype == np.float32 and np.array_equal(a, b)


def test_fixedpoint_host_helpers_equal():
    rng = np.random.default_rng(7)
    for shift, fs in [(-15000.0, 256000), (5000.5, 1024000), (1e6 / 3, 48000)]:
        for q in (True, False):
            assert (fixedpoint.rate_to_q64(shift, fs, quantize_f32=q)
                    == j_fxp.rate_to_q64(shift, fs, quantize_f32=q))
    for v in rng.integers(0, 1 << 62, size=20):
        v = int(v) * 3
        assert fixedpoint.split_u64(v) == j_fxp.split_u64(v)
        assert fixedpoint.mul64_mod(v, v + 11) == j_fxp.mul64_mod(v, v + 11)


def test_tle_sgp4_doppler_staircase_equal():
    """The copied orbit stack gives the JAX package's NumPy staircase bit for
    bit (the JAX predictor pinned to its NumPy SGP4, which the copy is)."""
    fs = 256000
    pred_t = Predictor(Tle.from_lines("TEST SAT", TLE_L1, TLE_L2), Observer(*SITE),
                       use_native=False)
    pred_j = JPredictor(JTle.from_lines("TEST SAT", TLE_L1, TLE_L2),
                        JObserver(*SITE), use_native=False)
    times = START_UNIX + np.arange(0.0, 600.0, 7.0)
    dt, _ = pred_t.doppler_hz(times, FREQ)
    dj, _ = pred_j.doppler_hz(times, FREQ)
    assert np.array_equal(dt, dj)
    st = TrackScheduler(pred_t, FREQ, 5000.0, fs, START_UNIX, telemetry=False)
    sj = JTrackScheduler(pred_j, FREQ, 5000.0, fs, START_UNIX, telemetry=False)
    for n in (50, 125, 3):
        counts = [2048] * n
        assert np.array_equal(st.shifts(counts), sj.shifts(counts))
    assert (st.sample_count, st.dt) == (sj.sample_count, sj.dt)


@pytest.mark.parametrize("n_bytes", [0, 4, 8192 * 3, 8192 * 7 + 100])
def test_stream_framing_equal(n_bytes):
    data = bytes(np.random.default_rng(n_bytes).integers(0, 256, n_bytes,
                                                          dtype=np.uint8))
    rt = stream.BlockReader(io.BytesIO(data), 8192)
    rj = j_stream.BlockReader(io.BytesIO(data), 8192)
    while True:
        ct, cj = rt.read_chunk(3), rj.read_chunk(3)
        assert (ct.data, ct.block_sizes, ct.eof) == (cj.data, cj.block_sizes, cj.eof)
        if ct.eof:
            break
    for dtype in ("i16", "f32"):
        assert stream.bytes_per_sample(dtype) == j_stream.bytes_per_sample(dtype)


def test_telemetry_formats_equal():
    rec = logging.LogRecord("doppler.test", logging.INFO, __file__, 42,
                            "doppler@%.3f MHz : %.2f Hz", (437.505, -1234.5), None)
    assert (telemetry._FernishFormatter().format(rec)
            == j_tel._FernishFormatter().format(rec))
    assert (telemetry._JsonFormatter().format(rec)
            == j_tel._JsonFormatter().format(rec))
    c = telemetry.Counters()
    c.add(samples=10, bytes_in=40, bytes_out=40)
    assert (c.samples, c.bytes_in, c.bytes_out, c.blocks) == (10, 40, 40, 1)


@pytest.mark.parametrize("s_abs,n_loc,n_time,P,Q", [
    (0, 8192, 4, 3, 64),
    (123456789, 16384, 8, 24, 125),
    (7 * 2 ** 33 + 5, 4096, 2, 384, 3125),
    (2048 * 256 * 9, 2048 * 64, 4, 1, 1),
])
def test_sharded_host_helpers_equal(s_abs, n_loc, n_time, P, Q):
    """``parallel.sharded``'s alignment helpers are the JAX package's."""
    assert (sharded.shard_valid_out_counts(n_loc, n_time, P, Q)
            == j_sharded.shard_valid_out_counts(n_loc, n_time, P, Q))
    got, want = (m.shard_alignment(s_abs, n_loc, n_time, P, Q)
                 for m in (sharded, j_sharded))
    for g, w in zip(got, want):
        assert np.array_equal(g, w) and np.asarray(g).dtype == np.asarray(w).dtype
    # the window form through stream_step_alignment, on equal resamplers
    rs_t = RationalResampler(1024000, 48000)
    rs_j = JRational(1024000, 48000, impl="window")   # the port has no conv form
    got, want = (m.stream_step_alignment(rs, s_abs, n_loc, n_time)
                 for m, rs in ((sharded, rs_t), (j_sharded, rs_j)))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("fs", [1024000, 250000, 6250000, 100_000_000])
def test_cascade_replay_need_equal(fs):
    """The replay need of the fused front is the JAX package's; with the
    tail (``fused = k``) it is the seek's count, which
    ``tests/test_torch_distributed.py`` holds to the JAX seek's."""
    ms_t, ms_j = MultiStageResampler(fs, 48000), JMultiStage(fs, 48000)
    k = cascade.split_point(ms_t.stages)
    assert k == j_chain.split_point(ms_j.stages)
    assert (cascade.cascade_replay_need(ms_t.stages[:k], fs)
            == j_chain.cascade_replay_need(ms_j.stages[:k], fs))
    assert cascade.carry_rows(ms_t.T) == j_chain.carry_rows(ms_j.T)
    t = 1 + sum((st.T - 1) * (fs // st.in_rate) for st in ms_j.stages)
    cone = max((j_chain.carry_rows(st.T) * 128 if i < k else st.T - 1)
               * (fs // st.in_rate) for i, st in enumerate(ms_j.stages))
    assert cascade.cascade_replay_need(ms_t.stages, fs, k) == 2 * (t - 1) + cone
