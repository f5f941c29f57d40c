"""The channels planner's lanes (``ops/phase_plan.py``, ``runtime/channels.py``).

``plan_fields_periodic`` plans every channel whose f32 ratio has a short
exact period in one ``(C, B)`` pass; it must give, word for word and state
for state, what one ``plan_blocks`` a channel gives, and what the sequential
oracle ``_plan_blocks_sequential`` gives.  ``MultiChannelPipeline._plan_fields``
splits a chunk's channels between that lane, ``plan_fields_uniform`` and
``plan_blocks``; its words must equal the all-``plan_blocks`` result.
"""

from __future__ import annotations

import copy
import io

import numpy as np
import pytest
import torch

from doppler_tpu_torch.ops import phase_plan
from doppler_tpu_torch.ops.nco import PLAN_FIELDS
from doppler_tpu_torch.orbit import Observer, Predictor, Tle, TrackScheduler
from doppler_tpu_torch.orbit.tle import _checksum
from doppler_tpu_torch.runtime.channels import ChannelSpec, MultiChannelPipeline
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

FS5 = 100_000_000
# BASELINE config 5's grid: (k − 127.5) · 390625 Hz, as the pipeline holds it
GRID5 = [float(np.float32(-49804687.5 + 390625.0 * k)) for k in range(256)]


def _q(shift, fs):
    return phase_plan.rate_constants(shift, fs)[2]


def test_config5_grid_splits_192_periodic_and_64_long_periods():
    """q = 512 where the f32 ratio is the grid's own (2k − 255) / 512: the
    42 shifts f32 holds exactly (below 2^23 Hz) and 150 whose rounding the
    division takes back.  Where the rounding survives, q is 2^25 or 2^27."""
    qs = [_q(s, FS5) for s in GRID5]
    assert sum(q == 512 for q in qs) == 192
    assert sum(q == 1 << 25 for q in qs) == 42
    assert sum(q == 1 << 27 for q in qs) == 22
    for k, (s, q) in enumerate(zip(GRID5, qs)):
        r32 = float(phase_plan._ratio_f32(s, FS5))
        assert (q == 512) == (r32 == (2 * k - 255) / 512)
        if s == -49804687.5 + 390625.0 * k:
            assert q == 512 and abs(s) < (1 << 23)


def _words(plan):
    return np.stack([getattr(plan, f) for f in PLAN_FIELDS])


def _per_channel(planner, shifts, counts, fs, states, L, **kw):
    """(7, C, B) words and advanced states from one planner call a channel."""
    out = np.stack([
        _words(planner([s] * len(counts), counts, fs, st, L, **kw))
        for s, st in zip(shifts, states)], axis=1)
    return out, states


def _states(n, seeked, seed=3):
    if not seeked:
        return [phase_plan.NCOState() for _ in range(n)]
    rng = np.random.default_rng(seed)
    return [phase_plan.NCOState(samplenum=int(m), abs_offset=int(a))
            for m, a in zip(rng.integers(0, 3000, n),
                            rng.integers(0, 1 << 40, n))]


def _snap(states):
    return [(s.samplenum, s.abs_offset) for s in states]


CASES = {
    # config 5's q = 512 channels at its block and chunk
    "config5": (FS5, [s for s in GRID5 if _q(s, FS5) <= 1 << 20], 2048, 256),
    # 1.024 Msps, shifts k · fs / 256: q = 256 / gcd(k, 256)
    "1024k": (1024000, [1024000 / 256 * k for k in range(-127, 128, 9)],
              2048, 32),
}


def _three_chunks(planner, case, seeked, **kw):
    """Three chunks, the last short, from genesis or from seeked states:
    ``planner``'s words and states equal ``plan_blocks``' and the oracle's
    (with the increment from the f32 ratio, and from the exact rational)."""
    kw["quantize_f32"] = not case.endswith("exact-rate")
    fs, shifts, L, B = CASES[case.removesuffix("-exact-rate")]
    C = len(shifts)
    lane = _states(C, seeked)
    blocks = copy.deepcopy(lane)
    oracle = copy.deepcopy(lane)
    for counts in ([L] * B, [L] * B, [L] * (B // 2) + [L // 3]):
        got = planner(shifts, counts, fs, lane, L, **kw)
        assert got is not None and got.dtype == np.uint32
        assert got.shape == (7, C, len(counts))
        want, _ = _per_channel(phase_plan.plan_blocks, shifts, counts, fs,
                               blocks, L, **kw)
        seq, _ = _per_channel(phase_plan._plan_blocks_sequential, shifts,
                              counts, fs, oracle, L, **kw)
        assert np.array_equal(got, want)
        assert np.array_equal(got, seq)
        assert _snap(lane) == _snap(blocks) == _snap(oracle)


@pytest.mark.parametrize("seeked", [False, True])
@pytest.mark.parametrize("case", sorted(CASES) + ["config5-exact-rate"])
def test_periodic_lane_equals_plan_blocks_and_the_oracle(case, seeked):
    _three_chunks(phase_plan.plan_fields_periodic, case, seeked)


@pytest.mark.parametrize("seeked", [False, True])
@pytest.mark.parametrize("case", sorted(CASES) + ["config5-exact-rate"])
def test_uniform_lane_takes_short_periods_without_the_quirk(case, seeked):
    """Without the reset quirk the short periods plan in the uniform lane's
    absolute form, as ``plan_blocks`` plans them."""
    _three_chunks(phase_plan.plan_fields_uniform, case, seeked,
                  reset_quirk=False)


@pytest.mark.parametrize("shift, quirk, lane", [
    (GRID5[0], True, "periodic"),         # q = 512
    (GRID5[0], False, "uniform"),         # no quirk: the absolute form
    (GRID5[1], True, "uniform"),          # q = 2^25
    (1234.567, True, "uniform"),          # no exact period within reach
])
def test_const_lane_routes_by_the_ratio(shift, quirk, lane):
    assert phase_plan.const_lane(shift, FS5, reset_quirk=quirk) == lane


@pytest.mark.parametrize("counts", [[10, 14], [10, 15], [24], [2048, 23]])
def test_periodic_lane_at_the_chunks_first_reset(counts):
    """A seeked counter past q (1000, q = 256: the first reset at local 24)
    and chunks that end just before, at and after it."""
    fs, L, shifts = 1024000, 2048, [4000.0, -12000.0]
    lane = [phase_plan.NCOState(samplenum=1000, abs_offset=7)
            for _ in shifts]
    blocks, oracle = copy.deepcopy(lane), copy.deepcopy(lane)
    got = phase_plan.plan_fields_periodic(shifts, counts, fs, lane, L)
    want, _ = _per_channel(phase_plan.plan_blocks, shifts, counts, fs,
                           blocks, L)
    seq, _ = _per_channel(phase_plan._plan_blocks_sequential, shifts, counts,
                          fs, oracle, L)
    assert np.array_equal(got, want) and np.array_equal(got, seq)
    assert _snap(lane) == _snap(blocks) == _snap(oracle)


@pytest.mark.parametrize("why", ["large_samplenum", "long_block",
                                 "long_period"])
def test_periodic_lane_refuses_outside_its_regime(why):
    """One channel out of the regime refuses the whole call; no state
    moves.  ``plan_blocks`` still plans each channel."""
    fs, L = 1024000, 2048
    shifts = [4000.0 * k for k in (1, 3, 127)]     # q = 256, 256, 256
    states = [phase_plan.NCOState(samplenum=5 * k, abs_offset=k)
              for k in range(3)]
    if why == "large_samplenum":
        states[1].samplenum = 1 << 25              # counter past 2^24
    elif why == "long_block":
        L = 1 << 16                                # |r|·n past 2^22 / q
    else:
        shifts[2] = 1234.567                       # no short exact period
    counts = [L] * 4
    before = _snap(states)
    assert phase_plan.plan_fields_periodic(shifts, counts, fs, states,
                                           L) is None
    assert _snap(states) == before
    for s, st in zip(shifts, states):
        phase_plan.plan_blocks([s] * 4, counts, fs, st, L)


def test_the_lane_constants_are_cached():
    key = (GRID5[3], FS5, True)
    phase_plan._rate_cache.pop(key, None)
    first = phase_plan.rate_constants(GRID5[3], FS5)
    assert phase_plan.rate_constants(GRID5[3], FS5) is first
    d, r32, q, bound = first
    from doppler_tpu_torch.ops import fixedpoint
    assert d == fixedpoint.rate_to_q64(GRID5[3], FS5)
    assert r32 == phase_plan._ratio_f32(GRID5[3], FS5)
    assert q == 512 and bound == (1 << 22) / 512


def _grid_pipe(chunk_blocks=256, reset_quirk=True):
    specs = [ChannelSpec(f"ch{k:03d}",
                         ConstScheduler(-49804687.5 + 390625.0 * k))
             for k in range(256)]
    return MultiChannelPipeline(FS5, "i16", "i16", specs,
                                chunk_blocks=chunk_blocks,
                                reset_quirk=reset_quirk, device="cpu")


@pytest.mark.parametrize("reset_quirk", [True, False])
def test_config5_chunks_plan_by_lane_as_plan_blocks_does(reset_quirk):
    """Five chunks from genesis at config 5's size: the words and states
    equal one ``plan_blocks`` a channel; only the genesis chunk runs
    ``plan_blocks``, for the 64 long-period channels.  Without the quirk
    every channel plans in the uniform lane's absolute form, which needs
    no post-reset trajectory."""
    mp = _grid_pipe(reset_quirk=reset_quirk)
    L, B = mp.block_samples, mp.chunk_blocks
    states = [phase_plan.NCOState() for _ in GRID5]
    seen = []
    for k in range(5):
        counts = [L] * B if k < 4 else [L] * 100 + [L // 2]
        got = mp._plan_all(counts, k)
        want, _ = _per_channel(phase_plan.plan_blocks, GRID5, counts, FS5,
                               states, L, reset_quirk=reset_quirk)
        assert np.array_equal(got[:, :, :len(counts)], want)
        assert not got[:, :, len(counts):].any()
        assert _snap([ch.state for ch in mp.channels]) == _snap(states)
        seen.append(dict(mp.spans.counters))
    if reset_quirk:
        lanes = {"chan_plans_periodic": 192, "chan_plans_uniform": 64,
                 "chan_plans_per_channel": 64}
        chunks = {"plans_per_channel": 1, "plans_uniform": 4}
    else:
        lanes = {"chan_plans_periodic": 0, "chan_plans_uniform": 256,
                 "chan_plans_per_channel": 0}
        chunks = {"plans_uniform": 5}
    genesis = lanes["chan_plans_per_channel"]
    assert seen[0]["chan_plans_per_channel"] == genesis
    assert seen[0]["chan_plans_periodic"] == lanes["chan_plans_periodic"]
    assert seen[0]["chan_plans_uniform"] == (lanes["chan_plans_uniform"]
                                             - genesis)
    assert seen[-1] == {
        "chan_plans_periodic": 5 * lanes["chan_plans_periodic"],
        "chan_plans_uniform": 5 * lanes["chan_plans_uniform"] - genesis,
        "chan_plans_per_channel": genesis, **chunks}


def test_a_refused_lane_falls_back_to_plan_blocks():
    """A seeked state out of the periodic regime sends that lane's channels
    to ``plan_blocks`` for the chunk; the words do not change."""
    mp = _grid_pipe(chunk_blocks=8)
    L = mp.block_samples
    states = [phase_plan.NCOState() for _ in GRID5]
    for k in range(2):
        if k == 1:
            mp.channels[0].state.samplenum = states[0].samplenum = 1 << 25
        got = mp._plan_all([L] * 8, k)
        want, _ = _per_channel(phase_plan.plan_blocks, GRID5, [L] * 8, FS5,
                               states, L)
        assert np.array_equal(got, want)
    assert mp.spans.counters["chan_plans_per_channel"] == 64 + 192
    assert mp.spans.counters["plans_per_channel"] == 2


def _fix(line):
    line = line.ljust(68)[:68]
    return line + str(_checksum(line))


TLE_L1 = _fix("1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8")
TLE_L2 = _fix("2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105")
START_UNIX = (2444514.48708465 - 2440587.5) * 86400.0 + 3600.0


def _track(fs):
    pred = Predictor(Tle.from_lines("TEST SAT", TLE_L1, TLE_L2),
                     Observer(58.26541, 26.46667, 76.0))
    return TrackScheduler(pred, 437505000.0, 5000.0, fs, START_UNIX,
                          telemetry=False)


def test_a_channel_of_each_lane_is_its_single_stream_run():
    """A periodic, a long-period and a track channel (its staircase steps
    inside chunks) in one run: each channel's bytes are the single-stream
    pipeline's, and every lane planned."""
    fs, B = 256000, 16
    n = 3 * fs + 700                           # ≈ 3 s: the staircase steps
    rng = np.random.default_rng(7)
    data = rng.integers(-9000, 9000, 2 * n, dtype=np.int16).tobytes()
    scheds = [lambda: ConstScheduler(fs / 256 * 3),      # q = 256
              lambda: ConstScheduler(1234.567),          # q past 2^20
              lambda: _track(fs)]
    specs = [ChannelSpec(f"c{k}", make()) for k, make in enumerate(scheds)]
    mp = MultiChannelPipeline(fs, "i16", "i16", specs, chunk_blocks=B,
                              device="cpu")
    outs = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(data), outs)
    c = mp.spans.counters
    assert c["chunks"] == 24 and c["chan_plans_periodic"] == 24
    # plan_blocks: the genesis chunk's long-period and track channels, then
    # the track channel in the two chunks that its staircase steps inside
    assert c["chan_plans_per_channel"] == 4 and c["plans_per_channel"] == 3
    assert c["chan_plans_uniform"] == 2 * 24 - 4
    for make, got in zip(scheds, outs):
        pipe = Pipeline(fs, "i16", "i16", make(), chunk_blocks=B,
                        device="cpu")
        want = io.BytesIO()
        pipe.run(io.BytesIO(data), want)
        assert got.getvalue() == want.getvalue() and len(want.getvalue())
