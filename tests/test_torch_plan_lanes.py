"""The channels planner's lanes (``ops/phase_plan.py``, ``runtime/channels.py``).

``plan_fields_periodic`` plans every channel whose f32 ratio has a short
exact period in one ``(C, B)`` pass; it must give, word for word and state
for state, what one ``plan_blocks`` a channel gives, and what the sequential
oracle ``_plan_blocks_sequential`` gives.  ``MultiChannelPipeline._plan_fields``
splits a chunk's channels between that lane, ``plan_fields_uniform`` and
``plan_blocks``, and a chunk in which shifts step into segments that the
lanes plan one after another; its words must equal the all-``plan_blocks``
result.  A lane refuses the channels that leave its regime, and only those
go to ``plan_blocks``.
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
        got, refused = planner(shifts, counts, fs, lane, L, **kw)
        assert refused == [] and got.dtype == np.uint32
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
    assert phase_plan.const_lane(shift, FS5, block_len=2048,
                                 reset_quirk=quirk) == lane


@pytest.mark.parametrize("counts", [[10, 14], [10, 15], [24], [2048, 23]])
def test_periodic_lane_at_the_chunks_first_reset(counts):
    """A seeked counter past q (1000, q = 256: the first reset at local 24)
    and chunks that end just before, at and after it."""
    fs, L, shifts = 1024000, 2048, [4000.0, -12000.0]
    lane = [phase_plan.NCOState(samplenum=1000, abs_offset=7)
            for _ in shifts]
    blocks, oracle = copy.deepcopy(lane), copy.deepcopy(lane)
    got, refused = phase_plan.plan_fields_periodic(shifts, counts, fs, lane,
                                                   L)
    assert refused == []
    want, _ = _per_channel(phase_plan.plan_blocks, shifts, counts, fs,
                           blocks, L)
    seq, _ = _per_channel(phase_plan._plan_blocks_sequential, shifts, counts,
                          fs, oracle, L)
    assert np.array_equal(got, want) and np.array_equal(got, seq)
    assert _snap(lane) == _snap(blocks) == _snap(oracle)


@pytest.mark.parametrize("why", ["large_samplenum", "long_block",
                                 "long_period"])
def test_periodic_lane_refuses_outside_its_regime(why):
    """The one channel out of the regime is refused alone: its words are
    zero and its state does not move, and the others are planned as
    ``plan_blocks`` plans them."""
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
    out = 1 if why == "large_samplenum" else 2     # the channel it leaves
    counts = [L] * 4
    before = _snap(states)
    blocks = copy.deepcopy(states)
    got, refused = phase_plan.plan_fields_periodic(shifts, counts, fs,
                                                   states, L)
    assert refused == [out] and not got[:, out].any()
    assert _snap(states)[out] == before[out]
    want, _ = _per_channel(phase_plan.plan_blocks, shifts, counts, fs,
                           blocks, L)
    keep = [c for c in range(3) if c != out]
    assert np.array_equal(got[:, keep], want[:, keep])
    assert [_snap(states)[c] for c in keep] == [_snap(blocks)[c]
                                                for c in keep]


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
    """A seeked state out of the periodic regime sends that channel alone
    to ``plan_blocks`` for the chunk; the rest of its lane stays in it,
    and the words do not change."""
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
    assert mp.spans.counters["chan_plans_per_channel"] == 64 + 1
    assert mp.spans.counters["chan_plans_periodic"] == 192 + 191
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
    pipeline's, every lane planned, and the lanes planned the track
    channel's stepping chunks a segment at a time."""
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
    # plan_blocks: the genesis chunk's long-period and track channels; the
    # two chunks that the staircase steps inside go to the lanes in two
    # segments each
    assert c["chan_plans_per_channel"] == 2 and c["plans_per_channel"] == 1
    assert c["track_steps"] == c["chan_plans_split"] == 2
    assert c["chan_plans_uniform"] == 2 * 24 - 2
    for make, got in zip(scheds, outs):
        pipe = Pipeline(fs, "i16", "i16", make(), chunk_blocks=B,
                        device="cpu")
        want = io.BytesIO()
        pipe.run(io.BytesIO(data), want)
        assert got.getvalue() == want.getvalue() and len(want.getvalue())


# -- stepping chunks ----------------------------------------------------------

FS4 = 1024000          # BASELINE config 4's rate


class _Stairs:
    """A shift that steps at the given stream blocks: ``levels[i]`` from
    block ``at[i - 1]`` on, the last level past its steps (a track
    channel's staircase, each step where a test puts it)."""

    last_evals = 0

    def __init__(self, at, levels):
        self.at = np.asarray(at, np.int64)
        self.levels = np.asarray(levels, np.float64)
        self.block = 0

    def shifts(self, counts):
        k = self.block + np.arange(len(counts))
        self.block += len(counts)
        i = np.searchsorted(self.at, k, side="right")
        return self.levels[np.minimum(i, len(self.levels) - 1)]


def _sat16_levels(n_levels, channels=16):
    """Each of config 4's 64 kHz slots with a Doppler offset a level, held
    in float32 as the pipeline composes it."""
    return [[float(np.float32(-480000.0 + 64000.0 * k + 8000.37
                              - 1873.3 * i - 97.1 * k))
             for i in range(n_levels)] for k in range(channels)]


def _stairs_run(at, levels_c, B, chunks, seeds=None):
    """Plan ``chunks`` (lists of block counts) through ``_plan_all`` for
    channels that step at the stream blocks ``at``: every word and state
    equals one ``plan_blocks`` a channel and the sequential oracle.
    ``seeds``: the channels' first samplenums (genesis without).  Returns
    the pipeline."""
    specs = [ChannelSpec(f"c{c}", _Stairs(at, lv))
             for c, lv in enumerate(levels_c)]
    mp = MultiChannelPipeline(FS4, "i16", "i16", specs, chunk_blocks=B,
                              device="cpu")
    for ch, m in zip(mp.channels, seeds or ()):
        ch.state.samplenum, ch.state.abs_offset = m, 977
    mirror = [_Stairs(at, lv) for lv in levels_c]
    blocks = [copy.deepcopy(ch.state) for ch in mp.channels]
    oracle = copy.deepcopy(blocks)
    L = mp.block_samples
    for k, counts in enumerate(chunks):
        got = mp._plan_all(counts, k)
        assert not got[:, :, len(counts):].any()
        for c, sch in enumerate(mirror):
            shifts = sch.shifts(counts)
            want = _words(phase_plan.plan_blocks(shifts, counts, FS4,
                                                 blocks[c], L))
            seq = _words(phase_plan._plan_blocks_sequential(
                shifts, counts, FS4, oracle[c], L))
            assert np.array_equal(got[:, c, :len(counts)], want), (k, c)
            assert np.array_equal(want, seq), (k, c)
        assert (_snap([ch.state for ch in mp.channels]) == _snap(blocks)
                == _snap(oracle))
    return mp


@pytest.mark.parametrize("where", [245, 1, 255])
def test_a_step_inside_the_chunk_plans_in_two_segments(where):
    """Config 4's 16 slots step at one block of chunks 1 and 2 (block 245,
    where the staircase of a recorded pass steps; the first block after
    the chunk's start; the last): the lanes plan both segments, and only
    the genesis chunk goes to ``plan_blocks``."""
    B, L = 256, 2048
    mp = _stairs_run([B + where, 2 * B + where], _sat16_levels(3), B,
                     [[L] * B] * 3)
    c = mp.spans.counters
    assert c["track_steps"] == c["chan_plans_split"] == 2 * 16
    assert c["chan_plans_per_channel"] == 16 and c["plans_per_channel"] == 1
    assert sum(c[f"chan_plans_{lane}"] for lane in
               ("periodic", "uniform", "per_channel")) == 3 * 16


def test_two_steps_in_one_chunk_plan_in_three_segments():
    """Chunks of 1024 blocks (2.05 s): two steps in chunk 1, one in chunk
    2 and the short last chunk, so the lanes carry each state through three
    segments, then two."""
    B, L = 1024, 2048
    at = [B + 300, B + 800, 2 * B + 100]
    chunks = [[L] * B, [L] * B, [L] * 500 + [L // 3]]
    mp = _stairs_run(at, _sat16_levels(4, channels=4), B, chunks)
    c = mp.spans.counters
    assert c["track_steps"] == c["chan_plans_split"] == 2 * 4
    assert c["chan_plans_per_channel"] == 4


def test_more_segments_than_the_bound_go_to_plan_blocks():
    """A shift that steps every 100 blocks cuts a chunk of 1024 into more
    segments than the lanes take: its varying channels go to
    ``plan_blocks`` whole, bit for bit as before."""
    from doppler_tpu_torch.runtime import channels as ch_mod

    B, L = 1024, 2048
    at = list(range(B + 100, 2 * B, 100))
    assert len(at) + 1 > ch_mod._MAX_SEGMENTS
    mp = _stairs_run(at, _sat16_levels(len(at) + 1, channels=2), B,
                     [[L] * B] * 2, seeds=[5, 6])
    c = mp.spans.counters
    assert c["track_steps"] == c["chan_plans_per_channel"] == 2
    assert c["chan_plans_split"] == 0


def test_off_trajectory_states_hunt_their_first_firing():
    """States above their ratio's r₁ (as a track channel's counter is just
    after its shift steps to a ratio that fires sooner): the uniform lane
    hunts each one's first firing, then plans the closed form, as
    ``plan_blocks`` and the oracle do; on the next chunk they are back on
    the post-reset trajectory."""
    L, B = 2048, 64
    shifts = [lv[0] for lv in _sat16_levels(1)]
    r1 = [phase_plan._steady_period(phase_plan._ratio_f32(s, FS4), L)
          for s in shifts]
    lane = [phase_plan.NCOState(samplenum=r + 1 + 37 * c, abs_offset=c)
            for c, r in enumerate(r1)]
    blocks, oracle = copy.deepcopy(lane), copy.deepcopy(lane)
    assert all(st.samplenum > r for st, r in zip(lane, r1))
    for counts in ([L] * B, [L] * B, [L] * 7 + [100]):
        got, refused = phase_plan.plan_fields_uniform(shifts, counts, FS4,
                                                      lane, L)
        assert refused == []
        want, _ = _per_channel(phase_plan.plan_blocks, shifts, counts, FS4,
                               blocks, L)
        seq, _ = _per_channel(phase_plan._plan_blocks_sequential, shifts,
                              counts, FS4, oracle, L)
        assert np.array_equal(got, want) and np.array_equal(got, seq)
        assert _snap(lane) == _snap(blocks) == _snap(oracle)
    assert all(st.samplenum <= r for st, r in zip(lane, r1))


@pytest.mark.parametrize("lane", ["periodic", "uniform"])
def test_one_refusing_channel_goes_to_plan_blocks_alone(lane):
    """One channel of a lane leaves its regime (periodic: a seeked counter
    past 2^24; uniform: a counter that wraps u32 inside the chunk, which
    stays a refusal): only it runs ``plan_blocks``, in that chunk alone."""
    B, L = 32, 2048
    if lane == "periodic":
        levels = [[FS4 / 256 * k] for k in (3, 5, 7, 9)]     # q = 256
        seeds = [7, 1 << 25, 9, 11]
    else:
        levels = [[lv[0]] for lv in _sat16_levels(1, channels=4)]
        seeds = [7, (1 << 32) - 5000, 9, 11]
    mp = _stairs_run([], levels, B, [[L] * B] * 3, seeds=seeds)
    c = mp.spans.counters
    assert c["chan_plans_per_channel"] == 1 and c["plans_per_channel"] == 1
    assert c[f"chan_plans_{lane}"] == 3 * 4 - 1


def test_a_channel_refused_after_its_step_plans_blocks_from_there(
        monkeypatch):
    """A channel whose ratio fires once in millions of samples climbs to a
    counter that the periodic ratio it steps to cannot hold in its regime:
    the lane plans the first segment, and ``plan_blocks`` the rest of the
    chunk from the carried state."""
    from doppler_tpu_torch.runtime import channels as ch_mod

    calls = []
    real = ch_mod.plan_blocks

    def spy(shifts, counts, *a, **k):
        calls.append(len(counts))
        return real(shifts, counts, *a, **k)

    monkeypatch.setattr(ch_mod, "plan_blocks", spy)
    B, L = 256, 2048
    tiny = float(np.float32(1.37))      # r₁ ≈ 5.2e6: the counter climbs
    levels = [[tiny, FS4 / 256 * 127], [tiny, tiny]]
    mp = _stairs_run([B + 245], levels, B, [[L] * B] * 3, seeds=[1, 1])
    assert calls == [B - 245]
    c = mp.spans.counters
    assert c["track_steps"] == 1 and c["chan_plans_split"] == 0
    assert c["chan_plans_per_channel"] == 1


# shifts whose f32 ratio at 1.024 Msps has the exact period q, and no full
# block of 2048 meets its exact-only bound
SHORT_PERIOD = {1 << 19: 4107.421875, 1 << 20: -479958.0}


@pytest.mark.parametrize("q", [1 << 19, 1 << 20])
def test_short_periods_out_of_regime_plan_in_the_uniform_lane(q):
    """A ratio with q = 2^19 or 2^20 whose exact-only bound (2^22 / q, 4 or
    8) no full block meets: ``plan_blocks`` plans it by its firings, and so
    does the uniform lane, bit for bit, constant or stepping to it; a short
    block whose counter stays under the bound is refused."""
    L, B = 2048, 64
    s = SHORT_PERIOD[q]
    _, r32, got_q, bound = phase_plan.rate_constants(s, FS4)
    assert got_q == q and abs(float(r32)) * (L + 1) >= bound
    assert phase_plan.const_lane(s, FS4, block_len=L) == "uniform"
    base = _sat16_levels(2, channels=3)
    levels = [[s], [base[1][0], s], [s, base[2][1]]]
    mp = _stairs_run([B + 40], levels, B, [[L] * B, [L] * B, [L] * 9])
    c = mp.spans.counters
    assert c["chan_plans_per_channel"] == 3          # genesis alone
    assert c["chan_plans_split"] == 2
    st = phase_plan.NCOState(samplenum=1, abs_offset=3)
    assert abs(float(r32)) * 4 < bound               # 3 samples from 1: fast
    f, refused = phase_plan.plan_fields_uniform([s], [3], FS4, [st], L)
    assert refused == [0] and not f.any()
    assert (st.samplenum, st.abs_offset) == (1, 3)
