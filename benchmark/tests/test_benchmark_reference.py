"""The plain reference against a direct, sample-by-sample NumPy statement of
the same semantics, at a tiny size."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark.cell import HERE
from benchmark.reference.design import Stage, design_stages
from benchmark.reference.nco import counter_segments, ratio_f32
from benchmark.reference.schedule import channel_ratios
from benchmark.reference.stream import (
    due_count,
    encode_i16,
    region,
)


def _sequential_counter(ratios, n_total: int) -> np.ndarray:
    """The binary's counter, one sample at a time."""
    r_of = np.empty(n_total, dtype=np.float32)
    for start, length, r32 in ratios:
        r_of[start:start + length] = r32
    out = np.empty(n_total, dtype=np.int64)
    n = 0
    for k in range(n_total):
        out[k] = n
        prod = np.float32(r_of[k] * np.float32(n))
        n = 1 if prod == np.floor(prod) else n + 1
    return out, r_of


def _direct(capture, ratios, stages, n_total):
    """Every output of the stream, directly: mix, then each stage in turn
    over the whole sequence, zeros before the first sample."""
    n, r = _sequential_counter(ratios, n_total)
    x = capture[np.arange(n_total) % len(capture)].astype(np.float64) / 32768
    phase = np.mod(r.astype(np.float64) * n, 1.0)   # exact: below 2^53
    y = (x[:, 0] + 1j * x[:, 1]) * np.exp(-2j * np.pi * phase)
    for st in stages:
        m_count = -(-len(y) * st.P // st.Q)
        bank = st.bank.astype(np.float64)
        out = np.zeros(m_count, dtype=np.complex128)
        for m in range(m_count):
            base = m * st.Q // st.P
            for ell in range(st.T):
                if base - ell >= 0:
                    out[m] += bank[(m * st.Q) % st.P, ell] * y[base - ell]
        y = out
    return y


@pytest.mark.parametrize("ratios_kind", ["const", "staircase"])
def test_region_equals_direct_statement(ratios_kind):
    rng = np.random.default_rng(7)
    n_total = 6000
    capture = rng.integers(-20000, 20000, size=(1500, 2)).astype(np.int16)
    if ratios_kind == "const":
        ratios = [(0, n_total, ratio_f32(-1234.5, 48000))]
    else:   # three segments, one of them at a ratio that resets often
        ratios = [(0, 2000, ratio_f32(3000.0, 48000)),
                  (2000, 2500, ratio_f32(12000.0, 48000)),
                  (4500, 1500, ratio_f32(-77.25, 48000))]
    stages = [Stage(1, 2, np.array([[0.25, 0.5, 0.25]], dtype=np.float32)),
              Stage(3, 4, np.random.default_rng(1).normal(
                  size=(3, 5)).astype(np.float32))]
    want = _direct(capture, ratios, stages, n_total)
    assert len(want) == due_count(n_total, stages)
    segs = counter_segments(ratios, "cpu")
    cap = torch.from_numpy(capture)
    for lo, hi in [(0, 40), (700, 900), (len(want) - 50, len(want))]:
        yi, yq = region(cap, segs, stages, lo, hi)
        got = yi.numpy() + 1j * yq.numpy()
        np.testing.assert_allclose(got, want[lo:hi], rtol=0, atol=1e-9)


def test_counter_segments_follow_the_sequential_counter():
    # the ratio crosses zero and a dyadic one resets every 8 samples
    ratios = [(0, 3000, ratio_f32(5.0, 1024000)),
              (3000, 3000, ratio_f32(128000.0, 1024000)),
              (6000, 40000, ratio_f32(-13000.0, 1024000))]
    want, _ = _sequential_counter(ratios, 46000)
    from benchmark.reference.nco import counter_values

    got = np.empty_like(want)
    k = torch.arange(46000, dtype=torch.int64)
    for seg in counter_segments(ratios, "cpu"):
        sel = slice(seg.start, seg.start + seg.length)
        got[sel] = counter_values(seg, k[sel]).numpy()
    np.testing.assert_array_equal(got, want)


def test_due_count_by_brute_force():
    stages = design_stages(1024000, 48000.0)
    assert [(s.P, s.Q, s.T) for s in stages] == [(1, 8, 65), (3, 8, 51)]
    for n_in in (0, 1, 7, 8, 9, 64, 1000, 65537):
        n1 = sum(1 for m in range(n_in) if m * 8 // 1 <= n_in - 1)
        n2 = sum(1 for m in range(3 * n1) if m * 8 // 3 <= n1 - 1)
        assert due_count(n_in, stages) == n2


def test_design_matches_the_published_stage_lists():
    assert [(s.P, s.Q, s.T) for s in design_stages(100_000_000, 48000.0)] \
        == [(1, 16, 85), (1, 16, 95), (384, 3125, 163)]


def test_track_staircase_is_whole_seconds_with_one_block_lag():
    chan = json.loads((HERE / "configs" / "estcube-track.json").read_text())[
        "channels"][0]
    segs = channel_ratios(chan, 5 * 1024000, 1024000, 2048)
    starts = [s for s, _, _ in segs]
    # block 0 at dt 0; block k at the whole seconds of blocks < k - 1
    assert starts[:3] == [0, 2048 * 501, 2048 * 1001]
    assert sum(length for _, length, _ in segs) == 5 * 1024000


def test_encode_is_the_binarys():
    y = torch.tensor([0.5, -0.5, 1.5, -1.5, float("nan"), 1e-6],
                     dtype=torch.float64)
    out = encode_i16(y, -y)
    assert out[:, 0].tolist() == [16383, -16383, 32767, -32768, 0, 0]
