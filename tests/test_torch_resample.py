"""The port's RationalResampler against the JAX package's ``'window'`` form.

Tolerance 1e-6 relative: both gather the same taps and sum the same
fixed-order tree, but XLA may contract a product into the first level of
adds.  Inside the port, streaming equals one-shot bitwise and a state_dict
round trip resumes bitwise.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doppler_tpu.ops.multistage import make_resampler as j_make_resampler
from doppler_tpu.ops.resample import RationalResampler as JRationalResampler
from doppler_tpu_torch import oracle
from doppler_tpu_torch.ops import resample
from doppler_tpu_torch.ops.multistage import make_resampler
from doppler_tpu_torch.ops.resample import RationalResampler

torch.set_num_threads(1)   # leave the other test workers their cores


def _signal(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((2, n)) * 0.3).astype(np.float32))


def _stream(rs, x, sizes, *, jax_rs=False):
    outs_i, outs_q, pos = [], [], 0
    for n in sizes:
        cap = max(sizes)
        i = np.zeros(cap, np.float32)
        q = np.zeros(cap, np.float32)
        i[:n], q[:n] = x[0, pos:pos + n], x[1, pos:pos + n]
        if jax_rs:
            yi, yq, k = rs.process(jnp.asarray(i), jnp.asarray(q), n,
                                   M=rs.max_out_for(cap))
            yi, yq = np.asarray(yi), np.asarray(yq)
        else:
            yi, yq, k = rs.process(torch.from_numpy(i), torch.from_numpy(q), n,
                                   M=rs.max_out_for(cap))
            yi, yq = yi.numpy(), yq.numpy()
        outs_i.append(yi[:k])
        outs_q.append(yq[:k])
        pos += n
    return np.concatenate(outs_i), np.concatenate(outs_q)


@pytest.mark.parametrize("fs,out", [(1024000, 48000), (256000, 48000),
                                    (48000, 44100)])
def test_process_matches_jax_window(fs, out):
    x = _signal(20000, fs)
    sizes = [6144, 6144, 6144, 1568]
    ti, tq = _stream(RationalResampler(fs, out), x, sizes)
    ji, jq = _stream(JRationalResampler(fs, out, impl="window"), x, sizes,
                     jax_rs=True)
    assert ti.shape == ji.shape
    scale = np.abs(np.concatenate([ji, jq])).max()
    assert np.abs(ti - ji).max() <= 1e-6 * scale
    assert np.abs(tq - jq).max() <= 1e-6 * scale


def test_streaming_equals_one_shot_bitwise():
    x = _signal(30000, 2)
    rs = RationalResampler(1024000, 48000)
    one_i, one_q = _stream(rs, x, [30000])
    part_i, part_q = _stream(RationalResampler(1024000, 48000), x,
                             [4096, 777, 12000, 13127])
    assert np.array_equal(one_i, part_i) and np.array_equal(one_q, part_q)
    # and the whole-stream outputs are the golden model's (float64 dot)
    want = oracle.resample_oracle(x[0] + 1j * x[1], rs.P, rs.Q, rs.bank)
    assert one_i.size == want.size
    assert oracle.snr_db(want, one_i + 1j * one_q) > 120.0


def test_state_dict_round_trip():
    x = _signal(16000, 3)
    a = RationalResampler(1024000, 48000)
    whole_i, _ = _stream(a, x, [8000, 8000])
    b = RationalResampler(1024000, 48000)
    first_i, _ = _stream(b, x[:, :8000], [8000])
    state = b.state_dict()
    assert state["hist_i"].shape == (b.T - 1,)
    c = RationalResampler(1024000, 48000)
    c.load_state(state)
    rest_i, _ = _stream(c, x[:, 8000:], [8000])
    assert np.array_equal(np.concatenate([first_i, rest_i]), whole_i)
    with pytest.raises(ValueError, match="T−1"):
        c.load_state({**state, "hist_i": state["hist_i"][:5]})


def test_out_counts_match_jax():
    a = RationalResampler(1024000, 48000)
    b = JRationalResampler(1024000, 48000)
    for n in (1, 21, 22, 2048, 65536, 333):
        assert a.out_count_for(n) == b.out_count_for(n)
        assert a.max_out_for(n) == b.max_out_for(n)
        a.in_consumed += n
        b.in_consumed += n
        k = a.out_count_for(0)
        a.m_next += k
        b.m_next += k
        assert a.out_count_for(0) == b.out_count_for(0) == 0
    assert (a.P, a.Q, a.T) == (b.P, b.Q, b.T)


# -- channels=C: the batched resamplers ----------------------------------------

def _batched(rs, x, sizes, *, jax_rs=False):
    """Stream ``(2, C, N)`` planes through a ``channels=C`` resampler in
    chunks of ``sizes``; returns the valid ``(C, n_out)`` planes."""
    outs_i, outs_q, pos = [], [], 0
    cap = max(sizes)
    for n in sizes:
        i = np.zeros((x.shape[1], cap), np.float32)
        q = np.zeros_like(i)
        i[:, :n], q[:, :n] = x[0, :, pos:pos + n], x[1, :, pos:pos + n]
        if jax_rs:
            yi, yq, k = rs.process(jnp.asarray(i), jnp.asarray(q), n,
                                   M=rs.max_out_for(cap))
            yi, yq = np.asarray(yi), np.asarray(yq)
        else:
            yi, yq, k = rs.process(torch.from_numpy(i), torch.from_numpy(q), n,
                                   M=rs.max_out_for(cap))
            yi, yq = yi.numpy(), yq.numpy()
        outs_i.append(yi[:, :k])
        outs_q.append(yq[:, :k])
        pos += n
    return np.concatenate(outs_i, axis=1), np.concatenate(outs_q, axis=1)


@pytest.mark.parametrize("fs,out,stages", [
    (1024000, 48000, "single"), (1024000, 48000, "multi"),
    (250000, 48000, "multi"), (48000, 44100, "single")])
def test_batched_rows_equal_unbatched_bitwise_and_match_jax(fs, out, stages):
    """``channels=C``: row c is bitwise an unbatched resampler fed row c, and
    the batch is within 2^-20 of the JAX package's ``channels=C`` (window
    form) — single-stage and cascade."""
    C = 3
    rng = np.random.default_rng(fs % 997)
    x = (rng.standard_normal((2, C, 9000)) * 0.3).astype(np.float32)
    sizes = [4096, 777, 4127]
    bi, bq = _batched(make_resampler(fs, out, stages=stages, channels=C), x, sizes)
    for c in range(C):
        ui, uq = _stream(make_resampler(fs, out, stages=stages), x[:, c], sizes)
        assert np.array_equal(bi[c], ui) and np.array_equal(bq[c], uq)
    ji, jq = _batched(j_make_resampler(fs, out, stages=stages, channels=C,
                                       impl="window"), x, sizes, jax_rs=True)
    assert bi.shape == ji.shape
    assert np.abs(bi - ji).max() <= 2.0 ** -20
    assert np.abs(bq - jq).max() <= 2.0 ** -20


def test_batched_state_keeps_its_shape_and_slab_scales(monkeypatch):
    """The ``(C, T−1)`` histories survive a state_dict round trip (a flat
    history is refused), and the gather's slab shrinks with C without
    changing a bit."""
    C = 4
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((2, C, 8000)) * 0.3).astype(np.float32)
    whole_i, whole_q = _batched(RationalResampler(1024000, 48000, channels=C),
                                x, [4000, 4000])
    b = RationalResampler(1024000, 48000, channels=C)
    first_i, _ = _batched(b, x[:, :, :4000], [4000])
    state = b.state_dict()
    assert state["hist_i"].shape == (C, b.T - 1)
    c = RationalResampler(1024000, 48000, channels=C)
    c.load_state(state)
    assert tuple(c._hist_i.shape) == (C, b.T - 1)
    # a tiny slab: many passes over the outputs, the same bits
    monkeypatch.setattr(resample, "_SLAB", 4 * 7)
    rest_i, rest_q = _batched(c, x[:, :, 4000:], [4000])
    assert np.array_equal(np.concatenate([first_i, rest_i], axis=1), whole_i)
    with pytest.raises(ValueError, match="T−1"):
        c.load_state({**state, "hist_i": state["hist_i"].reshape(-1)})
    with pytest.raises(ValueError, match="channels must be positive"):
        RationalResampler(1024000, 48000, channels=0)
