"""The fused cascade module: the port's plain version against the JAX Pallas
cascade (interpret mode).  The CUDA kernel against the plain version is in
``test_torch_cuda.py``.

Tolerances: the JAX cascade mixes with XLA's contraction choices and sums
each stage as banded matmuls; the port sums a fixed-order tree (plain) or a
sequential FMA chain (kernel).  Encoded outputs agree within 1 LSB in under
1% of samples; float32 outputs and carries within 2^-20 (every stage's
gain is about 1 and |x| ≤ √2, so that is a few float32 ulps of the
largest value).  Inside the port the plain cascade is bitwise invariant to
how the stream is split into chunks, and its stage-0 carry is bitwise the
mixed samples.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doppler_tpu.ops.multistage import MultiStageResampler as JMultiStage
from doppler_tpu.ops.pallas.chain import (
    carry_rows,
    make_chain_taps,
    mix_cascade_pallas_channels,
    mix_cascade_pallas_stream,
)
from doppler_tpu.ops.pallas.chain import split_point as j_split_point
from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.cuda.cascade import (
    mix_cascade_channels,
    mix_cascade_channels_plain,
    mix_cascade_plain,
    mix_cascade_stream,
    split_point,
)
from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt_plain
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks

torch.set_num_threads(1)   # leave the other test workers their cores

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FS = 1024000
CONFIG3 = MultiStageResampler(FS, 48000)     # ÷8 T = 65, then 3/8 T = 51
TOL_F32 = 2.0 ** -20


def _chunks(fs, B, L, n_chunks, seed, intype="i16"):
    """Consecutive chunks of one stream with their plan words."""
    rng = np.random.default_rng(seed)
    state = NCOState()
    out = []
    for k in range(n_chunks):
        shifts = [4242.0] * (B // 2) + [-3000.5 - k] * (B - B // 2)
        plan = plan_blocks(shifts, [L] * B, fs, state, L)
        if intype == "i16":
            data = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                                dtype=np.int64).astype(np.int32)
        else:
            data = (rng.standard_normal((2, B, L)) * 0.3).astype(np.float32)
        out.append((data, plan))
    return out


def _stages(ms, k=None):
    fused = ms.stages[:k]
    return (tuple((st.P, st.Q, st.T) for st in fused),
            tuple(torch.from_numpy(st.bank) for st in fused))


def _port(chunks, ms, k=None, intype="i16", outtype="i16", final_dense=False):
    stages, banks = _stages(ms, k)
    carries = tuple(torch.zeros(2, T - 1) for _, _, T in stages)
    outs = []
    for data, plan in chunks:
        o, carries = mix_cascade_stream(
            torch.from_numpy(data), nco.plan_tensor(plan), banks, carries,
            stages=stages, intype=intype, outtype=outtype,
            final_dense=final_dense)
        outs.append(o)
    return outs, carries


def _jax(chunks, ms, k=None, intype="i16", outtype="i16", final_dense=False):
    fused = ms.stages[:k]
    n = len(fused)
    stages = tuple((st.P, st.Q, st.T) for st in fused)
    taps = tuple(
        jnp.asarray(make_chain_taps(st.bank, st.P, st.Q,
                                    pp=st.P if (i < n - 1 or final_dense) else None))
        for i, st in enumerate(fused))
    carries = tuple(jnp.zeros((2, carry_rows(st.T), 128), jnp.float32)
                    for st in fused)
    outs = []
    for data, plan in chunks:
        o, carries = mix_cascade_pallas_stream(
            jnp.asarray(data), *(getattr(plan, f) for f in nco.PLAN_FIELDS),
            taps, carries, stages=stages, interpret=True, intype=intype,
            outtype=outtype, final_dense=final_dense)
        outs.append(np.asarray(o))
    tails = [np.asarray(c).reshape(2, -1)[:, c.size // 2 - (T - 1):]
             for c, (_, _, T) in zip(carries, stages)]
    return outs, tails


def _assert_lsb(got, want):
    d = np.abs(got.numpy().view(np.int16).astype(np.int32)
               - want.view(np.int16).astype(np.int32))
    assert d.max() <= 1 and np.mean(d > 0) < 0.01, (d.max(), np.mean(d > 0))


@pytest.mark.parametrize("intype,outtype", [("i16", "i16"), ("i16", "f32"),
                                            ("f32", "i16"), ("f32", "f32")])
def test_plain_matches_jax_pallas_cascade(intype, outtype):
    """Config-3 stages, B = 8, L = 2048; the compared chunk starts from the
    nonzero carries a previous chunk left."""
    chunks = _chunks(FS, 8, 2048, 2, 5, intype)
    got, carries = _port(chunks, CONFIG3, intype=intype, outtype=outtype)
    want, tails = _jax(chunks, CONFIG3, intype=intype, outtype=outtype)
    assert got[1].shape == want[1].shape == (
        (8, 96) if outtype == "i16" else (2, 8, 96))
    for g, w in zip(got, want):
        if outtype == "i16":
            _assert_lsb(g, w)
        else:
            assert np.abs(g.numpy() - w).max() <= TOL_F32
    for c, t in zip(carries, tails):
        assert np.abs(c.numpy() - t).max() <= TOL_F32


@pytest.mark.parametrize("fs", [100_000_000, 250000])
def test_split_front_matches_jax_final_dense(fs):
    """The split cascade's ÷2^k front (float32 planes out) against the JAX
    kernel with ``final_dense=True`` (B = 16: the smallest chunk the TPU
    geometry of the ÷16·÷16 front takes)."""
    ms = MultiStageResampler(fs, 48000)
    k = split_point(ms.stages)
    assert 0 < k < len(ms.stages)
    B = 16
    chunks = _chunks(fs, B, 2048, 2, 7)
    got, carries = _port(chunks, ms, k, outtype="f32", final_dense=True)
    want, tails = _jax(chunks, ms, k, outtype="f32", final_dense=True)
    q = 1
    for st in ms.stages[:k]:
        q *= st.Q
    assert got[1].shape == want[1].shape == (2, B, 2048 // q)
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= TOL_F32
    for c, t in zip(carries, tails):
        assert np.abs(c.numpy() - t).max() <= TOL_F32


def test_two_half_chunks_equal_one_whole_chunk_bitwise():
    (data, plan), = _chunks(FS, 8, 2048, 1, 13)
    (whole,), c_whole = _port([(data, plan)], CONFIG3)
    fields = np.stack([getattr(plan, f) for f in nco.PLAN_FIELDS])
    halves = [(data[k:k + 4], list(fields[:, k:k + 4])) for k in (0, 4)]
    parts, c_parts = _port(halves, CONFIG3)
    assert torch.equal(torch.cat(parts), whole)
    assert all(torch.equal(a, b) for a, b in zip(c_parts, c_whole))


def test_stage0_carry_is_the_last_mixed_samples_bitwise():
    chunks = _chunks(FS, 4, 2048, 1, 9)
    data, plan = chunks[0]
    _, carries = _port(chunks, CONFIG3)
    mixed = mix_blocks_fmt_plain(torch.from_numpy(data), nco.plan_tensor(plan),
                                 outtype="f32").reshape(2, -1)
    assert torch.equal(carries[0], mixed[:, -(CONFIG3.stages[0].T - 1):])


@pytest.mark.parametrize("fs,out", [
    (1024000, 48000), (256000, 48000), (2048000, 48000), (10_000_000, 48000),
    (100_000_000, 48000), (250000, 48000), (1024000, 256000)])
def test_split_point_is_the_jax_rule(fs, out):
    assert split_point(MultiStageResampler(fs, out).stages) == \
        j_split_point(JMultiStage(fs, out).stages)


def test_rejects_bad_geometry():
    (data, plan), = _chunks(FS, 2, 2048, 1, 1)
    x, p = torch.from_numpy(data), nco.plan_tensor(plan)
    stages, banks = _stages(CONFIG3)
    carries = tuple(torch.zeros(2, T - 1) for _, _, T in stages)
    with pytest.raises(ValueError, match="carry"):
        mix_cascade_plain(x, p, banks, (torch.zeros(2, 5),) + carries[1:],
                          stages=stages)
    with pytest.raises(ValueError, match="does not fit a chunk of 2×1000"):
        mix_cascade_plain(x[:, :1000], p, banks, carries, stages=stages)
    with pytest.raises(ValueError, match="1 to 4 stages"):
        mix_cascade_plain(x, p, banks * 3, carries * 3, stages=stages * 3)
    with pytest.raises(ValueError, match="final_dense"):
        mix_cascade_plain(x, p, banks, carries, stages=stages, final_dense=True)


# -- the channel axis -------------------------------------------------------

def _channel_chunks(fs, C, B, L, n_chunks, seed, intype="i16"):
    """Consecutive shared chunks with ``(7, C, B)`` plan words: every channel
    its own shifts and samplenum state."""
    rng = np.random.default_rng(seed)
    states = [NCOState(samplenum=11 * c) for c in range(C)]
    out = []
    for k in range(n_chunks):
        fields = np.stack([
            np.stack([getattr(plan_blocks(
                [4242.0 + 1500.0 * c] * (B // 2) + [-3000.5 - k - 7 * c] * (B - B // 2),
                [L] * B, fs, states[c], L), f) for f in nco.PLAN_FIELDS])
            for c in range(C)], axis=1)                      # (7, C, B)
        if intype == "i16":
            data = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                                dtype=np.int64).astype(np.int32)
        else:
            data = (rng.standard_normal((2, B, L)) * 0.3).astype(np.float32)
        out.append((data, fields))
    return out


def _channels_vs_jax(fs, C, B, intype, outtype, seed):
    """Two chunks through ``mix_cascade_channels`` (the plain version, on
    the CPU) and ``mix_cascade_pallas_channels`` (interpret mode), both
    from zero carries; the TPU carries ``(C, 2, HBR, 128)`` hold the flat
    ``(C, 2, T−1)`` histories in their tails."""
    ms = MultiStageResampler(fs, 48000)
    k = split_point(ms.stages)
    dense = k < len(ms.stages)
    fused = ms.stages[:k]
    stages, banks = _stages(ms, k)
    taps = tuple(
        jnp.asarray(make_chain_taps(st.bank, st.P, st.Q,
                                    pp=st.P if (i < k - 1 or dense) else None))
        for i, st in enumerate(fused))
    carries = tuple(torch.zeros(C, 2, T - 1) for _, _, T in stages)
    jc = tuple(jnp.zeros((C, 2, carry_rows(T), 128), jnp.float32)
               for _, _, T in stages)
    for data, fields in _channel_chunks(fs, C, B, 2048, 2, seed, intype):
        want, jc = mix_cascade_pallas_channels(
            jnp.asarray(data), jnp.asarray(fields), taps, jc, stages=stages,
            interpret=True, intype=intype, outtype=outtype, final_dense=dense)
        got, carries = mix_cascade_channels(
            torch.from_numpy(data), torch.from_numpy(fields.view(np.int32)),
            banks, carries, stages=stages, intype=intype, outtype=outtype,
            final_dense=dense)
        want = np.asarray(want)
        assert got.shape == want.shape
        if outtype == "i16":
            _assert_lsb(got, want)
        else:
            assert np.abs(got.numpy() - want).max() <= TOL_F32
        for c, j, (_, _, T) in zip(carries, jc, stages):
            tail = np.asarray(j).reshape(C, 2, -1)[:, :, -(T - 1):]
            assert np.abs(c.numpy() - tail).max() <= TOL_F32
    return got


@pytest.mark.parametrize("intype,outtype", [("i16", "i16"), ("i16", "f32"),
                                            ("f32", "i16"), ("f32", "f32")])
def test_channels_plain_matches_jax_pallas_channels(intype, outtype):
    """Config-3 stages, C = 3, B = 8; the second chunk starts from the
    carries of the first."""
    got = _channels_vs_jax(FS, 3, 8, intype, outtype, 31)
    assert got.shape == ((3, 8, 96) if outtype == "i16" else (2, 3, 8, 96))


@pytest.mark.parametrize("fs", [100_000_000, 250000])
def test_channels_split_front_matches_jax_final_dense(fs):
    """The ÷2^k front of a split cascade for C = 3 channels: float32 planes
    ``(2, C, B, M_mid)``, which the tail stages read as ``(C, n_mid)`` rows."""
    got = _channels_vs_jax(fs, 3, 16, "i16", "f32", 33)
    assert got.shape[:3] == (2, 3, 16)


@pytest.mark.parametrize("fs", [FS, 250000])
def test_channel_rows_equal_the_stream_call_bitwise(fs):
    C = 4
    ms = MultiStageResampler(fs, 48000)
    k = split_point(ms.stages)
    dense = k < len(ms.stages)
    stages, banks = _stages(ms, k)
    kw = dict(stages=stages, outtype="f32" if dense else "i16", final_dense=dense)
    (data, fields), = _channel_chunks(fs, C, 4, 2048, 1, 35)
    x = torch.from_numpy(data)
    p = torch.from_numpy(fields.view(np.int32))
    rng = np.random.default_rng(4)
    carries = tuple(torch.from_numpy(
        rng.standard_normal((C, 2, T - 1)).astype(np.float32) * 0.2)
        for _, _, T in stages)
    got, c_got = mix_cascade_channels(x, p, banks, carries, **kw)
    plain, c_plain = mix_cascade_channels_plain(x, p, banks, carries, **kw)
    assert torch.equal(got, plain)
    assert all(torch.equal(a, b) for a, b in zip(c_got, c_plain))
    for c in range(C):
        one, c_one = mix_cascade_stream(x, p[:, c], banks,
                                        [cr[c] for cr in carries], **kw)
        assert torch.equal(got[:, c] if dense else got[c], one)
        assert all(torch.equal(a[c], b) for a, b in zip(c_got, c_one))


def test_channels_reject_bad_shapes():
    (data, fields), = _channel_chunks(FS, 2, 2, 2048, 1, 1)
    x = torch.from_numpy(data)
    p = torch.from_numpy(fields.view(np.int32))
    stages, banks = _stages(CONFIG3)
    carries = tuple(torch.zeros(2, 2, T - 1) for _, _, T in stages)
    with pytest.raises(ValueError, match="carry"):
        mix_cascade_channels(x, p, banks, tuple(c[0] for c in carries),
                             stages=stages)
    with pytest.raises(ValueError, match="plans must be int32"):
        mix_cascade_channels(x, p[:, 0], banks, carries, stages=stages)
    with pytest.raises(ValueError, match="on one device"):
        mix_cascade_channels(x, p.to("meta"), banks, carries, stages=stages)
