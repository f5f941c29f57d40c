"""The fused chain module: the port's plain version against the JAX Pallas
chain (interpret mode).  The CUDA kernel against the plain version is in
``test_torch_cuda.py``.

Tolerances: the JAX chain mixes with XLA's contraction choices and sums the
FIR as banded matmuls; the port sums a fixed-order tree (plain) or a
sequential FMA chain (kernel).  Encoded outputs agree within 1 LSB in under
1% of samples; the float32 carry within 2^-20.  Inside the port the plain
chain is bitwise invariant to how the stream is split into chunks.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doppler_tpu.ops.pallas.chain import (
    carry_rows,
    make_chain_taps,
    mix_resample_chain_pallas_channels,
    mix_resample_chain_pallas_stream,
)
from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.cuda.chain import (
    mix_resample_chain_channels,
    mix_resample_chain_channels_plain,
    mix_resample_chain_plain,
    mix_resample_chain_stream,
)
from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt_plain
from doppler_tpu_torch.ops.filters import design_polyphase_bank
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks

torch.set_num_threads(1)   # leave the other test workers their cores

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FS = 1024000
P, Q = 3, 64                       # config 3: 1.024 Msps → 48 ksps
BANK = design_polyphase_bank(P, Q)
T = BANK.shape[1]


def _chunks(B, L, n_chunks, seed, intype="i16"):
    """Consecutive chunks of one stream with their plan words."""
    rng = np.random.default_rng(seed)
    state = NCOState()
    out = []
    for k in range(n_chunks):
        shifts = [4242.0] * (B // 2) + [-3000.5 - k] * (B - B // 2)
        plan = plan_blocks(shifts, [L] * B, FS, state, L)
        if intype == "i16":
            data = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                                dtype=np.int64).astype(np.int32)
        else:
            data = (rng.standard_normal((2, B, L)) * 0.3).astype(np.float32)
        out.append((data, plan))
    return out


def _port(chunks, intype="i16", outtype="i16"):
    bank = torch.from_numpy(BANK)
    carry = torch.zeros(2, T - 1)
    outs = []
    for data, plan in chunks:
        o, carry = mix_resample_chain_stream(
            torch.from_numpy(data), nco.plan_tensor(plan),
            bank, carry, P=P, Q=Q, T=T, intype=intype, outtype=outtype)
        outs.append(o)
    return outs, carry


@pytest.mark.parametrize("intype,outtype", [("i16", "i16"), ("f32", "f32")])
def test_plain_matches_jax_pallas_chain(intype, outtype):
    """Config-3 geometry, B = 8, L = 2048; the compared chunk starts from a
    nonzero carry built by a previous chunk."""
    chunks = _chunks(8, 2048, 2, 5, intype)
    taps = make_chain_taps(BANK, P, Q)
    jc = jnp.zeros((2, carry_rows(T), 128), jnp.float32)
    want = []
    for data, plan in chunks:
        o, jc = mix_resample_chain_pallas_stream(
            jnp.asarray(data), *(getattr(plan, f) for f in nco.PLAN_FIELDS),
            taps, jc, P=P, Q=Q, T=T, interpret=True,
            intype=intype, outtype=outtype)
        want.append(np.asarray(o))
    got, carry = _port(chunks, intype, outtype)
    assert got[1].shape == want[1].shape == (
        (8, 96) if outtype == "i16" else (2, 8, 96))
    for g, w in zip(got, want):
        if outtype == "i16":
            d = np.abs(g.numpy().view(np.int16).astype(np.int32)
                       - w.view(np.int16).astype(np.int32))
            assert d.max() <= 1 and np.mean(d > 0) < 0.01
        else:
            assert np.abs(g.numpy() - w).max() <= 2.0 ** -20
    j_tail = np.asarray(jc).reshape(2, -1)[:, -(T - 1):]
    assert np.abs(carry.numpy() - j_tail).max() <= 2.0 ** -20


def test_carry_is_the_last_mixed_samples_bitwise():
    chunks = _chunks(4, 2048, 1, 9)
    data, plan = chunks[0]
    _, carry = _port(chunks)
    mixed = mix_blocks_fmt_plain(torch.from_numpy(data), nco.plan_tensor(plan),
                                 outtype="f32").reshape(2, -1)
    assert torch.equal(carry, mixed[:, -(T - 1):])


def test_plain_chain_bitwise_invariant_to_chunk_split():
    """One 8-block chunk vs the same stream as 2 × 4 and 8 × 1 blocks."""
    (data, plan), = _chunks(8, 2048, 1, 13)
    whole, c_whole = _port([(data, plan)])
    fields = np.stack([getattr(plan, f) for f in nco.PLAN_FIELDS])
    for n in (4, 1):
        parts = [(data[k:k + n], list(fields[:, k:k + n]))
                 for k in range(0, 8, n)]
        bank = torch.from_numpy(BANK)
        carry = torch.zeros(2, T - 1)
        outs = []
        for d, f in parts:
            o, carry = mix_resample_chain_stream(
                torch.from_numpy(d), nco.plan_tensor(f), bank, carry,
                P=P, Q=Q, T=T)
            outs.append(o)
        assert torch.equal(torch.cat(outs), whole[0])
        assert torch.equal(carry, c_whole)


def test_nan_input_confined_to_its_window():
    """A NaN f32 input sample poisons exactly the outputs whose T-window
    holds it (the direct dot's semantics, unlike the TPU's banded matmul,
    ``doppler_tpu/ops/pallas/chain.py:426-430``), and encodes to 0."""
    (data, plan), = _chunks(4, 2048, 1, 17, "f32")
    k = 3000
    bad = data.copy()
    bad[0].reshape(-1)[k] = np.nan
    (clean,), _ = _port([(data, plan)], "f32", "f32")
    (dirty,), _ = _port([(bad, plan)], "f32", "f32")
    m = np.arange(4 * 96)
    n = (m * Q) // P
    hit = (n - (T - 1) <= k) & (k <= n)
    nan = np.isnan(dirty.numpy().reshape(2, -1))
    assert np.array_equal(nan[0], hit) and np.array_equal(nan[1], hit)
    assert torch.equal(dirty.reshape(2, -1)[:, ~hit], clean.reshape(2, -1)[:, ~hit])
    (words,), _ = _port([(bad, plan)], "f32", "i16")
    assert not words.reshape(-1)[hit].any()


def test_rejects_bad_geometry():
    (data, plan), = _chunks(2, 2048, 1, 1)
    x, p = torch.from_numpy(data), nco.plan_tensor(plan)
    bank = torch.from_numpy(BANK)
    with pytest.raises(ValueError, match="carry"):
        mix_resample_chain_plain(x, p, bank, torch.zeros(2, 5), P=P, Q=Q, T=T)
    with pytest.raises(ValueError, match="multiple of Q"):
        mix_resample_chain_plain(x[:, :1000], p, bank, torch.zeros(2, T - 1),
                                 P=P, Q=Q, T=T)


# -- the channel axis -------------------------------------------------------

def _channel_chunks(C, B, L, n_chunks, seed, intype="i16"):
    """Consecutive shared chunks with ``(7, C, B)`` plan words: every channel
    its own shifts and samplenum state."""
    rng = np.random.default_rng(seed)
    states = [NCOState(samplenum=11 * c) for c in range(C)]
    out = []
    for k in range(n_chunks):
        fields = np.stack([
            np.stack([getattr(plan_blocks(
                [4242.0 + 1500.0 * c] * (B // 2) + [-3000.5 - k - 7 * c] * (B - B // 2),
                [L] * B, FS, states[c], L), f) for f in nco.PLAN_FIELDS])
            for c in range(C)], axis=1)                      # (7, C, B)
        if intype == "i16":
            data = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                                dtype=np.int64).astype(np.int32)
        else:
            data = (rng.standard_normal((2, B, L)) * 0.3).astype(np.float32)
        out.append((data, fields))
    return out


def _tpu_rows(flat, T):
    """Flat ``(C, 2, T−1)`` carries → the TPU layout ``(C, 2, HBR, 128)``:
    right-aligned in whole 128-sample rows, zeros in front (the seeding of
    ``doppler_tpu/runtime/channels.py:699-703``)."""
    C, hbr = flat.shape[0], carry_rows(T)
    rows = np.zeros((C, 2, hbr * 128), np.float32)
    rows[:, :, hbr * 128 - (T - 1):] = flat
    return rows.reshape(C, 2, hbr, 128)


@pytest.mark.parametrize("intype,outtype", [("i16", "i16"), ("i16", "f32"),
                                            ("f32", "i16"), ("f32", "f32")])
def test_channels_plain_matches_jax_pallas_channels(intype, outtype):
    """C = 3 channels over one shared chunk against
    ``mix_resample_chain_pallas_channels`` (interpret mode); the compared
    chunk starts from the nonzero per-channel carries of a previous one."""
    C, B = 3, 8
    chunks = _channel_chunks(C, B, 2048, 2, 21, intype)
    taps = make_chain_taps(BANK, P, Q)
    bank = torch.from_numpy(BANK)
    carries = torch.zeros(C, 2, T - 1)
    jc = jnp.asarray(_tpu_rows(carries.numpy(), T))
    for data, fields in chunks:
        want, jc = mix_resample_chain_pallas_channels(
            jnp.asarray(data), jnp.asarray(fields), taps, jc, P=P, Q=Q, T=T,
            interpret=True, intype=intype, outtype=outtype)
        got, carries = mix_resample_chain_channels(
            torch.from_numpy(data),
            torch.from_numpy(fields.view(np.int32)), bank, carries,
            P=P, Q=Q, T=T, intype=intype, outtype=outtype)
        want = np.asarray(want)
        assert got.shape == want.shape == (
            (C, B, 96) if outtype == "i16" else (2, C, B, 96))
        if outtype == "i16":
            d = np.abs(got.numpy().view(np.int16).astype(np.int32)
                       - want.view(np.int16).astype(np.int32))
            assert d.max() <= 1 and np.mean(d > 0) < 0.01
        else:
            assert np.abs(got.numpy() - want).max() <= 2.0 ** -20
        # carries: the flat (C, 2, T−1) history is the tail of the TPU rows
        j_tail = np.asarray(jc).reshape(C, 2, -1)[:, :, -(T - 1):]
        assert np.abs(carries.numpy() - j_tail).max() <= 2.0 ** -20


def test_channel_rows_equal_the_stream_call_bitwise():
    """Channel c of the batched call is the stream call with that channel's
    plan words and carry, and the plain version is what a CPU tensor runs."""
    C = 4
    (data, fields), = _channel_chunks(C, 4, 2048, 1, 23)
    x = torch.from_numpy(data)
    p = torch.from_numpy(fields.view(np.int32))
    bank = torch.from_numpy(BANK)
    rng = np.random.default_rng(3)
    carries = torch.from_numpy(
        rng.standard_normal((C, 2, T - 1)).astype(np.float32) * 0.2)
    got, c_got = mix_resample_chain_channels(x, p, bank, carries, P=P, Q=Q, T=T)
    plain, c_plain = mix_resample_chain_channels_plain(x, p, bank, carries,
                                                       P=P, Q=Q, T=T)
    assert torch.equal(got, plain) and torch.equal(c_got, c_plain)
    for c in range(C):
        one, c_one = mix_resample_chain_stream(x, p[:, c], bank, carries[c],
                                               P=P, Q=Q, T=T)
        assert torch.equal(got[c], one) and torch.equal(c_got[c], c_one)


def test_channels_reject_bad_shapes():
    (data, fields), = _channel_chunks(2, 2, 2048, 1, 1)
    x = torch.from_numpy(data)
    p = torch.from_numpy(fields.view(np.int32))
    bank = torch.from_numpy(BANK)
    with pytest.raises(ValueError, match="carry"):
        mix_resample_chain_channels(x, p, bank, torch.zeros(2, T - 1),
                                    P=P, Q=Q, T=T)
    with pytest.raises(ValueError, match=r"plans must be int32 \(7, C, 2\)"):
        mix_resample_chain_channels(x, p[:, 0], bank, torch.zeros(2, 2, T - 1),
                                    P=P, Q=Q, T=T)
    with pytest.raises(ValueError, match="on one device"):
        mix_resample_chain_channels(x, p.to("meta"), bank,
                                    torch.zeros(2, 2, T - 1), P=P, Q=Q, T=T)
