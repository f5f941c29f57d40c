"""The cascade of the bf16 dots (``dot_precision='split3'`` and
``'default'``) on the CPU: the port's plain version against the JAX
package's.

- ``split3`` against ``mix_cascade_pallas_stream(dot_precision="split3",
  interpret=True)``: config 3's two stages (1.024 Msps → 48 ksps) i16 → i16
  and f32 → f32 over two chained chunks, and the ``final_dense`` front of
  the 100 Msps route; i16 within 1 LSB in under 1% of samples, float32
  within 1e-5 of the largest output (``test_torch_precision.py``'s bounds:
  the two sum the same exact products in other orders).  The stage-0
  carries are bitwise the exact plain version's (the mixed samples); the
  later carries, each function's own x_s, within 2^-20 of JAX's carry rows.
- ``default`` against its stated reference: JAX on the CPU (interpret mode)
  computes a DEFAULT dot in float32, so the JAX function run here is no
  reference for it.  What a DEFAULT dot is on the TPU is one bf16 pass of
  the split operands, ``x_h·t_h`` with float32 accumulation; the reference
  sums those products in float64 stage by stage (each stage from the port's
  own float32 x_s) and the plain version is within 2^-22 of the largest
  output of it.  Against the exact cascade the one pass is ≥ 45 dB (i16
  words; bf16 keeps 8 bits of each operand).
- 256 blocks against 4 × 64 blocks, bitwise, for both.
- The chunk rule: every stage's window count a multiple of 16.

The CUDA kernel against this plain version is in ``test_torch_cuda.py``
(``-k cascade_fast``); its device functions on the CPU in
``test_torch_kernel_geometry.py -k fast_cascade``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppler_tpu.ops.pallas.chain import (
    carry_rows,
    make_chain_taps,
    mix_cascade_pallas_stream,
)
from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.cuda.cascade import (
    mix_cascade_channels,
    mix_cascade_plain,
    mix_cascade_stream,
    split_point,
)
from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt_plain
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks
from doppler_tpu_torch.ops.precision import split_bf16_exact

torch.set_num_threads(1)   # leave the other test workers their cores

FS = 1024000
CONFIG3 = MultiStageResampler(FS, 48000)          # ÷8 T = 65, then 3/8 T = 51
FRONT = MultiStageResampler(100_000_000, 48000)   # ÷16 T = 85, ÷16 T = 95, tail
TOL_F32 = 2.0 ** -20


def _chunks(fs, B, L, n_chunks, seed, intype="i16"):
    """Consecutive chunks of one stream with their plan words."""
    rng = np.random.default_rng(seed)
    state = NCOState()
    out = []
    for k in range(n_chunks):
        plan = plan_blocks([4242.0] * (B // 2) + [-3000.5 - k] * (B - B // 2),
                           [L] * B, fs, state, L)
        if intype == "i16":
            data = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                                dtype=np.int64).astype(np.int32)
        else:
            data = (rng.standard_normal((2, B, L)) * 0.3).astype(np.float32)
        out.append((data, plan))
    return out


def _fused(ms):
    fused = ms.stages[:split_point(ms.stages)]
    return (tuple((st.P, st.Q, st.T) for st in fused),
            tuple(torch.from_numpy(st.bank) for st in fused))


def _port(chunks, ms, dot, **kw):
    stages, banks = _fused(ms)
    carries = tuple(torch.zeros(2, T - 1) for _, _, T in stages)
    outs, all_carries = [], []
    for data, plan in chunks:
        o, carries = mix_cascade_stream(
            torch.from_numpy(data), nco.plan_tensor(plan), banks, carries,
            stages=stages, dot_precision=dot, **kw)
        outs.append(o)
        all_carries.append(carries)
    return outs, all_carries


def _jax(chunks, ms, final_dense=False, **kw):
    fused = ms.stages[:split_point(ms.stages)]
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
            taps, carries, stages=stages, interpret=True, dot_precision="split3",
            final_dense=final_dense, **kw)
        outs.append(np.asarray(o))
    tails = [np.asarray(c).reshape(2, -1)[:, c.size // 2 - (T - 1):]
             for c, (_, _, T) in zip(carries, stages)]
    return outs, tails


CASES = {
    "config3 i16": (CONFIG3, 8, "i16", "i16", False),
    "config3 f32": (CONFIG3, 8, "f32", "f32", False),
    "front100M": (FRONT, 16, "i16", "f32", True),
}


@pytest.fixture(scope="module")
def jax_split3():
    """One JAX interpret run of two chained chunks per case, shared."""
    out = {}
    for name, (ms, B, intype, outtype, dense) in CASES.items():
        chunks = _chunks(ms.in_rate, B, 2048, 2, 5, intype)
        out[name] = chunks, _jax(chunks, ms, final_dense=dense, intype=intype,
                                 outtype=outtype)
    return out


def _lsb(got, want):
    return np.abs(got.reshape(-1).view(np.int16).astype(np.int32)
                  - want.reshape(-1).view(np.int16).astype(np.int32))


@pytest.mark.parametrize("name", list(CASES))
def test_split3_plain_matches_jax_pallas_cascade(name, jax_split3):
    ms, B, intype, outtype, dense = CASES[name]
    chunks, (want, tails) = jax_split3[name]
    kw = dict(intype=intype, outtype=outtype, final_dense=dense)
    got, carries = _port(chunks, ms, "split3", **kw)
    exact, exact_carries = _port(chunks, ms, "highest", **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if outtype == "i16":
            d = _lsb(g.numpy(), w)
            assert d.max() <= 1 and np.mean(d > 0) < 0.01, (d.max(), np.mean(d > 0))
        else:
            assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
    # stage 0: the mixed samples, bitwise the exact path's; later stages:
    # each function's own x_s
    for c, ce in zip(carries, exact_carries):
        assert torch.equal(c[0], ce[0])
    for c, t in zip(carries[-1][1:], tails[1:]):
        assert np.abs(c.numpy() - t).max() <= TOL_F32
    assert not all(torch.equal(a, b) for a, b in zip(got, exact))


def _default_stage(x, carry, bank, P, Q, T):
    """Float64 sum of ``x_h·t_h`` over ``[carry | x]``: one stage of the
    stated reference."""
    buf = torch.cat([carry, x], dim=1)
    x_h = split_bf16_exact(buf)[0].double().numpy()
    t_h = split_bf16_exact(bank)[0].double().numpy()
    M = x.shape[1] // Q * P
    m = np.arange(M)
    n = m * Q // P + (T - 1)                       # index of x[⌊mQ/P⌋] in buf
    idx = n[:, None] - np.arange(T)[None, :]
    taps = t_h[(m * Q) % P]                        # (M, T)
    return np.stack([(x_h[c][idx] * taps).sum(axis=1) for c in range(2)])


@pytest.mark.parametrize("intype", ["i16", "f32"])
def test_default_plain_is_one_bf16_pass(intype):
    """Config 3 from nonzero carries: each stage of the plain ``default``
    cascade within 2^-22 of the largest output of the float64 sum of
    ``x_h·t_h`` over its own input; ≥ 45 dB from the exact cascade."""
    (data, plan), = _chunks(FS, 8, 2048, 1, 9, intype)
    stages, banks = _fused(CONFIG3)
    rng = np.random.default_rng(10)
    carries = [torch.from_numpy((rng.standard_normal((2, T - 1)) * 0.3)
                                .astype(np.float32)) for _, _, T in stages]
    x, p = torch.from_numpy(data), nco.plan_tensor(plan)
    got, c_got = mix_cascade_stream(x, p, banks, carries, stages=stages,
                                    intype=intype, outtype="f32",
                                    dot_precision="default")
    # x_1 as the plain version computes it: its first stage alone
    x1, _ = mix_cascade_plain(x, p, banks[:1], carries[:1], stages=stages[:1],
                              intype=intype, outtype="f32", final_dense=True,
                              dot_precision="default")
    x0 = mix_blocks_fmt_plain(x, p, intype=intype, outtype="f32").reshape(2, -1)
    for xs, want_out, k in ((x0, x1, 0), (x1.reshape(2, -1), got, 1)):
        want = _default_stage(xs, carries[k], banks[k], *stages[k])
        have = want_out.reshape(2, -1).double().numpy()
        assert np.abs(have - want).max() <= 2.0 ** -22 * np.abs(want).max()
    assert torch.equal(c_got[1], x1.reshape(2, -1)[:, -(stages[1][2] - 1):])
    words, _ = mix_cascade_stream(x, p, banks, carries, stages=stages,
                                  intype=intype, dot_precision="default")
    exact, c_exact = mix_cascade_stream(x, p, banks, carries, stages=stages,
                                        intype=intype)
    assert torch.equal(c_got[0], c_exact[0])
    w = exact.numpy().reshape(-1).view(np.int16).astype(np.float64)
    d = words.numpy().reshape(-1).view(np.int16).astype(np.float64) - w
    snr = 10 * np.log10((w ** 2).sum() / (d ** 2).sum())
    assert snr >= 45.0, snr


@pytest.mark.parametrize("dot", ["split3", "default"])
def test_fast_plain_bitwise_invariant_to_chunk_split(dot):
    """256 blocks of 2048 samples against 4 × 64 blocks, from carries."""
    (data, plan), = _chunks(FS, 256, 2048, 1, 13)
    stages, banks = _fused(CONFIG3)
    fields = np.stack([getattr(plan, f) for f in nco.PLAN_FIELDS]).view(np.int32)
    rng = np.random.default_rng(14)
    carry0 = [torch.from_numpy((rng.standard_normal((2, T - 1)) * 0.3)
                               .astype(np.float32)) for _, _, T in stages]
    kw = dict(stages=stages, dot_precision=dot)
    whole, c_whole = mix_cascade_stream(torch.from_numpy(data),
                                        torch.from_numpy(fields), banks, carry0, **kw)
    carries, parts = carry0, []
    for k in range(0, 256, 64):
        o, carries = mix_cascade_stream(
            torch.from_numpy(data[k:k + 64]),
            torch.from_numpy(np.ascontiguousarray(fields[:, k:k + 64])), banks,
            carries, **kw)
        parts.append(o)
    assert torch.equal(torch.cat(parts), whole)
    assert all(torch.equal(a, b) for a, b in zip(carries, c_whole))


def test_fast_cascade_rejects_what_it_does_not_take():
    stages, banks = _fused(FRONT)
    (data, plan), = _chunks(100_000_000, 3, 2048, 1, 1)
    zero = tuple(torch.zeros(2, T - 1) for _, _, T in stages)
    args = (torch.from_numpy(data), nco.plan_tensor(plan), banks, zero)
    kw = dict(stages=stages, outtype="f32", final_dense=True)
    # three blocks at the front: 24 windows at its second stage, not 16·k
    for dot in ("split3", "default"):
        with pytest.raises(ValueError, match="16·Q"):
            mix_cascade_stream(*args, dot_precision=dot, **kw)
    mix_cascade_stream(*args, **kw)                 # the exact kernel takes it
    with pytest.raises(ValueError, match="dot_precision"):
        mix_cascade_stream(*args, dot_precision="high", **kw)
    # the channel-batched cascade has no dot_precision, as in JAX
    with pytest.raises(TypeError):
        mix_cascade_channels(args[0], args[1][:, None], banks,
                             [z[None] for z in zero], dot_precision="split3", **kw)
