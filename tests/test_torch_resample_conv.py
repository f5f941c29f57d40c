"""The port's ``'conv'`` resampler form against the JAX package's.

On the CPU the port's banded product is the JAX function in torch (R
``torch.matmul`` terms, JAX's order); XLA and MKL order each term's sum
their own way, so float32 outputs agree within 1e-5 of the signal's peak,
encoded outputs within 1 LSB in under 1% of samples.  The host ints
(``make_taps_matrix``, ``conv_stream_geometry``, ``shard_conv_alignment``)
are the JAX package's exactly.  Inside the port, streaming equals one-shot
bitwise whatever the chunk width, and a mesh of the CPU gives the
unsharded bytes.  The inputs carry no NaN: a NaN reaches every ``'conv'``
output whose window row holds it, which depends on the chunk's padding.
"""

import io

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from doppler_tpu.ops import resample as jres
from doppler_tpu.ops.resample import attach_resampler as j_attach
from doppler_tpu.parallel.sharded import shard_conv_alignment as j_shard_conv
from doppler_tpu.runtime.pipeline import ConstScheduler as JConst
from doppler_tpu.runtime.pipeline import Pipeline as JPipeline
from doppler_tpu_torch.ops import codec
from doppler_tpu_torch.ops import resample
from doppler_tpu_torch.ops.multistage import MultiStageResampler
from doppler_tpu_torch.ops.resample import RationalResampler, attach_resampler
from doppler_tpu_torch.parallel import sharded
from doppler_tpu_torch.parallel.mesh import make_mesh
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

FS = 1024000


def _signal(n, seed):
    return (np.random.default_rng(seed).standard_normal((2, n)) * 0.3
            ).astype(np.float32)


def _stream(rs, x, width, *, jax_rs=False):
    """``x`` through ``rs`` in chunks of ``width`` (the last one padded)."""
    outs, n = [], x.shape[1]
    for lo in range(0, n, width):
        v = min(width, n - lo)
        c = np.zeros((2, width), np.float32)
        c[:, :v] = x[:, lo:lo + v]
        M = rs.max_out_for(width)
        if jax_rs:
            yi, yq, k = rs.process(jnp.asarray(c[0]), jnp.asarray(c[1]), v, M)
        else:
            yi, yq, k = rs.process(torch.from_numpy(c[0]), torch.from_numpy(c[1]),
                                   v, M)
        outs.append(np.stack([np.asarray(yi)[..., :k], np.asarray(yq)[..., :k]]))
    return np.concatenate(outs, axis=-1)


def _words(y):
    return codec.iq_to_i16_words(torch.from_numpy(np.ascontiguousarray(y[0])),
                                 torch.from_numpy(np.ascontiguousarray(y[1])))


def _close(got, want):
    """float32 within 1e-5 of the peak; encoded ≤ 1 LSB in under 1%."""
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    d = (_words(got).view(torch.int16).int()
         - _words(want).view(torch.int16).int()).abs()
    assert d.max().item() <= 1 and (d > 0).float().mean().item() < 0.01


@pytest.mark.parametrize("fs,out", [(FS, 48000), (256000, 48000), (48000, 44100),
                                    (64000, 16000)])
def test_taps_matrix_equal_jax(fs, out):
    rs = RationalResampler(fs, out)
    assert np.array_equal(resample.make_taps_matrix(rs.bank, rs.P, rs.Q),
                          jres.make_taps_matrix(rs.bank, rs.P, rs.Q))


def test_conv_stream_geometry_equal_jax():
    """Every tuple equal as exact ints, over stream positions from 0 to far
    past 2^32 samples, including negative start0 (cycle rows that begin
    before the chunk's history)."""
    rng = np.random.default_rng(5)
    negative = 0
    for P, Q, T in [(3, 64, 370), (1, 8, 65), (147, 160, 321), (3, 8, 51)]:
        for _ in range(60):
            in_consumed = int(rng.integers(0, 1 << 40))
            m0 = -(-in_consumed * P // Q)
            N = int(rng.integers(1, 1 << 16))
            M = N * P // Q + 2
            got = resample.conv_stream_geometry(m0, in_consumed, M, N, P=P, Q=Q, T=T)
            want = jres.conv_stream_geometry(m0, in_consumed, M, N, P=P, Q=Q, T=T)
            assert got == want and all(type(v) is int for v in got)
            negative += got[0] < 0
    assert negative > 0


def test_shard_conv_alignment_equal_jax():
    rng = np.random.default_rng(6)
    for P, Q in [(3, 64), (147, 160), (1, 8)]:
        for n_time in (1, 2, 4, 8):
            s_abs = int(rng.integers(0, 1 << 36))
            n_loc = int(rng.integers(1, 1 << 14)) * 128
            got = sharded.shard_conv_alignment(s_abs, n_loc, n_time, P, Q)
            want = j_shard_conv(s_abs, n_loc, n_time, P, Q)
            assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
            assert got[2] == want[2]


@pytest.mark.parametrize("fs,out", [(FS, 48000), (48000, 44100)])
def test_resample_conv_stream_vs_jax(fs, out):
    """One call mid-stream (p0 ≠ 0, start0 < 0 where it falls so) on the
    same buffers: the port's plain version against JAX's function."""
    rs = RationalResampler(fs, out, impl="conv")
    P, Q, T = rs.P, rs.Q, rs.T
    N = 9000
    x = _signal(T - 1 + N, 7)
    taps = resample.make_taps_matrix(rs.bank, P, Q)
    for in_consumed in (0, 12345, 987654):
        m0 = -(-in_consumed * P // Q)
        M = N * P // Q + 2
        start0, p0, K, PADZ, TAIL = resample.conv_stream_geometry(
            m0, in_consumed, M, N, P=P, Q=Q, T=T)
        kw = dict(P=P, Q=Q, T=T, K=K, M=M, PADZ=PADZ, TAIL=TAIL)
        yi, yq = resample.resample_conv_stream(
            torch.from_numpy(x[0]), torch.from_numpy(x[1]),
            torch.from_numpy(taps), start0, p0, **kw)
        ji, jq = jres.resample_conv_stream(
            jnp.asarray(x[0]), jnp.asarray(x[1]), jnp.asarray(taps),
            jnp.int32(start0), jnp.int32(p0), **kw)
        _close(np.stack([yi.numpy(), yq.numpy()]),
               np.stack([np.asarray(ji), np.asarray(jq)]))


@pytest.mark.parametrize("fs,out", [(FS, 48000), (256000, 48000)])
def test_conv_resampler_streaming_vs_jax(fs, out):
    x = _signal(30000, 8)
    got = _stream(RationalResampler(fs, out, impl="conv"), x, 6144)
    want = _stream(jres.RationalResampler(fs, out, impl="conv"), x, 6144,
                   jax_rs=True)
    _close(got, want)


@pytest.mark.parametrize("make", [
    lambda: RationalResampler(FS, 48000, impl="conv"),
    lambda: RationalResampler(48000, 44100, impl="conv"),
    lambda: MultiStageResampler(FS, 48000, impl="conv"),
    lambda: RationalResampler(FS, 48000, impl="conv", channels=3)],
    ids=["3/64", "147/160", "cascade", "3 channels"])
def test_conv_streaming_equals_one_shot_bitwise(make):
    """The port's ``'conv'`` stream at two chunk widths (one of them a short
    EOF chunk) and in one piece: the same bits."""
    rs = make()
    x = _signal(3 * 40000 if rs.channels else 40000, 9)
    if rs.channels:
        x = x.reshape(2, 3, -1)

    def run(width):
        r = make()
        outs = []
        n = x.shape[-1]
        for lo in range(0, n, width):
            v = min(width, n - lo)
            c = np.zeros(x.shape[:-1] + (width,), np.float32)
            c[..., :v] = x[..., lo:lo + v]
            yi, yq, k = r.process(torch.from_numpy(c[0]), torch.from_numpy(c[1]),
                                  v, r.max_out_for(width))
            outs.append(torch.stack([yi[..., :k], yq[..., :k]]))
        return torch.cat(outs, dim=-1)

    one = run(x.shape[-1])
    assert one.shape[-1] > 1000
    assert torch.equal(run(16384), one) and torch.equal(run(6000), one)


def test_conv_state_dict_resumes_bitwise():
    x = _signal(20000, 10)
    whole = _stream(RationalResampler(FS, 48000, impl="conv"), x, 5000)
    a = RationalResampler(FS, 48000, impl="conv")
    first = _stream(a, x[:, :10000], 5000)
    b = RationalResampler(FS, 48000, impl="conv")
    b.load_state(a.state_dict())
    assert np.array_equal(np.concatenate([first, _stream(b, x[:, 10000:], 5000)],
                                         axis=-1), whole)


def test_impl_choices():
    assert RationalResampler(FS, 48000).impl == "window"          # 'auto'
    assert RationalResampler(FS, 48000, impl="window").impl == "window"
    assert RationalResampler(FS, 48000, impl="conv").impl == "conv"
    assert all(st.impl == "conv"
               for st in MultiStageResampler(FS, 48000, impl="conv").stages)
    with pytest.raises(ValueError, match="impl"):
        RationalResampler(FS, 48000, impl="xla")


@pytest.mark.parametrize("setting", ["allow_tf32", "high"])
def test_conv_refuses_tf32(setting):
    """The conv step raises where float32 products may use TF32, and leaves
    the setting as it found it."""
    rs = RationalResampler(FS, 48000, impl="conv")
    x = torch.zeros(4096)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        if setting == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        before = (torch.backends.cuda.matmul.allow_tf32,
                  torch.get_float32_matmul_precision())
        with pytest.raises(RuntimeError, match="TF32"):
            rs.process(x, x, 4096, rs.max_out_for(4096))
        assert (torch.backends.cuda.matmul.allow_tf32,
                torch.get_float32_matmul_precision()) == before
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def test_resample_conv_block_is_the_aligned_stream():
    rs = RationalResampler(FS, 48000)
    P, Q, T = rs.P, rs.Q, rs.T
    N = 64 * 200
    x = _signal(T - 1 + N, 11)
    taps = resample.make_taps_matrix(rs.bank, P, Q)
    yi, yq = resample.resample_conv_block(torch.from_numpy(x[0]),
                                          torch.from_numpy(x[1]),
                                          torch.from_numpy(taps), P=P, Q=Q, T=T)
    ji, jq = jres.resample_conv_block(jnp.asarray(x[0]), jnp.asarray(x[1]),
                                      jnp.asarray(taps), P=P, Q=Q, T=T)
    assert yi.shape == (N * P // Q,)
    _close(np.stack([yi.numpy(), yq.numpy()]), np.stack([np.asarray(ji),
                                                        np.asarray(jq)]))


def _capture(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-9000, 9000, size=2 * n, dtype=np.int16).tobytes()


def _port_run(raw, *, impl="pallas", resample_impl="window", mesh=None,
              stages="single", chunk_blocks=8):
    p = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                 chunk_blocks=chunk_blocks, impl=impl, device="cpu", mesh=mesh)
    attach_resampler(p, 48000, stages=stages, impl=resample_impl)
    out = io.BytesIO()
    p.run(io.BytesIO(raw), out)
    return out.getvalue()


def test_pipeline_xla_conv_vs_jax():
    """``impl='xla'`` with the ``'conv'`` resampler, the port against the
    JAX pipeline's same route: ≤ 1 LSB in under 1%."""
    raw = _capture(2048 * 8 * 3 + 1234, 12)
    got = np.frombuffer(_port_run(raw, impl="xla", resample_impl="conv"), "<i2")
    jp = JPipeline(FS, "i16", "i16", JConst(-15000.0), chunk_blocks=8, impl="xla")
    j_attach(jp, 48000, stages="single", impl="conv")
    out = io.BytesIO()
    jp.run(io.BytesIO(raw), out)
    want = np.frombuffer(out.getvalue(), "<i2")
    assert got.shape == want.shape and got.size > 0
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 0.01


@pytest.mark.parametrize("n_time", [2, 4])
def test_sharded_conv_step_equals_unsharded(n_time):
    """``--mesh`` with a ``'conv'`` resampler under ``impl='xla'``
    (``make_wideband_stream_step``'s conv branch on ``[cpu] × n``): the
    unsharded conv bytes, full chunks and the EOF chunk."""
    raw = _capture(2048 * 8 * 3 + 999, 13)
    want = _port_run(raw, impl="xla", resample_impl="conv")
    mesh = make_mesh(time=n_time, device="cpu")
    assert _port_run(raw, impl="xla", resample_impl="conv", mesh=mesh) == want


def test_sharded_conv_step_channels_equals_unsharded():
    """The step itself at C = 2 over time=2 × channel=2: each channel's
    outputs are the batched resampler's on the mixer's planes."""
    from doppler_tpu_torch.ops.cuda import mixer
    from doppler_tpu_torch.ops.nco import plan_tensor
    from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks

    B, L, C = 8, 2048, 2
    rng = np.random.default_rng(14)
    data = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                                         dtype=np.int64).astype(np.int32))
    plans = torch.stack([plan_tensor(plan_blocks([s] * B, [L] * B, FS,
                                                 NCOState(), L))
                         for s in (-15000.0, 7000.0)], dim=1)
    rs = RationalResampler(FS, 48000, impl="conv", channels=C)
    want_rs = RationalResampler(FS, 48000, impl="conv", channels=C)
    mixed = mixer.mix_blocks_fmt_channels(data, plans, intype="i16",
                                          outtype="f32").reshape(2, C, -1)
    wi, wq, n = want_rs.process(mixed[0], mixed[1], B * L,
                                want_rs.max_out_for(B * L))
    step = sharded.make_wideband_stream_step(
        make_mesh(time=2, channel=2, device="cpu"), intype="i16", outtype="f32",
        C=C, resampler=rs)
    a1, a2, counts = sharded.stream_step_alignment(rs, 0, B * L // 2, 2)
    parts, _, _ = step(data, plans, rs._hist_i, rs._hist_q, a1, a2, counts)
    got = torch.zeros(2, C, n)
    for cs, bs, out in parts:
        t = bs.start // (bs.stop - bs.start)
        lo = sum(counts[:t])
        got[:, cs, lo:lo + counts[t]] = out.reshape(2, cs.stop - cs.start, -1)
    assert sum(counts) == n
    assert torch.equal(got, torch.stack([wi[:, :n], wq[:, :n]]))
