"""``--precision fast`` on the CPU: the port's ``split3`` function against
the JAX package's.

- The operand split (``ops.precision``) is bitwise
  ``doppler_tpu/ops/pallas/chain.py``'s ``_split_bf16_exact`` and
  ``split3_taps``, edges included, but for the sign of a zero low half
  where ``v − h`` is subnormal (XLA on the CPU flushes it to +0).
- The split3 plain chain (stream and channel-batched) against
  ``mix_resample_chain_pallas_*(dot_precision="split3", interpret=True)``:
  i16 within 1 LSB in under 1% of samples, float32 within 1e-5 of the
  largest output (the two sum the exact products in other orders); against
  the port's exact plain chain: ≤ 1 LSB and ≥ 80 dB, float32 within 3e-5
  (the JAX tests' own bounds, ``tests/test_pallas_chain.py``).  Its carries
  are bitwise the exact ones: the carry is the mixed history.
- ``dot_precision="default"`` (one bf16 pass, ``x_h·t_h``) against its
  stated reference, the float64 sum of those products (JAX on the CPU
  computes a DEFAULT dot in float32 and is no reference for it), and
  ≥ 45 dB from the exact chain.
- The pipelines and the CLI with ``precision="fast"`` against the JAX
  pipelines (``impl="pallas"``, interpret mode), and byte-identical to
  ``"exact"`` on the cascade route, which 'fast' leaves exact.

The fast CUDA kernel against this plain version is in
``test_torch_cuda.py``; its device functions on the CPU in
``test_torch_kernel_geometry.py``.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from doppler_tpu.ops.pallas.chain import (
    _split_bf16_exact,
    carry_rows,
    make_chain_taps,
    mix_resample_chain_pallas_channels,
    mix_resample_chain_pallas_stream,
    split3_taps,
)
from doppler_tpu.ops.resample import RationalResampler as JRationalResampler
from doppler_tpu.runtime.channels import ChannelSpec as JChannelSpec
from doppler_tpu.runtime.channels import MultiChannelPipeline as JMultiChannelPipeline
from doppler_tpu.runtime.pipeline import ConstScheduler as JConstScheduler
from doppler_tpu.runtime.pipeline import Pipeline as JPipeline
from doppler_tpu_torch import cli
from doppler_tpu_torch.ops import nco
from doppler_tpu_torch.ops.cuda.chain import (
    mix_resample_chain_channels,
    mix_resample_chain_plain,
    mix_resample_chain_stream,
)
from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt_plain
from doppler_tpu_torch.ops.filters import design_polyphase_bank
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks
from doppler_tpu_torch.ops.precision import split3_bank, split_bf16_exact
from doppler_tpu_torch.ops.resample import attach_resampler
from doppler_tpu_torch.runtime.channels import ChannelSpec, MultiChannelPipeline
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

FS = 1024000
P, Q = 3, 64                       # config 3: 1.024 Msps → 48 ksps
BANK = design_polyphase_bank(P, Q)
T = BANK.shape[1]
L = 4096


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def _edges():
    tiny = np.float32(np.finfo(np.float32).tiny)
    ties = (np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x40418000,
                      0x00008000, 0x00018000], np.uint32).view(np.float32))
    return np.concatenate([
        np.array([0.0, -0.0, tiny, -tiny, tiny / 2, 1e-45, -1e-45, 3e-39,
                  1.0, -1.0, 3e38, -3e38, 3.4e38, 1e30, -7.5e-20],
                 np.float32), ties])


def test_split_is_bitwise_the_jax_split():
    rng = np.random.default_rng(1)
    v = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        (rng.standard_normal(1024) * 1e-3).astype(np.float32),
        (rng.standard_normal(1024) * 1e6).astype(np.float32),
        _edges()])
    h, l = split_bf16_exact(torch.from_numpy(v))
    jh, jl = _split_bf16_exact(jnp.asarray(v))
    assert np.array_equal(_bits(h.numpy()), _bits(np.asarray(jh)))
    # XLA on the CPU flushes a subnormal v − h to +0 before the rounding;
    # the port (and the card) subtract as IEEE, and bf16 then rounds such a
    # difference to a zero of its sign: the same value, maybe not the sign
    diff = v.astype(np.float64) - h.numpy().astype(np.float64)
    flushed = (diff != 0) & (np.abs(diff) < np.finfo(np.float32).tiny)
    assert flushed.sum() >= 3
    assert np.array_equal(_bits(l.numpy())[~flushed], _bits(np.asarray(jl))[~flushed])
    assert (l.numpy()[flushed] == 0).all() and (np.asarray(jl)[flushed] == 0).all()
    # the halves are bf16-exact and their sum is within 2^-17 of v (finite)
    assert (_bits(h.numpy()) & 0xFFFF == 0).all() and (_bits(l.numpy()) & 0xFFFF == 0).all()
    fin = np.isfinite(h.numpy()) & (np.abs(v) > 1e-30)
    err = np.abs(v[fin].astype(np.float64) - h.numpy()[fin] - l.numpy()[fin])
    assert (err <= 2.0 ** -17 * np.abs(v[fin])).all()

    t_h, t_l = split3_bank(torch.from_numpy(BANK))
    want = np.asarray(split3_taps(jnp.asarray(BANK)))
    assert np.array_equal(_bits(np.concatenate([t_h.numpy(), t_l.numpy()])),
                          _bits(want))


def _chunks(B, n_chunks, seed, intype="i16", channels=None):
    """Consecutive chunks of one stream: data and plan words ``(7, B)``, or
    ``(7, C, B)`` with ``channels=C`` (every channel its own shifts)."""
    rng = np.random.default_rng(seed)
    states = [NCOState(samplenum=11 * c) for c in range(channels or 1)]
    out = []
    for k in range(n_chunks):
        fields = np.stack([
            np.stack([getattr(plan_blocks(
                [9000.0 - 3.0 * b + 321.0 * c for b in range(B)],
                [L] * B, FS, states[c], L), f) for f in nco.PLAN_FIELDS])
            for c in range(channels or 1)], axis=1)          # (7, C, B)
        if intype == "i16":
            data = rng.integers(-(1 << 31), 1 << 31, size=(B, L),
                                dtype=np.int64).astype(np.int32)
        else:
            data = (rng.standard_normal((2, B, L)) * 0.4).astype(np.float32)
        out.append((data, fields if channels else fields[:, 0]))
    return out


def _i16(a):
    return np.asarray(a).reshape(-1).view(np.int16).astype(np.int32)


def _assert_lsb_frac(got, want):
    d = np.abs(_i16(got) - _i16(want))
    assert d.max() <= 1 and np.mean(d > 0) < 0.01, (d.max(), np.mean(d > 0))


def _assert_vs_exact(fast, exact, outtype):
    """The JAX tests' bounds of split3 against the exact dot."""
    if outtype == "i16":
        g, w = _i16(fast), _i16(exact)
        assert np.abs(g - w).max() <= 1
        err, sig = (g - w) / 32768.0, w / 32768.0
        snr = 10 * np.log10((sig ** 2).mean() / max((err ** 2).mean(), 1e-30))
        assert snr > 80.0, snr
    else:
        fast, exact = np.asarray(fast), np.asarray(exact)
        assert np.abs(fast - exact).max() / np.abs(exact).max() < 3e-5


@pytest.mark.parametrize("intype,outtype", [("i16", "i16"), ("f32", "f32")])
def test_split3_plain_matches_jax_pallas_stream(intype, outtype):
    """B = 8 blocks of L = 4096; the compared chunk starts from the carry of
    a previous one."""
    chunks = _chunks(8, 2, 5, intype)
    taps = make_chain_taps(BANK, P, Q)
    jc = jnp.zeros((2, carry_rows(T), 128), jnp.float32)
    bank = torch.from_numpy(BANK)
    carry = c_exact = torch.zeros(2, T - 1)
    kw = dict(P=P, Q=Q, T=T, intype=intype, outtype=outtype)
    for data, fields in chunks:
        want, jc = mix_resample_chain_pallas_stream(
            jnp.asarray(data), *fields, taps, jc, interpret=True,
            dot_precision="split3", **kw)
        x, p = torch.from_numpy(data), torch.from_numpy(fields.view(np.int32))
        exact, c_exact = mix_resample_chain_plain(x, p, bank, c_exact, **kw)
        got, carry = mix_resample_chain_stream(x, p, bank, carry,
                                               dot_precision="split3", **kw)
        want = np.asarray(want)
        assert got.shape == want.shape == exact.shape
        if outtype == "i16":
            _assert_lsb_frac(got.numpy(), want)
        else:
            assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5
        _assert_vs_exact(got.numpy(), exact.numpy(), outtype)
        assert torch.equal(carry, c_exact)
    j_tail = np.asarray(jc).reshape(2, -1)[:, -(T - 1):]
    assert np.abs(carry.numpy() - j_tail).max() <= 2.0 ** -20


def test_split3_plain_channels_matches_jax_pallas_channels():
    C, B = 3, 4
    chunks = _chunks(B, 2, 21, channels=C)
    taps = make_chain_taps(BANK, P, Q)
    jc = jnp.zeros((C, 2, carry_rows(T), 128), jnp.float32)
    bank = torch.from_numpy(BANK)
    carries = c_exact = torch.zeros(C, 2, T - 1)
    kw = dict(P=P, Q=Q, T=T)
    for data, fields in chunks:
        want, jc = mix_resample_chain_pallas_channels(
            jnp.asarray(data), jnp.asarray(fields), taps, jc, interpret=True,
            dot_precision="split3", **kw)
        x, p = torch.from_numpy(data), torch.from_numpy(fields.view(np.int32))
        exact, c_exact = mix_resample_chain_channels(x, p, bank, c_exact, **kw)
        got, c_got = mix_resample_chain_channels(
            x, p, bank, carries, dot_precision="split3", **kw)
        assert got.shape == np.asarray(want).shape == (C, B, L * P // Q)
        _assert_lsb_frac(got.numpy(), want)
        _assert_vs_exact(got.numpy(), exact.numpy(), "i16")
        assert torch.equal(c_got, c_exact)
        # channel c is the stream call with its plan words and carry
        one, c_one = mix_resample_chain_stream(x, p[:, 1], bank, carries[1],
                                               dot_precision="split3", **kw)
        assert torch.equal(got[1], one) and torch.equal(c_got[1], c_one)
        carries = c_got
    j_tail = np.asarray(jc).reshape(C, 2, -1)[:, :, -(T - 1):]
    assert np.abs(carries.numpy() - j_tail).max() <= 2.0 ** -20


def test_split3_plain_bitwise_invariant_to_chunk_split():
    """256 blocks of 2048 samples against 4 × 64 blocks, from a carry."""
    rng = np.random.default_rng(13)
    B, Lb = 256, 2048
    data = rng.integers(-(1 << 31), 1 << 31, size=(B, Lb),
                        dtype=np.int64).astype(np.int32)
    plan = plan_blocks([4242.0] * B, [Lb] * B, FS, NCOState(), Lb)
    fields = np.stack([getattr(plan, f) for f in nco.PLAN_FIELDS]).view(np.int32)
    bank = torch.from_numpy(BANK)
    carry0 = torch.from_numpy(
        (rng.standard_normal((2, T - 1)) * 0.3).astype(np.float32))
    kw = dict(P=P, Q=Q, T=T, dot_precision="split3")
    whole, c_whole = mix_resample_chain_stream(
        torch.from_numpy(data), torch.from_numpy(fields), bank, carry0, **kw)
    carry, parts = carry0, []
    for k in range(0, B, 64):
        o, carry = mix_resample_chain_stream(
            torch.from_numpy(data[k:k + 64]),
            torch.from_numpy(np.ascontiguousarray(fields[:, k:k + 64])),
            bank, carry, **kw)
        parts.append(o)
    assert torch.equal(torch.cat(parts), whole) and torch.equal(carry, c_whole)


def test_fast_rejects_an_unknown_dot_precision():
    (data, fields), = _chunks(2, 1, 1)
    with pytest.raises(ValueError, match="dot_precision"):
        mix_resample_chain_stream(torch.from_numpy(data),
                                  torch.from_numpy(fields.view(np.int32)),
                                  torch.from_numpy(BANK), torch.zeros(2, T - 1),
                                  P=P, Q=Q, T=T, dot_precision="high")
    with pytest.raises(ValueError, match="precision must be 'exact' or 'fast'"):
        Pipeline(FS, "i16", "i16", ConstScheduler(0.0), precision="bf16",
                 device="cpu")
    with pytest.raises(ValueError, match="precision must be 'exact' or 'fast'"):
        MultiChannelPipeline(FS, "i16", "i16",
                             [ChannelSpec("a", ConstScheduler(0.0))],
                             precision="bf16", device="cpu")


def test_default_plain_chain_is_one_bf16_pass():
    """``dot_precision="default"``: JAX on the CPU computes a DEFAULT dot in
    float32, so its reference is what that dot is on the TPU, one bf16 pass
    of the split operands: the float64 sum of ``x_h·t_h``, within 2^-22 of
    the largest output; ≥ 45 dB from the exact chain; the carry bitwise."""
    (data, fields), = _chunks(8, 1, 17)
    x, p = torch.from_numpy(data), torch.from_numpy(fields.view(np.int32))
    bank = torch.from_numpy(BANK)
    rng = np.random.default_rng(18)
    carry = torch.from_numpy((rng.standard_normal((2, T - 1)) * 0.3).astype(np.float32))
    kw = dict(P=P, Q=Q, T=T)
    got, c_got = mix_resample_chain_stream(x, p, bank, carry, outtype="f32",
                                           dot_precision="default", **kw)
    mixed = mix_blocks_fmt_plain(x, p, intype="i16", outtype="f32").reshape(2, -1)
    buf_h = split_bf16_exact(torch.cat([carry, mixed], dim=1))[0].double().numpy()
    t_h = split_bf16_exact(torch.from_numpy(BANK))[0].double().numpy()
    m = np.arange(got.shape[-1] * got.shape[-2])
    idx = (m * Q // P + T - 1)[:, None] - np.arange(T)[None, :]
    want = np.stack([(buf_h[c][idx] * t_h[(m * Q) % P]).sum(axis=1) for c in range(2)])
    assert np.abs(got.reshape(2, -1).double().numpy() - want).max() <= (
        2.0 ** -22 * np.abs(want).max())
    words, _ = mix_resample_chain_stream(x, p, bank, carry,
                                         dot_precision="default", **kw)
    exact, c_exact = mix_resample_chain_stream(x, p, bank, carry, **kw)
    assert torch.equal(c_got, c_exact)
    w = _i16(exact.numpy()).astype(np.float64)
    d = _i16(words.numpy()) - w
    assert 10 * np.log10((w ** 2).sum() / (d ** 2).sum()) >= 45.0


# -- the pipelines and the CLI ------------------------------------------------

def _stream(n, seed):
    """In-band tones plus noise as LE i16 IQ bytes."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = (0.3 * np.exp(2j * np.pi * 3000.0 / FS * k)
         + 0.2 * np.exp(-2j * np.pi * 7000.0 / FS * k + 1.0)
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    ix = np.empty(2 * n, dtype="<i2")
    ix[0::2] = np.trunc(x.real * 32767)
    ix[1::2] = np.trunc(x.imag * 32767)
    return ix.tobytes()


def _run(pipe, data):
    out = io.BytesIO()
    pipe.run(io.BytesIO(data), out)
    return out.getvalue()


def _port(precision, stages="single"):
    pipe = Pipeline(FS, "i16", "i16", ConstScheduler(-9000.0), chunk_blocks=4,
                    precision=precision, device="cpu")
    attach_resampler(pipe, 48000, stages=stages)
    return pipe


DATA = _stream(2048 * 4 * 3 + 777, 7)      # three full chunks and an EOF chunk


def test_pipeline_fast_matches_jax_pallas_fast():
    jpipe = JPipeline(FS, "i16", "i16", JConstScheduler(-9000.0), chunk_blocks=4,
                      impl="pallas", pallas_interpret=True, precision="fast")
    jpipe.set_resampler(JRationalResampler(FS, 48000))
    want = _run(jpipe, DATA)
    got = _run(_port("fast"), DATA)
    assert len(got) == len(want) > 0
    _assert_lsb_frac(np.frombuffer(got, "<i4"), np.frombuffer(want, "<i4"))
    exact = _run(_port("exact"), DATA)
    assert got != exact
    _assert_vs_exact(np.frombuffer(got, "<i4"), np.frombuffer(exact, "<i4"), "i16")


def test_pipeline_fast_on_the_cascade_route_is_exact():
    assert _run(_port("fast", "auto"), DATA) == _run(_port("exact", "auto"), DATA)


def _stream_f32(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(2 * n) * 0.3).astype("<f4")
    return x.tobytes()


# f32 input: 8192-byte blocks of 1024 samples, 3 a chunk (48 windows of
# Q = 64, not a multiple of 32); two full chunks and an EOF chunk
DATA_F32 = _stream_f32(1024 * 3 * 2 + 555, 9)


@pytest.mark.parametrize("kind", ["stream", "channels"])
def test_fast_route_takes_f32_chunks_of_an_odd_block_count(monkeypatch, kind):
    """f32 input at an odd ``chunk_blocks`` (``--chunk-blocks``, or the
    realtime chunk): every full chunk takes the fused split3 chain, as the
    JAX pipeline's route does, and the stream's bytes are the JAX
    pipeline's within 1 LSB."""
    from doppler_tpu_torch.ops.cuda import chain

    name = f"mix_resample_chain_{kind}"
    real, calls = getattr(chain, name), []

    def spy(*args, **kw):
        calls.append(kw["dot_precision"])
        return real(*args, **kw)

    monkeypatch.setattr(chain, name, spy)
    if kind == "stream":
        pipe = Pipeline(FS, "f32", "i16", ConstScheduler(-9000.0), chunk_blocks=3,
                        precision="fast", device="cpu")
        attach_resampler(pipe, 48000, stages="single")
        got = _run(pipe, DATA_F32)
        jpipe = JPipeline(FS, "f32", "i16", JConstScheduler(-9000.0), chunk_blocks=3,
                          impl="pallas", pallas_interpret=True, precision="fast")
        jpipe.set_resampler(JRationalResampler(FS, 48000))
        want = _run(jpipe, DATA_F32)
        assert len(got) == len(want) > 0
        _assert_lsb_frac(np.frombuffer(got, "<i4"), np.frombuffer(want, "<i4"))
    else:
        specs = [ChannelSpec(f"c{k}", ConstScheduler(s), center_offset_hz=c)
                 for k, (s, c) in enumerate(CHANNELS)]
        mp = MultiChannelPipeline(FS, "f32", "i16", specs, out_rate=48000,
                                  chunk_blocks=3, resample_stages="single",
                                  precision="fast", device="cpu")
        assert all(len(o) > 0 for o in _run_channels(mp, DATA_F32))
    assert calls == ["split3", "split3"]


CHANNELS = ((-9000.0, 0.0), (4000.0, -20000.0), (-1500.5, 30000.0))


def _channels(precision, stages="single", jax=False):
    if jax:
        specs = [JChannelSpec(f"c{k}", JConstScheduler(s), center_offset_hz=c)
                 for k, (s, c) in enumerate(CHANNELS)]
        return JMultiChannelPipeline(FS, "i16", "i16", specs, out_rate=48000,
                                     chunk_blocks=4, resample_stages=stages,
                                     impl="pallas", pallas_interpret=True,
                                     precision=precision)
    specs = [ChannelSpec(f"c{k}", ConstScheduler(s), center_offset_hz=c)
             for k, (s, c) in enumerate(CHANNELS)]
    return MultiChannelPipeline(FS, "i16", "i16", specs, out_rate=48000,
                                chunk_blocks=4, resample_stages=stages,
                                precision=precision, device="cpu")


def _run_channels(mp, data):
    outs = [io.BytesIO() for _ in mp.channels]
    mp.run(io.BytesIO(data), outs)
    return [o.getvalue() for o in outs]


def test_channels_fast_matches_jax_pallas_fast():
    want = _run_channels(_channels("fast", jax=True), DATA)
    got = _run_channels(_channels("fast"), DATA)
    exact = _run_channels(_channels("exact"), DATA)
    for g, w, e in zip(got, want, exact):
        assert len(g) == len(w) > 0
        _assert_lsb_frac(np.frombuffer(g, "<i4"), np.frombuffer(w, "<i4"))
        _assert_vs_exact(np.frombuffer(g, "<i4"), np.frombuffer(e, "<i4"), "i16")
    assert got != exact


def test_channels_fast_on_the_cascade_route_is_exact():
    assert (_run_channels(_channels("fast", "multi"), DATA)
            == _run_channels(_channels("exact", "multi"), DATA))


def _cli(extra, data, **files):
    out = io.BytesIO()
    rc = cli.main(["const", "-s", str(FS), "-i", "i16", "--shift", "-9000",
                   "--resample-to", "48000", "--resample-stages", "single",
                   "--chunk-blocks", "4", "--device", "cpu",
                   "--log-level", "error"] + extra,
                  stdin=io.BytesIO(data), stdout=out)
    return rc, out.getvalue()


def test_cli_precision_fast_and_resume(tmp_path):
    rc, got = _cli(["--precision", "fast"], DATA)
    assert rc == 0 and got == _run(_port("fast"), DATA)
    assert _cli(["--precision", "bogus"], DATA)[0] == 2
    # a --save-state cut after two chunks, then --load-state: the bytes of
    # the uninterrupted run
    src, out, ck = tmp_path / "in.iq", tmp_path / "out.iq", tmp_path / "ck.npz"
    cut = 2048 * 4 * 4 * 2
    src.write_bytes(DATA[:cut])
    io_args = ["--precision", "fast", "--output", str(out), "--input", str(src)]
    assert _cli(io_args + ["--save-state", str(ck)], b"")[0] == 0
    src.write_bytes(DATA)
    assert _cli(io_args + ["--load-state", str(ck)], b"")[0] == 0
    assert out.read_bytes() == got


TLE = ("1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8",
       "2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105")


@pytest.mark.parametrize("mode", ["track", "channels"])
def test_cli_track_and_channels_take_precision_fast(tmp_path, mode):
    """``track`` and ``channels`` with ``--precision fast`` are the
    pipelines with ``precision="fast"``, and not the exact bytes."""
    from doppler_tpu_torch.orbit.tle import _checksum

    src = tmp_path / "in.iq"
    src.write_bytes(DATA)
    if mode == "track":
        lines = [ln.ljust(68)[:68] for ln in TLE]
        (tmp_path / "sat.txt").write_text(
            "TEST SAT\n" + "\n".join(ln + str(_checksum(ln)) for ln in lines) + "\n")
        argv = ["track", "--tlefile", str(tmp_path / "sat.txt"), "--tlename",
                "TEST SAT", "--location", "lat=58.26541,lon=26.46667,alt=76",
                "--frequency", "437505000", "--time", "1980-10-02T23:41:24"]
        outs = lambda d: [(tmp_path / d / "o.iq").read_bytes()]      # noqa: E731
    else:
        (tmp_path / "ch.json").write_text(
            '{"channels": [{"name": "a", "shift": -9000}, '
            '{"name": "b", "shift": 4000, "center_offset": -20000}]}')
        argv = ["channels", "--config", str(tmp_path / "ch.json")]
        outs = lambda d: [(tmp_path / d / f"{n}.iq").read_bytes()   # noqa: E731
                          for n in "ab"]
    got = {}
    for prec in ("exact", "fast"):
        (tmp_path / prec).mkdir()
        dest = (["--output", str(tmp_path / prec / "o.iq")] if mode == "track"
                else ["--output-dir", str(tmp_path / prec)])
        assert cli.main(argv + ["-s", str(FS), "-i", "i16", "--resample-to",
                                "48000", "--resample-stages", "single",
                                "--chunk-blocks", "4", "--precision", prec,
                                "--device", "cpu", "--log-level", "error",
                                "--input", str(src)] + dest) == 0
        got[prec] = outs(prec)
    for f, e in zip(got["fast"], got["exact"]):
        assert len(f) == len(e) > 0 and f != e
        _assert_vs_exact(np.frombuffer(f, "<i4"), np.frombuffer(e, "<i4"), "i16")
    if mode == "channels":
        assert got["fast"] == _run_channels(
            MultiChannelPipeline(FS, "i16", "i16",
                                 [ChannelSpec("a", ConstScheduler(-9000.0)),
                                  ChannelSpec("b", ConstScheduler(4000.0),
                                              center_offset_hz=-20000.0)],
                                 out_rate=48000, chunk_blocks=4,
                                 precision="fast", device="cpu"), DATA)
