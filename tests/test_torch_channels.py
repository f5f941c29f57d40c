"""Channels mode on the CPU: the port's ``MultiChannelPipeline`` and
``channels`` subcommand against the JAX package (``impl='pallas'`` in
interpret mode and ``impl='xla'``), the port's single-stream ``Pipeline``
and the golden model.

Tolerances: against the JAX package encoded bytes have equal lengths and
differ by at most 1 LSB in under 1% of samples (XLA's FMA contraction and
matmul sum order against the port's separate roundings and fixed tree),
float32 outputs by at most 2^-20; above 70 dB against the golden (the
reference's sequential mix, then a float64 polyphase dot per stage with the
same banks).  Inside the port every channel is bitwise the single-stream
pipeline run with the composed shift f32(shift) + f32(center), whatever
the chunk width and the route.
"""

import io
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from doppler_tpu.ops.pallas import chain as j_chain
from doppler_tpu.runtime.channels import ChannelSpec as JChannelSpec
from doppler_tpu.runtime.channels import MultiChannelPipeline as JMultiChannelPipeline
from doppler_tpu.runtime.channels import load_channel_config as j_load_channel_config
from doppler_tpu.runtime.pipeline import ConstScheduler as JConstScheduler
from doppler_tpu_torch import cli, oracle
from doppler_tpu_torch.ops.cuda import cascade, chain, mixer
from doppler_tpu_torch.ops.multistage import make_resampler
from doppler_tpu_torch.ops.resample import attach_resampler
from doppler_tpu_torch.orbit.tle import _checksum
from doppler_tpu_torch.runtime.channels import (
    ChannelSpec,
    MultiChannelPipeline,
    load_channel_config,
)
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

REPO = Path(__file__).resolve().parents[1]
FS = 1024000
# (shift, center offset): channel "a" composes to −15000 Hz
CHANNELS = [(-20000.0, 5000.0), (0.0, 0.0), (120000.5, -250.0)]


def _fix(line):
    line = line.ljust(68)[:68]
    return line + str(_checksum(line))


TLE_L1 = _fix("1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8")
TLE_L2 = _fix("2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105")


def _tones(n, fs, seed, centers=(3000.0, -7000.0)):
    """Tones near the given frequencies plus a little noise, as LE i16 IQ
    bytes (white noise alone would floor the i16 SNR after heavy
    decimation)."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for j, f in enumerate(centers):
        x = x + 0.25 * np.exp(2j * np.pi * f / fs * k + 1j * j)
    ix = np.empty(2 * n, dtype="<i2")
    ix[0::2] = np.trunc(x.real * 32767)
    ix[1::2] = np.trunc(x.imag * 32767)
    return ix.tobytes()


def _f32_stream(n, seed):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal(2 * n)).astype("<f4").tobytes()


def _specs(jax=False, rates=None, channels=CHANNELS):
    spec, sched = (JChannelSpec, JConstScheduler) if jax else (ChannelSpec, ConstScheduler)
    rates = rates or [None] * len(channels)
    return [spec(f"c{k}", sched(s), center_offset_hz=c, out_rate=r)
            for k, ((s, c), r) in enumerate(zip(channels, rates))]


def _run(mp, data):
    outs = [io.BytesIO() for _ in mp.channels]
    mp.run(io.BytesIO(data), outs)
    return [o.getvalue() for o in outs]


def _port(fs, *, intype="i16", outtype="i16", out_rate=48000, stages="single",
          chunk_blocks=16, rates=None, drain=False, channels=CHANNELS):
    return MultiChannelPipeline(fs, intype, outtype,
                                _specs(rates=rates, channels=channels),
                                out_rate=out_rate, chunk_blocks=chunk_blocks,
                                resample_stages=stages, drain_on_eof=drain,
                                device="cpu")


def _jax(fs, impl, *, intype="i16", outtype="i16", out_rate=48000,
         stages="single", chunk_blocks=16, rates=None, drain=False):
    return JMultiChannelPipeline(fs, intype, outtype, _specs(True, rates),
                                 out_rate=out_rate, chunk_blocks=chunk_blocks,
                                 resample_stages=stages, drain_on_eof=drain,
                                 impl=impl, pallas_interpret=impl == "pallas")


def _single(fs, shift, center, data, *, intype="i16", outtype="i16",
            out_rate=48000, stages="single", chunk_blocks=16, drain=False):
    """The port's single-stream pipeline at the composed shift."""
    composed = float(np.float32(shift) + np.float32(center))
    pipe = Pipeline(fs, intype, outtype, ConstScheduler(composed),
                    chunk_blocks=chunk_blocks, drain_on_eof=drain, device="cpu")
    if out_rate is not None:
        attach_resampler(pipe, out_rate, stages=stages)
    out = io.BytesIO()
    pipe.run(io.BytesIO(data), out)
    return out.getvalue()


def _assert_close(got: bytes, want: bytes, outtype="i16"):
    assert len(got) == len(want) > 0
    if outtype == "i16":
        d = np.abs(np.frombuffer(got, "<i2").astype(np.int32)
                   - np.frombuffer(want, "<i2").astype(np.int32))
        assert d.max() <= 1 and np.mean(d > 0) < 0.01, (d.max(), np.mean(d > 0))
    else:
        d = np.abs(np.frombuffer(got, "<f4") - np.frombuffer(want, "<f4"))
        assert d.max() <= 2.0 ** -20, d.max()


def _golden(data, fs, shift, center, stages_of):
    """Sequential reference mix at the composed shift (blocks of 2048), then
    the oracle's polyphase dot over each stage's bank, then the i16 round
    trip."""
    x = oracle.decode_i16_bytes(data)
    composed = float(np.float32(shift) + np.float32(center))
    mixed = np.empty_like(x)
    sn = 0
    for pos in range(0, len(x), 2048):
        mixed[pos:pos + 2048], sn = oracle.shift_frequency_oracle(
            x[pos:pos + 2048], sn, composed, fs)
    y = mixed
    for st in stages_of:
        y = oracle.resample_oracle(y, st.P, st.Q, st.bank)
    return oracle.decode_i16_bytes(oracle.encode_i16_bytes(y.astype(np.complex64)))


# -- the slice against the JAX package --------------------------------------

# (fs, --resample-stages, fused kernel the port's full chunks run)
ROUTES = [
    (FS, "single", "chain"),        # uniform single-stage
    (FS, "multi", "cascade"),       # uniform cascade, fully fused
    (250000, "multi", "cascade"),   # odd-Q split: ÷2 front fused, 24/125 tail
]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("fs,stages,kernel", ROUTES)
def test_uniform_routes_vs_jax(fs, stages, kernel, impl, monkeypatch):
    """Three channels at one rate: full chunks through the channel-batched
    kernel's plain version, the partial EOF chunk through mixer + batched
    resampler; equal lengths and ≤ 1 LSB against the JAX channels run."""
    calls = {"chain": 0, "cascade": 0, "mixer": 0}
    for name, mod, fn in (("chain", chain, "mix_resample_chain_channels"),
                          ("cascade", cascade, "mix_cascade_channels"),
                          ("mixer", mixer, "mix_blocks_fmt_channels")):
        real = getattr(mod, fn)

        def counting(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, fn, counting)
    n = 2048 * 16 * 2 + 1000
    data = _tones(n, fs, 3)
    mp = _port(fs, stages=stages)
    got = _run(mp, data)
    other = "cascade" if kernel == "chain" else "chain"
    assert calls == {kernel: 2, other: 0, "mixer": 1}
    assert mp.samples_in == n
    want = _run(_jax(fs, impl, stages=stages), data)
    for g, w in zip(got, want):
        assert len(g) // 4 == make_resampler(fs, 48000, stages=stages).out_count_for(n)
        _assert_close(g, w)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_mixed_rates_with_an_unresampled_channel_vs_jax(impl):
    """Three rate groups (48 k, none, 128 k): never fused, each group its own
    batched resampler, in both packages."""
    rates = [48000.0, None, 128000.0]
    data = _tones(2048 * 16 * 2 + 500, FS, 4)
    mp = _port(FS, out_rate=None, rates=rates)
    got = _run(mp, data)
    assert not mp._uniform and mp.resampler is None
    assert not mp._chain_eligible(16 * 2048) and not mp._cascade_eligible(16 * 2048)
    want = _run(_jax(FS, impl, out_rate=None, rates=rates), data)
    for g, w in zip(got, want):
        _assert_close(g, w)
    assert len(got[1]) == len(data)            # the unresampled channel


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("stages", ["single", "multi"])
def test_f32_wire_formats_vs_jax(stages, impl):
    """f32 in, f32 out (blocks of 1024 samples) on the fused routes."""
    data = _f32_stream(1024 * 16 * 2 + 300, 5)
    got = _run(_port(FS, intype="f32", outtype="f32", stages=stages), data)
    want = _run(_jax(FS, impl, intype="f32", outtype="f32", stages=stages), data)
    for g, w in zip(got, want):
        _assert_close(g, w, "f32")


@pytest.mark.parametrize("stages", ["single", "multi"])
def test_mixed_wire_formats_vs_jax(stages):
    """i16 in, f32 out and f32 in, i16 out against the XLA channels run."""
    for intype, outtype, data in (("i16", "f32", _tones(2048 * 16 + 300, FS, 6)),
                                  ("f32", "i16", _f32_stream(1024 * 16 + 300, 6))):
        got = _run(_port(FS, intype=intype, outtype=outtype, stages=stages), data)
        want = _run(_jax(FS, "xla", intype=intype, outtype=outtype,
                         stages=stages), data)
        for g, w in zip(got, want):
            _assert_close(g, w, outtype)


@pytest.mark.parametrize("stages", ["single", "multi"])
def test_drain_vs_jax_and_single_pipeline(stages):
    """--drain flushes each channel's FIR tail as the single-stream pipeline
    does, after the fused chunks mirrored their carries into the histories."""
    data = _tones(2048 * 16 * 2 + 777, FS, 7)
    mp = _port(FS, stages=stages, drain=True)
    got = _run(mp, data)
    assert mp._drained and mp._chain_carry is None and mp._cascade_carries is None
    plain = _run(_port(FS, stages=stages), data)
    want = _run(_jax(FS, "pallas", stages=stages, drain=True), data)
    for g, p, w, (s, c) in zip(got, plain, want, CHANNELS):
        assert len(g) > len(p) and g[:len(p)] == p
        _assert_close(g, w)
        assert g == _single(FS, s, c, data, stages=stages, drain=True)


# -- inside the port ----------------------------------------------------------

@pytest.mark.parametrize("fs,stages,out_rate", [
    (FS, "single", 48000), (FS, "multi", 48000), (250000, "multi", 48000),
    (FS, "single", None)])
def test_each_channel_is_the_single_stream_pipeline_bitwise(fs, stages, out_rate):
    """Channel c = ``Pipeline`` at f32(shift) + f32(center), bit for bit, and
    the bytes do not depend on the chunk width (16, 8 and 5 blocks: at 5 the
    chunk boundaries fall elsewhere and more chunks take each route)."""
    data = _tones(2048 * 16 * 2 + 900, fs, 8)
    got = _run(_port(fs, stages=stages, out_rate=out_rate), data)
    for g, (s, c) in zip(got, CHANNELS):
        assert g == _single(fs, s, c, data, stages=stages, out_rate=out_rate)
    for chunk_blocks in (8, 5):
        assert _run(_port(fs, stages=stages, out_rate=out_rate,
                          chunk_blocks=chunk_blocks), data) == got


def test_fused_and_unfused_routes_give_the_same_bytes():
    """Every chunk through mixer + batched resampler (the gates closed)
    equals the fused routes on the CPU: the plain versions sum the same
    trees."""
    data = _tones(2048 * 16 * 2 + 100, FS, 9)
    for stages in ("single", "multi"):
        want = _run(_port(FS, stages=stages), data)
        unfused = _port(FS, stages=stages)
        unfused._chain_eligible = unfused._cascade_eligible = lambda total: False
        assert _run(unfused, data) == want


@pytest.mark.parametrize("fs,stages", [(FS, "single"), (FS, "multi"),
                                       (250000, "multi")])
def test_channels_vs_golden(fs, stages):
    """Above 70 dB against the oracle on every channel, tones placed where
    each channel's composed shift brings them in band.  Shifts stay within
    ±3% of the sample rate: the golden mixes with the reference's float32
    phase product, whose own rounding grows with shift / rate."""
    k = fs / FS
    channels = [(-20000.0 * k, 5000.0 * k), (0.0, 0.0), (30000.5 * k, -250.0)]
    composed = [s + c for s, c in channels]
    data = _tones(2048 * 16 * 2, fs, 10, centers=[f + 3000.0 for f in composed])
    got = _run(_port(fs, stages=stages, channels=channels), data)
    rs = make_resampler(fs, 48000, stages=stages)
    for g, (s, c) in zip(got, channels):
        golden = _golden(data, fs, s, c, getattr(rs, "stages", [rs]))
        assert len(golden) == len(g) // 4
        assert oracle.snr_db(golden, oracle.decode_i16_bytes(g)) > 70.0


def test_256_channels_plan_through_the_uniform_lane(monkeypatch):
    """Config-5 width: after the genesis chunk every chunk plans in one
    (C, B) pass, and the channels still equal single-stream runs bitwise."""
    from doppler_tpu_torch.runtime import channels as ch_mod

    calls = {"uniform": 0}
    real = ch_mod.plan_fields_uniform

    def counting(*a, **k):
        out = real(*a, **k)
        calls["uniform"] += not out[1]       # it refused no channel
        return out

    monkeypatch.setattr(ch_mod, "plan_fields_uniform", counting)
    C = 256
    rng = np.random.default_rng(11)
    data = rng.integers(-8000, 8000, size=2 * 2048 * 12, dtype=np.int16).tobytes()
    shifts = [9000.37 + 173.3 * c for c in range(C)]
    specs = [ChannelSpec(f"c{c:03d}", ConstScheduler(shifts[c])) for c in range(C)]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, chunk_blocks=4, device="cpu")
    got = _run(mp, data)
    assert calls["uniform"] >= 2
    for c in (0, 17, 255):
        assert got[c] == _single(FS, shifts[c], 0.0, data, out_rate=None)


def test_stop_between_chunks_does_not_drain():
    """A stop request ends the run at a chunk boundary: state consistent with
    the bytes written, no FIR tail flushed, and a second ``run`` on the rest
    of the stream completes the uninterrupted output."""
    data = _tones(2048 * 16 * 3 + 500, FS, 12)
    whole = _run(_port(FS, stages="multi", drain=True), data)
    mp = _port(FS, stages="multi", drain=True)
    fin = io.BytesIO(data)
    outs = [io.BytesIO() for _ in CHANNELS]
    polls = iter([False, False, True])
    mp.run(fin, outs, should_stop=lambda: next(polls))
    assert not mp._drained and mp.samples_in == 2 * 16 * 2048
    assert fin.tell() == mp.samples_in * 4
    mp.run(fin, outs)
    assert mp._drained
    assert [o.getvalue() for o in outs] == whole


def test_rejects_bad_arguments(monkeypatch):
    with pytest.raises(ValueError, match="at least one channel"):
        MultiChannelPipeline(FS, "i16", "i16", [], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        MultiChannelPipeline(FS, "i16", "i16", _specs())
    mp = _port(FS)
    with pytest.raises(ValueError, match="writers"):
        mp.run(io.BytesIO(b""), [io.BytesIO()])


# -- the routes ---------------------------------------------------------------

class _Reached(Exception):
    pass


def _jax_route(fs, out, stages, chunk_blocks, total, monkeypatch):
    """Which fused kernel the JAX ``impl='pallas'`` channels pipeline sends a
    chunk of ``total`` samples to ('chain', 'cascade' or None), found by
    stopping at the kernel's door."""
    def door(name):
        def refuse(*a, **k):
            raise _Reached(name)
        return refuse

    monkeypatch.setattr(j_chain, "mix_resample_chain_pallas_channels", door("chain"))
    monkeypatch.setattr(j_chain, "mix_cascade_pallas_channels", door("cascade"))
    mp = _jax(fs, "pallas", out_rate=out, stages=stages, chunk_blocks=chunk_blocks)
    B, L = chunk_blocks, 2048
    staged = np.zeros((B, L), dtype="<i4")
    fields = np.zeros((7, len(CHANNELS), B), dtype=np.uint32)
    for attempt in (mp._try_chain, mp._try_cascade):
        try:
            if attempt(staged, fields, total, b"") is not None:
                raise AssertionError("a refused kernel returned a result")
        except _Reached as e:
            return str(e), mp
    return None, mp


@pytest.mark.parametrize("chunk_blocks", [16, 256])
@pytest.mark.parametrize("fs,out,stages", [
    (1024000, 48000, "single"), (256000, 48000, "single"),
    (1024000, 44100, "single"), (250000, 48000, "single"),
    (1024000, 48000, "multi"), (256000, 48000, "multi"),
    (2048000, 48000, "multi"), (10_000_000, 48000, "multi"),
    (100_000_000, 48000, "multi"), (250000, 48000, "multi"),
    (1024000, 256000, "multi")])
def test_channel_gates_agree_with_jax(fs, out, stages, chunk_blocks, monkeypatch):
    """The JAX ``impl='pallas'`` channels gates and the port's send the same
    chunks to the same kernel and fuse the same stages: a full chunk and a
    partial one, single-stage and cascade rates (no case differs)."""
    full = chunk_blocks * 2048
    for total in (full, full - 2048):
        want, jmp = _jax_route(fs, out, stages, chunk_blocks, total, monkeypatch)
        mp = _port(fs, out_rate=out, stages=stages, chunk_blocks=chunk_blocks)
        got = ("chain" if mp._chain_eligible(total)
               else "cascade" if mp._cascade_eligible(total) else None)
        assert got == want
        if want == "cascade":
            assert mp._cascade_k == jmp._cascade_k
    assert want is None                      # a partial chunk never fuses


# -- the command line ---------------------------------------------------------

def _cli(args, data=b""):
    return subprocess.run(
        [sys.executable, "-m", "doppler_tpu_torch", "channels", *args,
         "--device", "cpu"],
        input=data, capture_output=True, cwd=REPO, timeout=300)


def test_cli_conformance_config4_subprocess(tmp_path):
    """BASELINE config 4 as the conformance harness runs it: 16 const
    channels out of one capture, no resampler; the worst channel stays above
    70 dB against the sequential golden at f32(shift) + f32(center)."""
    rng = np.random.default_rng(4)
    n = 8192 * 8
    raw = rng.integers(-9000, 9000, size=2 * n, dtype=np.int16).astype("<i2").tobytes()
    cfg = {"channels": [
        {"name": f"ch{k}", "shift": -40000 + 10000 * k, "center_offset": 1000.0 * k}
        for k in range(16)]}
    (tmp_path / "ch.json").write_text(json.dumps(cfg))
    proc = _cli(["-s", str(FS), "-i", "i16", "--config", str(tmp_path / "ch.json"),
                 "--output-dir", str(tmp_path / "out")], raw)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    assert b"multi-channel mode: 16 channels" in proc.stderr
    assert b"done: 65536 wideband samples x 16 channels" in proc.stderr
    x = oracle.decode_i16_bytes(raw)
    worst = float("inf")
    for k in range(16):
        got = oracle.decode_i16_bytes((tmp_path / "out" / f"ch{k}.iq").read_bytes())
        shift = float(np.float32(-40000 + 10000 * k) + np.float32(1000.0 * k))
        want, _ = oracle.shift_frequency_oracle(x, 0, shift, FS)
        want = oracle.decode_i16_bytes(oracle.encode_i16_bytes(want))
        assert len(got) == len(want)
        worst = min(worst, oracle.snr_db(want, got))
    assert worst > 70.0, worst


def test_cli_channels_equal_the_pipeline(tmp_path):
    """``channels --resample-to 48000`` in-process: the CLI's default
    ``--resample-stages auto`` is the cascade; files equal the pipeline
    driven directly."""
    data = _tones(2048 * 16 * 2 + 300, FS, 13)
    cfg = {"channels": [{"name": f"c{k}", "shift": s, "center_offset": c}
                        for k, (s, c) in enumerate(CHANNELS)]}
    (tmp_path / "ch.json").write_text(json.dumps(cfg))
    rc = cli.main(["channels", "-s", str(FS), "-i", "i16", "--config",
                   str(tmp_path / "ch.json"), "--output-dir", str(tmp_path / "o"),
                   "--resample-to", "48000", "--chunk-blocks", "16",
                   "--device", "cpu", "--log-level", "error"],
                  stdin=io.BytesIO(data))
    assert rc == 0
    want = _run(_port(FS, stages="auto"), data)
    for k, w in enumerate(want):
        assert (tmp_path / "o" / f"c{k}.iq").read_bytes() == w


@pytest.mark.parametrize("body", [
    '{"channels": [{"name": "x"}]}',                          # neither mode
    '{"channels": [{"name": "x", "tlename": "S", "frequency": 1, '
    '"location": "lat=1,lon=2,alt=3"}]}',                      # no tlefile
    '{"channels": [{"name": "x", "tlename": "S", "frequency": 1, '
    '"tlefile": "sat.txt"}]}',                                  # no location
    '{"chanels": []}',                                        # no channels key
    'not json'])
def test_cli_bad_config_is_rc_1(tmp_path, body):
    (tmp_path / "bad.json").write_text(body)
    proc = _cli(["-s", str(FS), "-i", "i16", "--config", str(tmp_path / "bad.json"),
                 "--output-dir", str(tmp_path)])
    assert proc.returncode == 1
    assert b"bad channel config" in proc.stderr


def test_cli_channels_rejects_unported_flags(tmp_path):
    (tmp_path / "c.json").write_text('{"channels": [{"name": "x", "shift": 1}]}')
    base = ["channels", "-s", str(FS), "-i", "i16", "--config",
            str(tmp_path / "c.json"), "--device", "cpu"]
    # --impl and --resample-impl are ported (tests/test_torch_cli_parity.py);
    # --platform tpu is refused, a usage error
    assert cli.main(base + ["--platform", "tpu"], stdin=io.BytesIO(b"")) == 2
    # --mesh is ported (tests/test_torch_mesh.py): one channel does not
    # divide over mesh channel=2, a configuration error
    assert cli.main(base + ["--mesh", "channel=2"], stdin=io.BytesIO(b"")) == 1
    # the host split's flags are ported (tests/test_torch_distributed.py);
    # a split run needs --input, checked before joining the group
    args = cli.build_parser().parse_args(
        base + ["--host-channels", "2", "--prefetch-chunks", "2"])
    assert (args.host_channels, args.prefetch_chunks) == (2, 2)
    assert cli.main(base + ["--distributed",
                            "coordinator=h:1,num_processes=2,process_id=0"],
                    stdin=io.BytesIO(b"")) == 1
    assert cli.main(["channels", "-s", str(FS), "-i", "i16", "--device", "cpu"],
                    stdin=io.BytesIO(b"")) == 2          # --config is required


def test_track_channels_config_equals_jax(tmp_path):
    """A config with track channels (top-level tlefile/location/time, one
    channel overriding the time) builds the schedulers the JAX loader
    builds: same staircase, same center offsets and rates."""
    (tmp_path / "sat.txt").write_text(f"TEST SAT\n{TLE_L1}\n{TLE_L2}\n")
    cfg = {
        "tlefile": str(tmp_path / "sat.txt"),
        "location": "lat=58.26541,lon=26.46667,alt=76",
        "time": "1980-10-01T12:41:24",
        "channels": [
            {"name": "t0", "tlename": "TEST SAT", "frequency": 437505000,
             "offset": 5000, "center_offset": -120000},
            {"name": "t1", "tlename": "TEST SAT", "frequency": 145800000,
             "time": "1980-10-01T12:50:00", "resample_to": 48000},
            {"name": "k", "shift": -15000, "center_offset": 250000},
        ]}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    specs, raw = load_channel_config(str(tmp_path / "c.json"), FS)
    jspecs, _ = j_load_channel_config(str(tmp_path / "c.json"), FS)
    assert raw == cfg and [s.name for s in specs] == ["t0", "t1", "k"]
    counts = [2048] * 1200                   # 2.4 s: the staircase steps twice
    for a, b in zip(specs, jspecs):
        assert (a.center_offset_hz, a.out_rate) == (b.center_offset_hz, b.out_rate)
        assert np.array_equal(np.asarray(a.scheduler.shifts(counts), np.float64),
                              np.asarray(b.scheduler.shifts(counts), np.float64))
    assert len(set(specs[0].scheduler.shifts(counts))) >= 2


def test_track_channels_take_every_key_from_their_own_entry(tmp_path):
    """Top-level keys are defaults only: channels that carry their own
    ``tlefile``, ``location`` and ``time``, with none at the top level,
    build the schedulers that the same values at the top level build."""
    (tmp_path / "sat.txt").write_text(f"TEST SAT\n{TLE_L1}\n{TLE_L2}\n")
    shared = {"tlefile": str(tmp_path / "sat.txt"),
              "location": "lat=58.26541,lon=26.46667,alt=76",
              "time": "1980-10-01T12:41:24"}
    chans = [{"name": f"t{k}", "tlename": "TEST SAT",
              "frequency": 437505000 + 64000 * k, "center_offset": 64000 * k}
             for k in range(2)]
    (tmp_path / "own.json").write_text(json.dumps(
        {"channels": [dict(ch, **shared) for ch in chans]}))
    (tmp_path / "top.json").write_text(json.dumps(dict(shared,
                                                       channels=chans)))
    own, _ = load_channel_config(str(tmp_path / "own.json"), FS)
    top, _ = load_channel_config(str(tmp_path / "top.json"), FS)
    counts = [2048] * 600
    for a, b in zip(own, top):
        assert a.center_offset_hz == b.center_offset_hz
        assert np.array_equal(np.asarray(a.scheduler.shifts(counts)),
                              np.asarray(b.scheduler.shifts(counts)))


def test_realtime_channels_pick_chunk_blocks_auto(tmp_path):
    """A track channel with no ``time`` runs on the wall clock: an unset
    --chunk-blocks shrinks to the ~64 ms target, as in realtime track mode."""
    (tmp_path / "sat.txt").write_text(f"TEST SAT\n{TLE_L1}\n{TLE_L2}\n")
    cfg = {"tlefile": str(tmp_path / "sat.txt"),
           "location": "lat=58.26541,lon=26.46667,alt=76",
           "channels": [{"name": "rt", "tlename": "TEST SAT",
                         "frequency": 437505000}]}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    proc = _cli(["-s", str(FS), "-i", "i16", "--config", str(tmp_path / "c.json"),
                 "--output-dir", str(tmp_path / "o")])
    assert b"realtime channel(s): chunk-blocks auto = 32" in proc.stderr


def test_new_modules_import_no_jax():
    code = ("import sys, doppler_tpu_torch.runtime.channels, "
            "doppler_tpu_torch.runtime.checkpoint, doppler_tpu_torch.convert, "
            "doppler_tpu_torch.cli; "
            "assert 'jax' not in sys.modules and 'doppler_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
