"""The slice end to end on the CPU: the port's Pipeline and CLI against the
JAX Pipeline (``impl='xla'``) and the reference golden model.

Configs (BASELINE.md): 1 = const −15 kHz f32→i16 at 256 ksps (mix only);
2 = track i16 at 256 ksps with the conformance TLE + 5 kHz; 3 = track +
single-stage resample 1.024 Msps → 48 ksps, where full chunks take the
fused chain and the ragged EOF chunk the mixer + resampler.

Tolerances: lengths exact; encoded bytes within 1 LSB in under 1% of
samples of the JAX run (XLA's FMA contraction and matmul sum order differ
from the port's separate roundings); config 3 above 70 dB against the
golden (sequential reference mix, float64 polyphase dot).  The JAX track
scheduler uses its NumPy SGP4, which the port copies, so both packages plan
identical shifts.
"""

import io
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from doppler_tpu.orbit import Observer as JObserver
from doppler_tpu.orbit import Predictor as JPredictor
from doppler_tpu.orbit import Tle as JTle
from doppler_tpu.orbit import TrackScheduler as JTrackScheduler
from doppler_tpu.ops.resample import RationalResampler as JRationalResampler
from doppler_tpu.runtime import checkpoint as j_checkpoint
from doppler_tpu.runtime.pipeline import ConstScheduler as JConstScheduler
from doppler_tpu.runtime.pipeline import Pipeline as JPipeline
from doppler_tpu_torch import cli, convert, oracle
from doppler_tpu_torch.ops.resample import RationalResampler, attach_resampler
from doppler_tpu_torch.orbit import Observer, Predictor, Tle, TrackScheduler
from doppler_tpu_torch.orbit.tle import _checksum
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fix(line):
    line = line.ljust(68)[:68]
    return line + str(_checksum(line))


TLE_L1 = _fix("1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8")
TLE_L2 = _fix("2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105")
START_UNIX = float(int((2444514.48708465 - 2440587.5) * 86400.0 + 3600.0))
SITE = (58.26541, 26.46667, 76.0)
FREQ = 437505000.0


def _track(fs, jax=False):
    if jax:
        pred = JPredictor(JTle.from_lines("TEST SAT", TLE_L1, TLE_L2),
                          JObserver(*SITE), use_native=False)
        return JTrackScheduler(pred, FREQ, 5000.0, fs, START_UNIX, telemetry=False)
    pred = Predictor(Tle.from_lines("TEST SAT", TLE_L1, TLE_L2), Observer(*SITE),
                     use_native=False)
    return TrackScheduler(pred, FREQ, 5000.0, fs, START_UNIX, telemetry=False)


def _i16_stream(n, seed):
    """In-band tones plus noise: a decimated capture whose power is far
    above the i16 output quantization floor."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = (0.3 * np.exp(2j * np.pi * 3000.0 / 1024000 * k)
         + 0.2 * np.exp(-2j * np.pi * 7000.0 / 1024000 * k + 1.0)
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    ix = np.empty(2 * n, dtype="<i2")
    ix[0::2] = np.trunc(x.real * 32767)
    ix[1::2] = np.trunc(x.imag * 32767)
    return ix.tobytes()


def _run(pipe, data):
    out = io.BytesIO()
    pipe.run(io.BytesIO(data), out)
    return out.getvalue()


def _port(fs, intype, outtype, sched, *, resample=None, chunk_blocks=16,
          stages="single"):
    pipe = Pipeline(fs, intype, outtype, sched, chunk_blocks=chunk_blocks,
                    device="cpu")
    if resample:
        attach_resampler(pipe, resample, stages=stages)
    return pipe


def _jax(fs, intype, outtype, sched, *, resample=None, chunk_blocks=16):
    pipe = JPipeline(fs, intype, outtype, sched, chunk_blocks=chunk_blocks,
                     impl="xla")
    if resample:
        pipe.set_resampler(JRationalResampler(fs, resample))
    return pipe


def _assert_lsb(got: bytes, want: bytes):
    assert len(got) == len(want)
    d = np.abs(np.frombuffer(got, "<i2").astype(np.int32)
               - np.frombuffer(want, "<i2").astype(np.int32))
    assert d.max() <= 1 and np.mean(d > 0) < 0.01, (d.max(), np.mean(d > 0))


@pytest.mark.parametrize("exact_ratio", [False, True])
def test_config1_const_f32_to_i16(exact_ratio):
    rng = np.random.default_rng(1)
    n = 2048 * 20 + 700
    x = (0.3 * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(np.complex64)
    data = oracle.encode_f32_bytes(x)
    port = _port(256000, "f32", "i16", ConstScheduler(-15000.0), chunk_blocks=8)
    jax_ = _jax(256000, "f32", "i16", JConstScheduler(-15000.0), chunk_blocks=8)
    port.quantize_ratio_f32 = jax_.quantize_ratio_f32 = not exact_ratio
    got, want = _run(port, data), _run(jax_, data)
    _assert_lsb(got, want)
    ref, _ = oracle.shift_frequency_oracle(x, 0, -15000.0, 256000)
    assert oracle.snr_db(oracle.decode_i16_bytes(oracle.encode_i16_bytes(ref)),
                         oracle.decode_i16_bytes(got)) > 60.0


@pytest.mark.parametrize("intype,resample", [("i16", None), ("f32", 48000)])
def test_f32_output_vs_jax(intype, resample):
    """f32 output (planar on the device, interleaved pairs on the wire):
    within 2^-20 of the JAX bytes' values for the mixer, 1e-6 of full
    scale with the resampler (XLA contraction and sum order)."""
    fs = 1024000
    raw = _i16_stream(2048 * 24 + 100, 10)
    if intype == "f32":
        raw = oracle.encode_f32_bytes(oracle.decode_i16_bytes(raw))
    got = _run(_port(fs, intype, "f32", ConstScheduler(2500.0), resample=resample), raw)
    want = _run(_jax(fs, intype, "f32", JConstScheduler(2500.0), resample=resample), raw)
    assert len(got) == len(want)
    d = np.abs(np.frombuffer(got, "<f4") - np.frombuffer(want, "<f4")).max()
    assert d <= (1e-6 if resample else 2.0 ** -20)


def test_config2_track_i16():
    fs = 256000
    rng = np.random.default_rng(2)
    data = rng.integers(-9000, 9000, size=2 * 2048 * 40, dtype=np.int16).tobytes()
    got = _run(_port(fs, "i16", "i16", _track(fs)), data)
    want = _run(_jax(fs, "i16", "i16", _track(fs, jax=True)), data)
    _assert_lsb(got, want)


def _config3_golden(data, n_blocks_full, tail, fs=1024000):
    x = oracle.decode_i16_bytes(data)
    counts = [2048] * n_blocks_full + ([tail] if tail else [])
    shifts = _track(fs).shifts(counts)
    mixed = np.empty_like(x)
    sn, pos = 0, 0
    for s, c in zip(shifts, counts):
        mixed[pos:pos + c], sn = oracle.shift_frequency_oracle(
            x[pos:pos + c], sn, s, fs)
        pos += c
    rs = RationalResampler(fs, 48000)
    want = oracle.resample_oracle(mixed, rs.P, rs.Q, rs.bank).astype(np.complex64)
    return oracle.decode_i16_bytes(oracle.encode_i16_bytes(want))


def test_config3_track_resample_vs_jax_and_golden():
    fs = 1024000
    n_full, tail = 64, 1000
    data = _i16_stream(2048 * n_full + tail, 3)
    pipe = _port(fs, "i16", "i16", _track(fs), resample=48000)
    got = _run(pipe, data)
    want = _run(_jax(fs, "i16", "i16", _track(fs, jax=True), resample=48000), data)
    n_in = 2048 * n_full + tail
    assert len(got) // 4 == -(-n_in * 3 // 64)    # exact ⌈n·P/Q⌉
    _assert_lsb(got, want)
    golden = _config3_golden(data, n_full, tail)
    assert len(golden) == len(got) // 4
    assert oracle.snr_db(golden, oracle.decode_i16_bytes(got)) > 70.0


def test_config3_drain_flushes_fir_tail():
    """--drain: T−1 zeros after EOF emit the outputs whose windows straddle
    the end, as the JAX pipeline does."""
    fs = 1024000
    data = _i16_stream(2048 * 16 + 300, 8)
    port = _port(fs, "i16", "i16", _track(fs), resample=48000)
    jax_ = _jax(fs, "i16", "i16", _track(fs, jax=True), resample=48000)
    port.drain_on_eof = jax_.drain_on_eof = True
    got, want = _run(port, data), _run(jax_, data)
    plain = _run(_port(fs, "i16", "i16", _track(fs), resample=48000), data)
    assert len(got) > len(plain) and got[:len(plain)] == plain
    _assert_lsb(got, want)


def test_stop_between_chunks_resumes_exactly():
    """A should_stop pause after two chunks does not drain; running the
    rest of the stream through the same pipeline gives the uninterrupted
    run's bytes, FIR tail included."""
    fs = 1024000
    data = _i16_stream(2048 * 48 + 300, 9)
    whole = _port(fs, "i16", "i16", _track(fs), resample=48000)
    whole.drain_on_eof = True
    want = _run(whole, data)
    pipe = _port(fs, "i16", "i16", _track(fs), resample=48000)
    pipe.drain_on_eof = True
    polls = iter([False, False, True])
    first = io.BytesIO()
    pipe.run(io.BytesIO(data), first, should_stop=lambda: next(polls))
    cut = 2 * 16 * 2048 * 4                   # two chunks consumed
    assert pipe._sample_offset * 4 == cut
    assert first.getvalue() == want[:len(first.getvalue())]
    assert first.getvalue() + _run(pipe, data[cut:]) == want


def test_config3_chain_route_equals_mixer_route_bitwise():
    """On the CPU both routes sum the same fixed tree: running every chunk
    through mixer + resampler (chunks of 5 blocks ≠ the 16-block chain
    chunks) gives the chain route's bytes exactly."""
    fs = 1024000
    data = _i16_stream(2048 * 32 + 500, 4)
    chain_route = _run(_port(fs, "i16", "i16", _track(fs), resample=48000), data)
    pipe = _port(fs, "i16", "i16", _track(fs), resample=48000, chunk_blocks=5)
    pipe._chain_eligible = lambda total: False
    assert _run(pipe, data) == chain_route


def test_jax_checkpoint_resumes_in_port():
    """JAX runs the first half and checkpoints; the port loads it with
    convert.load_jax_checkpoint and runs the second half."""
    fs = 1024000
    half, n_full, tail = 32, 64, 1000
    data = _i16_stream(2048 * n_full + tail, 5)
    cut = half * 2048 * 4
    port_whole = _run(_port(fs, "i16", "i16", _track(fs), resample=48000), data)
    jax_whole = _run(_jax(fs, "i16", "i16", _track(fs, jax=True), resample=48000), data)

    jpipe = _jax(fs, "i16", "i16", _track(fs, jax=True), resample=48000)
    jax_first = _run(jpipe, data[:cut])
    ck = io.BytesIO()
    j_checkpoint.save(ck, jpipe)

    pipe = _port(fs, "i16", "i16", _track(fs), resample=48000)
    meta = convert.load_jax_checkpoint(ck, pipe)
    assert meta["sample_offset"] * 4 == cut
    port_second = _run(pipe, data[cut:])
    assert port_second == port_whole[len(jax_first):]
    _assert_lsb(jax_first + port_second, jax_whole)

    other = _port(fs, "i16", "i16", ConstScheduler(5000.0), resample=48000)
    with pytest.raises(ValueError, match="scheduler config"):
        convert.load_jax_checkpoint(ck, other)


def test_cuda_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Pipeline(256000, "i16", "i16", ConstScheduler(0.0), device="cuda")
    assert cli.main(["const", "-s", "256000", "-i", "i16", "--shift", "1",
                     "--device", "cuda", "--log-level", "error"],
                    stdin=io.BytesIO(b""), stdout=io.BytesIO()) == 1


def test_cli_mesh_flag_identical():
    """``--mesh time=4 --device cpu``: the bytes of the unsharded run
    (the fused cascade, the default route, with a partial EOF chunk)."""
    raw = _i16_stream(2048 * 40 + 1234, 8)

    def run_cli(extra):
        out = io.BytesIO()
        rc = cli.main(["const", "-s", "1024000", "-i", "i16", "--shift",
                       "-15000", "--resample-to", "48000", "--chunk-blocks",
                       "16", "--device", "cpu", "--log-level", "error"] + extra,
                      stdin=io.BytesIO(raw), stdout=out)
        assert rc == 0
        return out.getvalue()

    a = run_cli([])
    assert a == run_cli(["--mesh", "time=4"]) and len(a) > 0


def test_cli_mesh_rejects_channel_outside_channels_mode(monkeypatch):
    """channel > 1 outside channels mode, a bad spec, and more shards than
    cards (the JAX message) exit 1."""
    base = ["const", "-s", "256000", "-i", "i16", "--shift", "-100",
            "--log-level", "error"]
    for extra in (["--mesh", "time=2,channel=2", "--device", "cpu"],
                  ["--mesh", "time=x", "--device", "cpu"],
                  ["--mesh", "space=2", "--device", "cpu"]):
        assert cli.main(base + extra, stdin=io.BytesIO(b""),
                        stdout=io.BytesIO()) == 1
    assert cli.parse_mesh("time=2,channel=4") == (2, 4)
    assert cli.parse_mesh("channel=3") == (1, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    from doppler_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        make_mesh(time=2, device="cuda")
    assert cli.main(base + ["--mesh", "time=2"], stdin=io.BytesIO(b""),
                    stdout=io.BytesIO()) == 1


def test_port_imports_no_jax():
    code = ("import sys, doppler_tpu_torch.cli, doppler_tpu_torch.runtime.pipeline, "
            "doppler_tpu_torch.convert, doppler_tpu_torch.ops.cuda.chain, "
            "doppler_tpu_torch.ops.cuda.cascade, doppler_tpu_torch.ops.multistage, "
            "doppler_tpu_torch.runtime.channels, doppler_tpu_torch.runtime.checkpoint, "
            "doppler_tpu_torch.parallel.distributed, doppler_tpu_torch.parallel.mesh, "
            "doppler_tpu_torch.parallel.sharded; "
            "assert 'jax' not in sys.modules and 'doppler_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_cli_subprocess_const_cpu(tmp_path):
    rng = np.random.default_rng(6)
    data = rng.integers(-20000, 20000, size=2 * 5000, dtype=np.int16).tobytes()
    proc = subprocess.run(
        [sys.executable, "-m", "doppler_tpu_torch", "const", "-s", "256000",
         "-i", "i16", "--shift", "-15000", "--device", "cpu",
         "--log-format", "json"],
        input=data, capture_output=True, cwd=REPO, timeout=120, check=True)
    want = _run(_port(256000, "i16", "i16", ConstScheduler(-15000.0),
                      chunk_blocks=256), data)
    assert proc.stdout == want and len(want) == len(data)
    assert b'"msg": "done: 5000 samples in' in proc.stderr


def test_cli_track_resample_files(tmp_path):
    """``track … --resample-to 48000 --device cpu`` through the CLI equals
    the Pipeline driven directly (the TLE read from a file, --time given);
    with no --resample-stages the CLI runs the cascade ('auto')."""
    fs = 1024000
    data = _i16_stream(2048 * 20 + 333, 7)
    (tmp_path / "sat.txt").write_text(f"TEST SAT\n{TLE_L1}\n{TLE_L2}\n")
    (tmp_path / "in.iq").write_bytes(data)
    start = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(START_UNIX))
    rc = cli.main(["track", "-s", str(fs), "-i", "i16",
                   "--tlefile", str(tmp_path / "sat.txt"), "--tlename", "TEST SAT",
                   "--location", "lat=58.26541,lon=26.46667,alt=76",
                   "--frequency", str(int(FREQ)), "--offset", "5000",
                   "--time", start, "--resample-to", "48000",
                   "--chunk-blocks", "8", "--device", "cpu", "--log-level", "error",
                   "--input", str(tmp_path / "in.iq"),
                   "--output", str(tmp_path / "out.iq")])
    assert rc == 0
    want = _run(_port(fs, "i16", "i16", _track(fs), resample=48000,
                      chunk_blocks=8, stages="auto"), data)
    assert (tmp_path / "out.iq").read_bytes() == want
