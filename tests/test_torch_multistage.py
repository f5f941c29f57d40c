"""The cascade resampler and the default config-3 route on the CPU: the
port's ``MultiStageResampler``, ``Pipeline`` and CLI against the JAX package
(``Pipeline`` with ``impl='xla'``, and with ``impl='pallas'`` in interpret
mode for the routing gate) and the per-stage golden model.

Tolerances: stage designs, banks and output counts are exact; encoded
bytes within 1 LSB in under 1% of samples of the JAX run (XLA's FMA
contraction and matmul sum order against the port's separate roundings and
fixed tree); above 70 dB against the golden (the reference's sequential mix,
then a float64 polyphase dot per stage with the same banks).  Inside the
port the cascade route, the mixer + resampler route and any chunk width
give the same bytes.
"""

import io
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from doppler_tpu.ops.multistage import MultiStageResampler as JMultiStage
from doppler_tpu.ops.resample import RationalResampler as JRationalResampler
from doppler_tpu.ops.resample import attach_resampler as j_attach
from doppler_tpu.orbit import Observer as JObserver
from doppler_tpu.orbit import Predictor as JPredictor
from doppler_tpu.orbit import Tle as JTle
from doppler_tpu.orbit import TrackScheduler as JTrackScheduler
from doppler_tpu.runtime import checkpoint as j_checkpoint
from doppler_tpu.runtime.pipeline import ConstScheduler as JConstScheduler
from doppler_tpu.runtime.pipeline import Pipeline as JPipeline
from doppler_tpu_torch import cli, convert, oracle
from doppler_tpu_torch.ops.cuda import chain
from doppler_tpu_torch.ops.multistage import MultiStageResampler, make_resampler
from doppler_tpu_torch.ops.resample import RationalResampler, attach_resampler
from doppler_tpu_torch.orbit import Observer, Predictor, Tle, TrackScheduler
from doppler_tpu_torch.orbit.tle import _checksum
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

FS = 1024000
RATES = [(1024000, 48000), (256000, 48000), (2048000, 48000),
         (10_000_000, 48000), (100_000_000, 48000), (250000, 48000),
         (1024000, 256000)]


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


def _tones(n, fs, seed):
    """In-band tones plus a little noise, as LE i16 IQ bytes: heavy
    decimation of white noise would floor the i16 SNR near 57 dB."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    x = (0.3 * np.exp(2j * np.pi * 3000.0 / fs * k)
         + 0.2 * np.exp(-2j * np.pi * 7000.0 / fs * k + 1.0)
         + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    ix = np.empty(2 * n, dtype="<i2")
    ix[0::2] = np.trunc(x.real * 32767)
    ix[1::2] = np.trunc(x.imag * 32767)
    return ix.tobytes()


def _run(pipe, data):
    out = io.BytesIO()
    pipe.run(io.BytesIO(data), out)
    return out.getvalue()


def _port(fs, sched, *, out_rate=48000, stages="auto", chunk_blocks=16):
    pipe = Pipeline(fs, "i16", "i16", sched, chunk_blocks=chunk_blocks,
                    device="cpu")
    attach_resampler(pipe, out_rate, stages=stages)
    return pipe


def _jax(fs, sched, *, out_rate=48000, stages="auto", chunk_blocks=16,
         impl="xla"):
    pipe = JPipeline(fs, "i16", "i16", sched, chunk_blocks=chunk_blocks,
                     impl=impl, pallas_interpret=impl == "pallas")
    j_attach(pipe, out_rate, stages=stages)
    return pipe


def _assert_lsb(got: bytes, want: bytes):
    assert len(got) == len(want)
    d = np.abs(np.frombuffer(got, "<i2").astype(np.int32)
               - np.frombuffer(want, "<i2").astype(np.int32))
    assert d.max() <= 1 and np.mean(d > 0) < 0.01, (d.max(), np.mean(d > 0))


def _golden(data, fs, shifts, counts, out_rate=48000):
    """Sequential reference mix, then the oracle's polyphase dot over each
    stage's bank in turn."""
    x = oracle.decode_i16_bytes(data)
    mixed = np.empty_like(x)
    sn, pos = 0, 0
    for s, c in zip(shifts, counts):
        mixed[pos:pos + c], sn = oracle.shift_frequency_oracle(
            x[pos:pos + c], sn, s, fs)
        pos += c
    y = mixed
    for st in MultiStageResampler(fs, out_rate).stages:
        y = oracle.resample_oracle(y, st.P, st.Q, st.bank)
    return oracle.decode_i16_bytes(oracle.encode_i16_bytes(y.astype(np.complex64)))


# -- (a) the stage design ---------------------------------------------------

@pytest.mark.parametrize("fs,out", RATES)
def test_stages_banks_and_counts_equal_jax(fs, out):
    ms, jms = MultiStageResampler(fs, out), JMultiStage(fs, out)
    assert [(s.P, s.Q, s.T) for s in ms.stages] == \
        [(s.P, s.Q, s.T) for s in jms.stages]
    for a, b in zip(ms.stages, jms.stages):
        assert np.array_equal(a.bank, b.bank)
    assert (ms.P, ms.Q, ms.T) == (jms.P, jms.Q, jms.T)
    for n in (0, 1, 2047, 2048 * 16, 2048 * 256 + 1000, fs):
        assert ms.out_count_for(n) == jms.out_count_for(n)
        assert ms.max_out_for(n) == jms.max_out_for(n)


def test_resampler_takes_the_jax_keywords():
    """RationalResampler builds a cascade stage (taps_per_phase, atten_db)
    and rationalizes with max_denominator as the JAX one does, and
    attach_resampler takes ``stages=``."""
    kw = dict(taps_per_phase=65, atten_db=79.03)
    assert np.array_equal(RationalResampler(FS, FS / 8, **kw).bank,
                          JRationalResampler(FS, FS / 8, **kw).bank)
    a = RationalResampler(44100, 48000.5, max_denominator=1000)
    b = JRationalResampler(44100, 48000.5, max_denominator=1000)
    assert (a.P, a.Q, a.T) == (b.P, b.Q, b.T) and a.Q <= 1000
    for stages, kind in (("single", RationalResampler),
                         ("auto", MultiStageResampler),
                         ("multi", MultiStageResampler)):
        pipe = Pipeline(FS, "i16", "i16", ConstScheduler(0.0), device="cpu")
        attach_resampler(pipe, 48000, stages=stages)
        assert type(pipe.resampler) is kind
    assert isinstance(make_resampler(48000, 44100, stages="auto"),
                      RationalResampler)
    with pytest.raises(ValueError, match="single|auto|multi"):
        make_resampler(FS, 48000, stages="bogus")


# -- (h), (i) the route -----------------------------------------------------

@pytest.mark.parametrize("chunk_blocks", [16, 256])
@pytest.mark.parametrize("fs,out", RATES)
def test_cascade_gate_agrees_with_jax(fs, out, chunk_blocks):
    """The JAX ``impl='pallas'`` gate and the port's take the same chunks
    and fuse the same stages (no case differs)."""
    j = _jax(fs, JConstScheduler(0.0), out_rate=out, stages="multi",
             chunk_blocks=chunk_blocks, impl="pallas")
    p = _port(fs, ConstScheduler(0.0), out_rate=out, stages="multi",
              chunk_blocks=chunk_blocks)
    full = chunk_blocks * 2048
    for total in (full, full - 2048):
        assert p._cascade_eligible(total) == j._cascade_eligible(total)
        assert not p._chain_eligible(total) and not j._chain_eligible(total)
    assert j._cascade_eligible(full) and p._cascade_k == j._cascade_k


def test_cascade_never_reaches_the_chain_kernel(monkeypatch):
    """A MultiStageResampler at config 3 (overall 3/64, T = 465) passes every
    term of the chain gate but the single-stage one."""
    pipe = _port(FS, ConstScheduler(9000.0))
    assert (pipe.resampler.P, pipe.resampler.Q, pipe.resampler.T) == (3, 64, 465)
    assert not pipe._chain_eligible(16 * 2048)

    def refuse(*a, **k):
        raise AssertionError("a cascade reached the chain kernel")

    monkeypatch.setattr(chain, "mix_resample_chain_stream", refuse)
    assert len(_run(pipe, _tones(2048 * 33 + 100, FS, 1))) > 0
    assert pipe.resampler.stages[0].in_consumed == 2048 * 33 + 100


# -- (e), (f), (g) the default config-3 route -----------------------------

def test_default_cli_config3_vs_jax_auto_and_golden(tmp_path):
    """``track … --resample-to 48000`` with no --resample-stages: the
    cascade, as the JAX CLI's default."""
    n_full, tail = 64, 1000
    data = _tones(2048 * n_full + tail, FS, 3)
    (tmp_path / "sat.txt").write_text(f"TEST SAT\n{TLE_L1}\n{TLE_L2}\n")
    (tmp_path / "in.iq").write_bytes(data)
    start = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(START_UNIX))
    rc = cli.main(["track", "-s", str(FS), "-i", "i16",
                   "--tlefile", str(tmp_path / "sat.txt"), "--tlename", "TEST SAT",
                   "--location", "lat=58.26541,lon=26.46667,alt=76",
                   "--frequency", str(int(FREQ)), "--offset", "5000",
                   "--time", start, "--resample-to", "48000",
                   "--chunk-blocks", "16", "--device", "cpu",
                   "--log-level", "error", "--input", str(tmp_path / "in.iq"),
                   "--output", str(tmp_path / "out.iq")])
    assert rc == 0
    got = (tmp_path / "out.iq").read_bytes()
    n_in = 2048 * n_full + tail
    assert len(got) // 4 == MultiStageResampler(FS, 48000).out_count_for(n_in)
    _assert_lsb(got, _run(_jax(FS, _track(FS, jax=True)), data))
    counts = [2048] * n_full + [tail]
    golden = _golden(data, FS, _track(FS).shifts(counts), counts)
    assert len(golden) == len(got) // 4
    assert oracle.snr_db(golden, oracle.decode_i16_bytes(got)) > 70.0


def test_cascade_route_equals_mixer_route_bitwise_and_chunk_invariant():
    """On the CPU the fused route's plain version sums the same fixed trees
    as ``MultiStageResampler.process``: every chunk through mixer +
    resampler (chunks of 5 blocks) gives the cascade route's bytes, and so
    does the cascade at another chunk width."""
    data = _tones(2048 * 32 + 500, FS, 4)
    fused = _port(FS, _track(FS))
    want = _run(fused, data)
    assert fused._cascade_k == 2
    mixer_route = _port(FS, _track(FS), chunk_blocks=5)
    mixer_route._cascade_eligible = lambda total: False
    assert _run(mixer_route, data) == want
    assert _run(_port(FS, _track(FS), chunk_blocks=8), data) == want


def test_drain_with_a_cascade():
    """--drain: T−1 = 464 zeros through every stage after EOF, from the
    histories the fused chunks mirrored back, as the JAX pipeline does."""
    data = _tones(2048 * 16 + 300, FS, 8)
    port = _port(FS, _track(FS))
    jax_ = _jax(FS, _track(FS, jax=True))
    port.drain_on_eof = jax_.drain_on_eof = True
    got = _run(port, data)
    plain = _run(_port(FS, _track(FS)), data)
    assert len(got) > len(plain) and got[:len(plain)] == plain
    _assert_lsb(got, _run(jax_, data))
    assert port._cascade_carries is None    # reseeds from the history


# -- the split route --------------------------------------------------------

@pytest.mark.parametrize("fs,n_blocks", [(100_000_000, 16 * 24), (250000, 24)])
def test_split_route_vs_jax_and_golden(fs, n_blocks):
    """Final Q ∤ 128 (3125 at 100 Msps, 125 at 250 ksps): the ÷2^k front
    runs fused, its planes run the tail stage, then encode."""
    n = 2048 * n_blocks + 300
    data = _tones(n, fs, 11)
    pipe = _port(fs, ConstScheduler(5000.0))
    got = _run(pipe, data)
    assert 0 < pipe._cascade_k < len(pipe.resampler.stages)
    assert len(got) // 4 == MultiStageResampler(fs, 48000).out_count_for(n)
    _assert_lsb(got, _run(_jax(fs, JConstScheduler(5000.0)), data))
    counts = [2048] * n_blocks + [300]
    golden = _golden(data, fs, [5000.0] * len(counts), counts)
    assert oracle.snr_db(golden, oracle.decode_i16_bytes(got)) > 70.0
    assert _run(_port(fs, ConstScheduler(5000.0), chunk_blocks=8), data) == got


# -- checkpoint from the JAX package ---------------------------------------

def test_jax_cascade_checkpoint_resumes_in_port():
    """JAX runs half a config-3 'auto' stream and checkpoints; the port
    loads it with convert.load_jax_checkpoint and runs the rest."""
    half, n_full, tail = 32, 64, 1000
    data = _tones(2048 * n_full + tail, FS, 5)
    cut = half * 2048 * 4
    port_whole = _run(_port(FS, _track(FS)), data)
    jax_whole = _run(_jax(FS, _track(FS, jax=True)), data)

    jpipe = _jax(FS, _track(FS, jax=True))
    jax_first = _run(jpipe, data[:cut])
    ck = io.BytesIO()
    j_checkpoint.save(ck, jpipe)

    pipe = _port(FS, _track(FS))
    meta = convert.load_jax_checkpoint(ck, pipe)
    assert meta["resampler_sig"] == [[1, 8, 65], [3, 8, 51]]
    assert meta["sample_offset"] * 4 == cut
    port_second = _run(pipe, data[cut:])
    assert port_second == port_whole[len(jax_first):]
    _assert_lsb(jax_first + port_second, jax_whole)

    single = JPipeline(FS, "i16", "i16", _track(FS, jax=True), chunk_blocks=16,
                       impl="xla")
    j_attach(single, 48000, stages="single")
    _run(single, data[:cut])
    ck1 = io.BytesIO()
    j_checkpoint.save(ck1, single)
    with pytest.raises(ValueError, match="resampler config"):
        convert.load_jax_checkpoint(ck1, _port(FS, _track(FS)))


# -- the CLI ----------------------------------------------------------------

def test_cli_accepts_auto_and_multi():
    for stages in ("auto", "multi", "single"):
        assert cli.main(["const", "-s", str(FS), "-i", "i16", "--shift", "1",
                         "--resample-to", "48000", "--resample-stages", stages,
                         "--device", "cpu", "--log-level", "error"],
                        stdin=io.BytesIO(b""), stdout=io.BytesIO()) == 0


def test_cli_default_logs_the_cascade_notice():
    rng = np.random.default_rng(6)
    data = rng.integers(-9000, 9000, size=2 * 5000, dtype=np.int16).tobytes()
    proc = subprocess.run(
        [sys.executable, "-m", "doppler_tpu_torch", "const", "-s", str(FS),
         "-i", "i16", "--shift", "-15000", "--resample-to", "48000",
         "--device", "cpu"],
        input=data, capture_output=True, timeout=120, check=True)
    assert b"resample-stages auto" in proc.stderr
    assert b"using the multi-stage cascade" in proc.stderr
    pipe = _port(FS, ConstScheduler(-15000.0), chunk_blocks=256)
    assert proc.stdout == _run(pipe, data)
