"""Checkpoints on the CPU: the port's ``runtime.checkpoint`` (stream and
channels) inside the port, across to the JAX package and back, and through
the command line's ``--save-state`` / ``--load-state``.

Inside the port a cut at a chunk boundary plus a resume reproduces the
uninterrupted bytes exactly (the fused kernels reseed their carries from
the restored histories).  Across the packages the format is one: a file
written by either loads in the other, and the spliced output stays within
1 LSB in under 1% of samples of the uninterrupted run of either (the two
packages' float32 roundings differ; the state they exchange does not).
"""

import io
import json
import os
import signal

import numpy as np
import pytest
import torch

from doppler_tpu.ops.resample import attach_resampler as j_attach
from doppler_tpu.runtime import checkpoint as j_checkpoint
from doppler_tpu.runtime.channels import ChannelSpec as JChannelSpec
from doppler_tpu.runtime.channels import MultiChannelPipeline as JMultiChannelPipeline
from doppler_tpu.runtime.pipeline import ConstScheduler as JConstScheduler
from doppler_tpu.runtime.pipeline import Pipeline as JPipeline
from doppler_tpu_torch import cli, convert
from doppler_tpu_torch.ops.resample import attach_resampler
from doppler_tpu_torch.runtime import checkpoint
from doppler_tpu_torch.runtime.channels import ChannelSpec, MultiChannelPipeline
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

FS = 1024000
CHUNK = 16 * 2048 * 4            # bytes of one 16-block chunk of i16 IQ
CHANNELS = [(-40000.0, 500.0), (12000.5, 0.0), (90000.0, 0.0)]


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-8000, 8000, size=2 * n, dtype=np.int16).tobytes()


def _specs(jax=False, rates=None, names="abc"):
    spec, sched = (JChannelSpec, JConstScheduler) if jax else (ChannelSpec, ConstScheduler)
    rates = rates or [None] * len(CHANNELS)
    return [spec(names[k], sched(s), center_offset_hz=c, out_rate=r)
            for k, ((s, c), r) in enumerate(zip(CHANNELS, rates))]


def _port(fs=FS, *, stages="single", out_rate=48000, rates=None, drain=False,
          names="abc"):
    return MultiChannelPipeline(fs, "i16", "i16", _specs(rates=rates, names=names),
                                out_rate=out_rate, chunk_blocks=16,
                                resample_stages=stages, drain_on_eof=drain,
                                device="cpu")


def _jax(fs=FS, *, stages="single", out_rate=48000, rates=None, impl="xla"):
    return JMultiChannelPipeline(fs, "i16", "i16", _specs(True, rates),
                                 out_rate=out_rate, chunk_blocks=16,
                                 resample_stages=stages, impl=impl,
                                 pallas_interpret=impl == "pallas")


def _run(mp, data):
    outs = [io.BytesIO() for _ in mp.channels]
    mp.run(io.BytesIO(data), outs)
    return [o.getvalue() for o in outs]


def _assert_lsb(got: bytes, want: bytes):
    assert len(got) == len(want) > 0
    d = np.abs(np.frombuffer(got, "<i2").astype(np.int32)
               - np.frombuffer(want, "<i2").astype(np.int32))
    assert d.max() <= 1 and np.mean(d > 0) < 0.01, (d.max(), np.mean(d > 0))


# (fs, stages, pipeline out_rate, per-channel rates)
CONFIGS = [
    pytest.param(FS, "single", 48000, None, id="uniform-chain"),
    pytest.param(FS, "multi", 48000, None, id="uniform-cascade"),
    pytest.param(250000, "multi", 48000, None, id="split-cascade"),
    pytest.param(FS, "single", None, [48000.0, None, 128000.0], id="mixed-rates"),
]


# -- inside the port ----------------------------------------------------------

@pytest.mark.parametrize("fs,stages,out_rate,rates", CONFIGS)
def test_channels_cut_and_resume_is_bitwise(tmp_path, fs, stages, out_rate, rates):
    data = _stream(2048 * 16 * 4 + 600, 1)
    kw = dict(stages=stages, out_rate=out_rate, rates=rates)
    whole = _run(_port(fs, **kw), data)
    cut = 2 * CHUNK
    mp1 = _port(fs, **kw)
    first = _run(mp1, data[:cut])
    path = tmp_path / "ck.npz.h0"              # written at the exact path
    checkpoint.save_channels(str(path), mp1)
    assert path.exists()
    mp2 = _port(fs, **kw)
    meta = checkpoint.restore_channels(str(path), mp2)
    assert meta["samples_in"] * 4 == cut and meta["kind"] == "channels"
    assert not meta["drained"]
    assert mp2._chain_carry is None and mp2._cascade_carries is None
    rest = _run(mp2, data[cut:])
    for a, b, w in zip(first, rest, whole):
        assert a + b == w


def _stream_port():
    pipe = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                    chunk_blocks=16, device="cpu")
    attach_resampler(pipe, 48000, stages="multi")
    return pipe


def _stream_run(pipe, data):
    out = io.BytesIO()
    pipe.run(io.BytesIO(data), out)
    return [out.getvalue()]


@pytest.mark.parametrize("mode", ["stream", "channels"])
def test_restore_drops_stale_carries_and_a_mixed_route_resumes_bitwise(
        monkeypatch, mode):
    """``restore`` and ``restore_channels`` drop the fused carries through
    the pipeline's own ``drop_carries``: a pipeline whose carries are stale
    (it ran another stream) resumes the uninterrupted bytes exactly, its
    chunks after the restore alternating between the fused cascade and the
    unfused route, the first of them fused."""
    make, run, save, restore = (
        (_stream_port, _stream_run, checkpoint.save, checkpoint.restore)
        if mode == "stream" else
        (lambda: _port(stages="multi"), _run, checkpoint.save_channels,
         checkpoint.restore_channels))
    data = _stream(2048 * 16 * 5 + 600, 3)
    cut = 2 * CHUNK
    whole = run(make(), data)
    first_pipe = make()
    first = run(first_pipe, data[:cut])
    buf = io.BytesIO()
    save(buf, first_pipe)

    pipe = make()
    run(pipe, _stream(2048 * 16 * 2, 9))
    assert pipe._cascade_carries is not None
    dropped = []
    drop = type(pipe).drop_carries
    monkeypatch.setattr(type(pipe), "drop_carries",
                        lambda self: (dropped.append(self), drop(self))[1])
    restore(buf, pipe)
    assert dropped == [pipe]
    assert pipe._chain_carry is None and pipe._cascade_carries is None

    gate, calls = pipe._cascade_eligible, []

    def alternate(total):
        calls.append(total)
        return len(calls) % 2 == 1 and gate(total)
    pipe._cascade_eligible = alternate
    rest = run(pipe, data[cut:])
    assert len(calls) >= 4
    for a, b, w in zip(first, rest, whole):
        assert a + b == w and len(b) > 0


def test_channels_checkpoint_keys_are_the_jax_keys(tmp_path):
    """Key for key: the arrays and the metadata fields of a port checkpoint
    are those of a JAX checkpoint of the same run."""
    data = _stream(2048 * 16 * 2, 2)
    for stages in ("single", "multi"):
        mp, jmp = _port(stages=stages), _jax(stages=stages)
        _run(mp, data)
        _run(jmp, data)
        a, b = io.BytesIO(), io.BytesIO()
        checkpoint.save_channels(a, mp)
        j_checkpoint.save_channels(b, jmp)
        a.seek(0)
        b.seek(0)
        with np.load(a) as za, np.load(b) as zb:
            assert sorted(za.files) == sorted(zb.files)
            ma = json.loads(bytes(za["meta"].tobytes()).decode())
            mb = json.loads(bytes(zb["meta"].tobytes()).decode())
            assert ma == mb          # counters, signatures, groups, samples_in
            for key in za.files:
                assert za[key].shape == zb[key].shape, key


def test_channels_restore_rejects_another_configuration(tmp_path):
    data = _stream(2048 * 16, 3)
    mp = _port()
    _run(mp, data)
    ck = io.BytesIO()
    checkpoint.save_channels(ck, mp)
    with pytest.raises(ValueError, match="channel set changed"):
        checkpoint.restore_channels(ck, _port(names="axc"))
    with pytest.raises(ValueError, match="resampler configuration changed"):
        checkpoint.restore_channels(ck, _port(stages="multi"))
    with pytest.raises(ValueError, match="rate grouping changed"):
        checkpoint.restore_channels(ck, _port(rates=[48000.0, 128000.0, 48000.0]))
    with pytest.raises(ValueError, match="samplerate"):
        checkpoint.restore_channels(ck, _port(2048000))
    moved = _port()
    moved.channels[1].center_offset_hz = 10.0
    with pytest.raises(ValueError, match="center offset changed"):
        checkpoint.restore_channels(ck, moved)
    shifted = _port()
    shifted.channels[2].scheduler.shift_hz = 1.0
    with pytest.raises(ValueError, match="scheduler config"):
        checkpoint.restore_channels(ck, shifted)
    assert shifted.samples_in == 0           # a refused restore touches nothing
    # a stream checkpoint is not a channels checkpoint, and the reverse
    pipe = Pipeline(FS, "i16", "i16", ConstScheduler(1.0), device="cpu")
    sk = io.BytesIO()
    checkpoint.save(sk, pipe)
    with pytest.raises(ValueError, match="not a channels-mode checkpoint"):
        checkpoint.restore_channels(sk, _port())
    with pytest.raises(ValueError, match="not a single-stream checkpoint"):
        checkpoint.restore(ck, pipe)


# -- across the packages --------------------------------------------------------

@pytest.mark.parametrize("fs,stages,out_rate,rates", CONFIGS)
def test_jax_channels_checkpoint_resumes_in_port(fs, stages, out_rate, rates):
    """JAX runs the first two chunks and saves; the port restores and runs
    the rest: bitwise the port's own second half, within 1 LSB of JAX whole."""
    data = _stream(2048 * 16 * 4 + 600, 4)
    kw = dict(stages=stages, out_rate=out_rate, rates=rates)
    cut = 2 * CHUNK
    port_whole = _run(_port(fs, **kw), data)
    jax_whole = _run(_jax(fs, **kw), data)
    jmp = _jax(fs, **kw)
    jax_first = _run(jmp, data[:cut])
    ck = io.BytesIO()
    j_checkpoint.save_channels(ck, jmp)
    mp = _port(fs, **kw)
    meta = convert.load_jax_channels_checkpoint(ck, mp)
    assert meta["samples_in"] * 4 == cut
    rest = _run(mp, data[cut:])
    for a, b, pw, jw in zip(jax_first, rest, port_whole, jax_whole):
        _assert_lsb(a + b, jw)
        _assert_lsb(a + b, pw)


@pytest.mark.parametrize("fs,stages,out_rate,rates", CONFIGS)
def test_port_channels_checkpoint_resumes_in_jax(tmp_path, fs, stages, out_rate, rates):
    """The other way: the port saves after two chunks, the JAX package's own
    ``restore_channels`` loads the file and runs the rest."""
    data = _stream(2048 * 16 * 4 + 600, 5)
    kw = dict(stages=stages, out_rate=out_rate, rates=rates)
    cut = 2 * CHUNK
    jax_whole = _run(_jax(fs, **kw), data)
    mp = _port(fs, **kw)
    first = _run(mp, data[:cut])
    path = str(tmp_path / "port.npz")
    checkpoint.save_channels(path, mp)
    jmp = _jax(fs, **kw)
    meta = j_checkpoint.restore_channels(path, jmp)
    assert meta["samples_in"] * 4 == cut
    rest = _run(jmp, data[cut:])
    for a, b, jw in zip(first, rest, jax_whole):
        _assert_lsb(a + b, jw)


def test_port_cascade_checkpoint_resumes_in_the_jax_pallas_route(tmp_path):
    """A port checkpoint seeds the JAX fused cascade's TPU-layout carries
    (interpret mode) from the per-stage ``(C, T−1)`` histories it stores."""
    data = _stream(2048 * 16 * 3, 6)
    jax_whole = _run(_jax(stages="multi", impl="pallas"), data)
    mp = _port(stages="multi")
    first = _run(mp, data[:CHUNK])
    path = str(tmp_path / "port.npz")
    checkpoint.save_channels(path, mp)
    jmp = _jax(stages="multi", impl="pallas")
    j_checkpoint.restore_channels(path, jmp)
    rest = _run(jmp, data[CHUNK:])
    assert jmp._cascade_w is not None
    for a, b, jw in zip(first, rest, jax_whole):
        _assert_lsb(a + b, jw)


@pytest.mark.parametrize("stages", ["single", "auto"])
def test_stream_checkpoint_crosses_both_ways(tmp_path, stages):
    """The single-stream format: port save → JAX restore, and port save →
    port restore (bitwise)."""
    data = _stream(2048 * 16 * 4 + 600, 7)
    cut = 2 * CHUNK

    def port():
        pipe = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                        chunk_blocks=16, device="cpu")
        attach_resampler(pipe, 48000, stages=stages)
        return pipe

    def run(pipe, buf):
        out = io.BytesIO()
        pipe.run(io.BytesIO(buf), out)
        return out.getvalue()

    whole = run(port(), data)
    p1 = port()
    first = run(p1, data[:cut])
    path = str(tmp_path / "s.npz")
    checkpoint.save(path, p1)
    p2 = port()
    meta = checkpoint.restore(path, p2)
    assert meta["sample_offset"] * 4 == cut and not meta["drained"]
    assert first + run(p2, data[cut:]) == whole

    jpipe = JPipeline(FS, "i16", "i16", JConstScheduler(-15000.0),
                      chunk_blocks=16, impl="xla")
    j_attach(jpipe, 48000, stages=stages)
    jmeta = j_checkpoint.restore(path, jpipe)
    assert jmeta == meta
    _assert_lsb(first + run(jpipe, data[cut:]), whole)


# -- the command line -----------------------------------------------------------

def _cfg(tmp_path):
    cfg = {"channels": [{"name": "c0", "shift": -15000.0},
                        {"name": "c1", "shift": 20000.0, "center_offset": 100.0}]}
    (tmp_path / "ch.json").write_text(json.dumps(cfg))
    return ["channels", "--config", str(tmp_path / "ch.json"), "-s", str(FS),
            "-i", "i16", "--resample-to", "48000", "--chunk-blocks", "16",
            "--device", "cpu", "--log-level", "error"]


def _outputs(d):
    return {n: (d / f"{n}.iq").read_bytes() for n in ("c0", "c1")}


@pytest.mark.parametrize("stages", ["single", "auto"])
def test_cli_channels_save_then_load_appends(tmp_path, stages):
    """Cut at two chunks with --save-state, resume with --load-state and
    --input (the CLI seeks the capture itself and appends): the files equal
    the uninterrupted run's."""
    data = _stream(2048 * 16 * 4 + 600, 8)
    (tmp_path / "in.iq").write_bytes(data)
    base = _cfg(tmp_path) + ["--resample-stages", stages]
    assert cli.main(base + ["--output-dir", str(tmp_path / "full"),
                            "--input", str(tmp_path / "in.iq")]) == 0
    state = str(tmp_path / "state.npz")
    assert cli.main(base + ["--output-dir", str(tmp_path / "cut"),
                            "--save-state", state],
                    stdin=io.BytesIO(data[:2 * CHUNK])) == 0
    assert cli.main(base + ["--output-dir", str(tmp_path / "cut"),
                            "--load-state", state,
                            "--input", str(tmp_path / "in.iq")]) == 0
    assert _outputs(tmp_path / "cut") == _outputs(tmp_path / "full")
    assert all(len(v) > 0 for v in _outputs(tmp_path / "full").values())


def test_cli_channels_drained_checkpoint_is_a_no_op(tmp_path):
    """A checkpoint written after EOF + --drain is complete: loading it again
    appends nothing; if the capture has grown since, it is refused."""
    data = _stream(2048 * 32, 9)
    (tmp_path / "in.iq").write_bytes(data)
    state = str(tmp_path / "ck.npz")
    base = _cfg(tmp_path) + ["--resample-stages", "single", "--drain",
                             "--input", str(tmp_path / "in.iq"),
                             "--output-dir", str(tmp_path / "out")]
    assert cli.main(base + ["--save-state", state]) == 0
    first = _outputs(tmp_path / "out")
    assert all(len(v) > 0 for v in first.values())
    assert cli.main(base + ["--load-state", state]) == 0
    assert _outputs(tmp_path / "out") == first
    with open(tmp_path / "in.iq", "ab") as f:
        f.write(data[:8192])
    assert cli.main(base + ["--load-state", state]) == 1
    assert _outputs(tmp_path / "out") == first


def test_cli_load_state_errors_are_rc_1(tmp_path):
    base = _cfg(tmp_path) + ["--output-dir", str(tmp_path / "o")]
    assert cli.main(base + ["--load-state", str(tmp_path / "missing.npz")],
                    stdin=io.BytesIO(b"")) == 1
    state = str(tmp_path / "s.npz")
    assert cli.main(base + ["--save-state", state],
                    stdin=io.BytesIO(_stream(2048 * 16, 10))) == 0
    other = [a if a != "48000" else "128000" for a in base]
    assert cli.main(other + ["--load-state", state], stdin=io.BytesIO(b"")) == 1


class _SignalAfter(io.RawIOBase):
    """A capture that raises SIGTERM in this process once ``after`` bytes
    have been read, as an operator stopping a live run would."""

    def __init__(self, data: bytes, after: int):
        self._src = io.BytesIO(data)
        self._after = after

    def readable(self):
        return True

    def read(self, n=-1):
        out = self._src.read(n)
        if self._after is not None and self._src.tell() >= self._after:
            self._after = None
            os.kill(os.getpid(), signal.SIGTERM)
        return out


@pytest.mark.parametrize("mode", ["channels", "const"])
def test_cli_signal_stop_is_rc_130_without_drain(tmp_path, mode):
    """SIGTERM under --save-state: the chunk in flight finishes, the run
    stops at a chunk boundary with rc 130, nothing is drained, and the
    checkpoint resumes to exactly the uninterrupted (drained) output."""
    data = _stream(2048 * 16 * 4 + 600, 11)
    (tmp_path / "in.iq").write_bytes(data)
    state = str(tmp_path / "sig.npz")
    if mode == "channels":
        base = _cfg(tmp_path) + ["--drain"]
        out = lambda d: ["--output-dir", str(tmp_path / d)]      # noqa: E731
        read = lambda d: _outputs(tmp_path / d)                   # noqa: E731
    else:
        base = ["const", "-s", str(FS), "-i", "i16", "--shift", "-15000",
                "--resample-to", "48000", "--chunk-blocks", "16", "--drain",
                "--device", "cpu", "--log-level", "error"]
        out = lambda d: ["--output", str(tmp_path / f"{d}.iq")]   # noqa: E731
        read = lambda d: (tmp_path / f"{d}.iq").read_bytes()      # noqa: E731
    assert cli.main(base + out("full") + ["--input", str(tmp_path / "in.iq")]) == 0
    previous = signal.getsignal(signal.SIGTERM)
    rc = cli.main(base + out("cut") + ["--save-state", state],
                  stdin=_SignalAfter(data, CHUNK + 8192))
    assert rc == 130
    assert signal.getsignal(signal.SIGTERM) is previous   # handlers restored
    with np.load(state) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
    assert not meta["drained"]
    consumed = meta["samples_in" if mode == "channels" else "sample_offset"] * 4
    assert 0 < consumed < len(data) and consumed % CHUNK == 0
    assert cli.main(base + out("cut") + ["--load-state", state,
                                         "--input", str(tmp_path / "in.iq")]) == 0
    assert read("cut") == read("full")


def test_cli_stream_save_then_load_appends(tmp_path):
    """``track``/``const`` take the same flags: a resumed run seeks --input
    and appends to --output; a drained checkpoint is a no-op."""
    data = _stream(2048 * 16 * 3 + 100, 12)
    (tmp_path / "in.iq").write_bytes(data)
    base = ["const", "-s", str(FS), "-i", "i16", "--shift", "9000",
            "--resample-to", "48000", "--chunk-blocks", "16", "--drain",
            "--device", "cpu", "--log-level", "error"]
    assert cli.main(base + ["--input", str(tmp_path / "in.iq"),
                            "--output", str(tmp_path / "full.iq")]) == 0
    state = str(tmp_path / "s.npz")
    no_drain = [a for a in base if a != "--drain"]
    assert cli.main(no_drain + ["--output", str(tmp_path / "cut.iq"),
                                "--save-state", state],
                    stdin=io.BytesIO(data[:CHUNK])) == 0
    done = str(tmp_path / "done.npz")
    assert cli.main(base + ["--input", str(tmp_path / "in.iq"),
                            "--output", str(tmp_path / "cut.iq"),
                            "--load-state", state, "--save-state", done]) == 0
    whole = (tmp_path / "full.iq").read_bytes()
    assert (tmp_path / "cut.iq").read_bytes() == whole
    assert cli.main(base + ["--input", str(tmp_path / "in.iq"),
                            "--output", str(tmp_path / "cut.iq"),
                            "--load-state", done]) == 0
    assert (tmp_path / "cut.iq").read_bytes() == whole
