"""The host split on the CPU: ``parallel.distributed``, ``Pipeline``'s seek,
``--prefetch-chunks`` and the ``--distributed`` CLI, against the JAX package.

A pipeline seeked to block k with the raw history blocks before k holds,
right after the seek, exactly the state the uninterrupted run holds at k
(counters and FIR histories bitwise), and emits exactly its bytes from k on:
the prefix run's bytes and the seeked run's concatenate to the whole run's.
Against the JAX package's seeked pipeline (``impl='xla'``) the bytes agree
within the roadmap's bar, ≤ 1 LSB in under 1% of samples (its XLA dots sum
in another order).  The two-process runs join a gloo group over localhost,
each host reads its own byte range (or channel slice) of one capture, and
the concatenated part files equal the one-process run's bytes.
"""

import io
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from doppler_tpu.ops.resample import attach_resampler as j_attach_resampler
from doppler_tpu.parallel.distributed import host_slice as j_host_slice
from doppler_tpu.parallel.distributed import (
    parse_distributed_spec as j_parse_distributed_spec,
)
from doppler_tpu.runtime.pipeline import ConstScheduler as JConstScheduler
from doppler_tpu.runtime.pipeline import Pipeline as JPipeline
from doppler_tpu_torch import cli
from doppler_tpu_torch.ops.resample import attach_resampler
from doppler_tpu_torch.orbit import Observer, Predictor, RealtimeTrackScheduler, Tle
from doppler_tpu_torch.orbit.tle import _checksum
from doppler_tpu_torch.parallel import distributed
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 1024000


def _i16(n_samples, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-20000, 20000, size=2 * n_samples,
                        dtype=np.int16).astype("<i2").tobytes()


def _f32(n_samples, seed):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal(2 * n_samples)).astype("<f4").tobytes()


def _shift(fs):
    return 1e6 if fs >= 5_000_000 else -15000.0


def _port(fs, stages=None, *, chunk_blocks=16, block_bytes=8192, intype="i16",
          outtype="i16", precision="exact", **kw):
    p = Pipeline(fs, intype, outtype, ConstScheduler(_shift(fs)),
                 chunk_blocks=chunk_blocks, block_bytes=block_bytes,
                 precision=precision, device="cpu", **kw)
    if stages:
        attach_resampler(p, 48000, stages=stages)
    return p


def _jax(fs, stages=None, *, chunk_blocks=16, block_bytes=8192, impl="xla"):
    p = JPipeline(fs, "i16", "i16", JConstScheduler(_shift(fs)),
                  chunk_blocks=chunk_blocks, block_bytes=block_bytes,
                  impl=impl, pallas_interpret=impl == "pallas")
    if stages:
        j_attach_resampler(p, 48000.0, stages=stages)
    return p


def _run(pipe, raw):
    out = io.BytesIO()
    pipe.run(io.BytesIO(raw), out)
    return out.getvalue()


def _stages(pipe):
    rs = pipe.resampler
    return [] if rs is None else getattr(rs, "stages", [rs])


# -- parallel.distributed against the JAX package ---------------------------

@pytest.mark.parametrize("text", [
    "coordinator=127.0.0.1:9999,num_processes=2,process_id=1",
    " num_processes=4 , process_id=3 ,",
    "coordinator=h:1", "", "nonsense", "num_processes=two",
    "process_id=x", "bogus=1", "coordinator=a=b",
])
def test_parse_distributed_spec_matches_jax(text):
    try:
        want = j_parse_distributed_spec(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            distributed.parse_distributed_spec(text)
        assert str(got.value) == str(e)
        return
    assert distributed.parse_distributed_spec(text) == want


def test_host_slice_matches_jax():
    n = 0
    for C in (1, 3, 4, 16, 256):
        for B in (1, 5, 64, 1000):
            for pc in (1, 2, 3, 4, 8):
                for hc in (None, 1, 2, 4, pc):
                    for pi in range(pc):
                        kw = dict(process_index=pi, process_count=pc,
                                  channel_parallel_hosts=hc)
                        try:
                            want = j_host_slice(C, B, **kw)
                        except ValueError as e:
                            with pytest.raises(ValueError, match=str(e)):
                                distributed.host_slice(C, B, **kw)
                            continue
                        got = distributed.host_slice(C, B, **kw)
                        assert vars(got) == vars(want), (C, B, kw)
                        assert (got.byte_range(8192)
                                == want.byte_range(8192))
                        n += 1
    assert n > 1000
    # no group joined: this process is host 0 of 1
    assert vars(distributed.host_slice(4, 10)) == vars(
        j_host_slice(4, 10, process_index=0, process_count=1))


def test_resolve_spec_from_the_environment(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert distributed.resolve_spec() == {
        "coordinator_address": None, "num_processes": 1, "process_id": 0}
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "1234")
    assert distributed.resolve_spec() == {
        "coordinator_address": "10.0.0.7:1234", "num_processes": 3,
        "process_id": 2}
    # the spec's keys win over the environment
    assert distributed.resolve_spec("h:5", 2, 0) == {
        "coordinator_address": "h:5", "num_processes": 2, "process_id": 0}
    with pytest.raises(ValueError, match="process_id"):
        distributed.resolve_spec("h:5", 2, 2)
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(ValueError, match="coordinator"):
        distributed.resolve_spec(None, 2, 1)
    distributed.init(None, 1, 0)         # one process joins no group
    assert not torch.distributed.is_initialized()


# -- seek_history_blocks ----------------------------------------------------

@pytest.mark.parametrize("fs,stages,block_bytes", [
    (FS, "single", 8192),
    (FS, "multi", 8192),
    (FS, "multi", 8704),                 # 17 rows a block: odd-row geometry
    (FS, "multi", 8000),                 # L % 128 != 0: never fused
    (100_000_000, "multi", 8192),        # config 5's rate: the split route
    (6_250_000, "multi", 8192),
    (FS, None, 8192),
])
def test_seek_history_blocks_match_jax(fs, stages, block_bytes):
    """The port counts the JAX package's history (its fused carries are
    whole 128-sample rows), so both read the same bytes before a range."""
    cb = 32 if fs == 100_000_000 else 16
    got = _port(fs, stages, chunk_blocks=cb,
                block_bytes=block_bytes).seek_history_blocks()
    want = _jax(fs, stages, chunk_blocks=cb, block_bytes=block_bytes,
                impl="pallas").seek_history_blocks()
    assert got == want
    if fs == 100_000_000:
        assert got > 1


# -- seek, bitwise within the port ------------------------------------------

SEEK_CASES = {
    "mix-only": dict(fs=FS, stages=None),
    "chain": dict(fs=FS, stages="single"),
    "chain-fast": dict(fs=FS, stages="single", precision="fast"),
    "cascade": dict(fs=FS, stages="multi"),
    "cascade-8704": dict(fs=FS, stages="multi", block_bytes=8704),
    "mixer-route": dict(fs=FS, stages="single", block_bytes=8000),
    "cascade-unfused": dict(fs=FS, stages="multi", block_bytes=8000),
    "config5-rate": dict(fs=100_000_000, stages="multi", chunk_blocks=32),
    "chain-f32": dict(fs=FS, stages="single", intype="f32", outtype="f32"),
    "cascade-f32": dict(fs=FS, stages="multi", intype="f32", outtype="f32"),
}


@pytest.mark.parametrize("case", list(SEEK_CASES))
def test_seek_is_bitwise_the_uninterrupted_run(case):
    kw = dict(SEEK_CASES[case])
    fs, stages = kw.pop("fs"), kw.pop("stages")
    whole_p = _port(fs, stages, **kw)
    bb, cb = whole_p.block_bytes, whole_p.chunk_blocks
    k = 2 * cb                           # a chunk boundary: the host split's unit
    n_blocks = 3 * cb
    make = _f32 if kw.get("intype") == "f32" else _i16
    raw = make(n_blocks * (bb // (8 if make is _f32 else 4)) + 77, 11)
    n_hist = whole_p.seek_history_blocks()
    whole = _run(whole_p, raw)

    prefix_p = _port(fs, stages, **kw)
    prefix = _run(prefix_p, raw[:k * bb])
    seeked = _port(fs, stages, **kw)
    seeked.seek_to_block(k, history=raw[(k - n_hist) * bb:k * bb] if n_hist else None)
    # the replay's state is the state the stream holds at block k
    assert seeked._sample_offset == prefix_p._sample_offset
    assert seeked.nco_state == prefix_p.nco_state
    for a, b in zip(_stages(seeked), _stages(prefix_p), strict=True):
        assert (a.m_next, a.in_consumed) == (b.m_next, b.in_consumed)
        assert torch.equal(a._hist_i, b._hist_i)
        assert torch.equal(a._hist_q, b._hist_q)
    suffix = _run(seeked, raw[k * bb:])
    assert prefix + suffix == whole and suffix


@pytest.mark.parametrize("intype", ["i16", "f32"])
def test_zero_blocks_mix_to_zeros(intype):
    """The cascade replay's zero-prepadding: zero samples with zero plan
    words mix to (signed) zeros, so they add nothing to a real window."""
    from doppler_tpu_torch.ops.cuda.mixer import mix_blocks_fmt_plain

    shape = (3, 256) if intype == "i16" else (2, 3, 256)
    dtype = torch.int32 if intype == "i16" else torch.float32
    out = mix_blocks_fmt_plain(torch.zeros(shape, dtype=dtype),
                               torch.zeros((7, 3), dtype=torch.int32),
                               intype=intype, outtype="f32")
    assert out.abs().max() == 0


def test_seek_to_block_zero_and_without_history():
    raw = _i16(2048 * 40 + 5, 3)
    p = _port(FS, "multi")
    p.seek_to_block(0)                  # block 0: nothing to rebuild
    assert _run(p, raw) == _run(_port(FS, "multi"), raw)


# -- seek against the JAX package -------------------------------------------

def _lsb_check(got, want):
    a = np.frombuffer(got, dtype="<i2").astype(np.int32)
    b = np.frombuffer(want, dtype="<i2").astype(np.int32)
    assert a.shape == b.shape and a.size > 0
    d = np.abs(a - b)
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("fs,stages,cb", [
    (FS, "single", 16), (FS, "multi", 16), (100_000_000, "multi", 32)])
def test_seeked_bytes_agree_with_the_jax_package(fs, stages, cb):
    p = _port(fs, stages, chunk_blocks=cb)
    jp = _jax(fs, stages, chunk_blocks=cb)
    n_hist = p.seek_history_blocks()     # the fused count: ≥ what XLA needs
    k = 2 * cb
    raw = _i16(2048 * 3 * cb + 301, 5)
    history = raw[(k - n_hist) * 8192:k * 8192]
    p.seek_to_block(k, history=history)
    jp.seek_to_block(k, history=history)
    _lsb_check(_run(p, raw[k * 8192:]), _run(jp, raw[k * 8192:]))


# -- rejections ---------------------------------------------------------------

def test_seek_rejections():
    with pytest.raises(ValueError, match="history"):
        _port(FS, "single").seek_to_block(16)          # no history
    with pytest.raises(ValueError, match="history"):
        _port(FS, "multi").seek_to_block(16, history=b"\0" * 100)
    heavy = _port(100_000_000, "multi", chunk_blocks=32)
    assert heavy.seek_history_blocks() > 1
    with pytest.raises(ValueError, match="too short"):
        heavy.seek_to_block(64, history=b"\0" * 8192)  # one block of many
    p = _port(FS, None)
    p._sample_offset = 5
    with pytest.raises(ValueError, match="fresh"):
        p.seek_to_block(16)
    with pytest.raises(ValueError, match=">= 0"):
        _port(FS, None).seek_to_block(-1)


# -- --prefetch-chunks and the paced realtime run ------------------------------

def test_prefetch_chunks_gives_the_same_bytes(tmp_path):
    raw = _i16(2048 * 16 * 3 + 999, 9)
    want = _run(_port(FS, "multi"), raw)
    assert _run(_port(FS, "multi", prefetch_chunks=2), raw) == want
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    outs = []
    for depth in ("0", "2"):
        out = tmp_path / f"out{depth}.iq"
        assert cli.main(["const", "-s", str(FS), "-i", "i16", "--shift",
                         "-15000", "--resample-to", "48000", "--chunk-blocks",
                         "16", "--prefetch-chunks", depth, "--device", "cpu",
                         "--log-level", "error", "--input", str(inp),
                         "--output", str(out)]) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == want
    # channels mode accepts the flag and ignores it, as the JAX CLI does
    cfg = tmp_path / "ch.json"
    cfg.write_text(json.dumps({"channels": [{"name": "a", "shift": 1000.0}]}))
    assert cli.main(["channels", "-s", str(FS), "-i", "i16", "--config",
                     str(cfg), "--output-dir", str(tmp_path / "ch"),
                     "--prefetch-chunks", "2", "--device", "cpu",
                     "--log-level", "error", "--input", str(inp)]) == 0
    assert (tmp_path / "ch" / "a.iq").stat().st_size == len(raw)


def _fix(line):
    line = line.ljust(68)[:68]
    return line + str(_checksum(line))


TLE = ("T", _fix("1 88888U          80275.98708465  .00073094  13844-3  66816-4 0    8"),
       _fix("2 88888  72.8435 115.9689 0086731  52.6988 110.5714 16.05824518  105"))
EPOCH_UNIX = (2444514.48708465 - 2440587.5) * 86400.0


class _PacedSource(io.RawIOBase):
    """A receiver at 1×: each read hands out the next bytes of the capture
    and moves the fake clock to the moment the last of them arrived."""

    def __init__(self, data, clock, fs):
        self._data, self._pos = data, 0
        self._clock, self._fs = clock, fs

    def readable(self):
        return True

    def read(self, n=-1):
        n = len(self._data) - self._pos if n < 0 else n
        piece = self._data[self._pos:self._pos + n]
        self._pos += len(piece)
        self._clock.advance(len(piece) // 4 / self._fs)
        return piece


class _FakeClock:
    def __init__(self, t0):
        self.t = t0
        self.reads = []                  # the value of every call

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        self.reads.append(self.t)
        return self.t


class _ListScheduler:
    def __init__(self, shifts):
        self._shifts = list(shifts)

    def shifts(self, counts):
        out, self._shifts = self._shifts[:len(counts)], self._shifts[len(counts):]
        return out


@pytest.mark.parametrize("depth", [0, 2])
def test_paced_realtime_run(depth):
    """A capture delivered at 1× through ``Pipeline.run`` with
    ``RealtimeTrackScheduler`` on a fake clock: every block's shift is the
    Doppler curve at its predicted arrival within one chunk (depth 0; the
    prefetcher's bounded queue adds at most depth + 1 chunks), telemetry
    fires at a ≥ 1 s cadence of stream time, no sample is dropped, and the
    bytes are the pipeline's with those shifts given."""
    fs, L, B = 256000, 2048, 8           # 'auto' chunk at 256 ksps: 64 ms
    bd = L / fs
    n_blocks = 8 * 40 + 3                # 2.6 s of stream
    raw = _i16(n_blocks * L + 100, 13)
    t0 = EPOCH_UNIX + 300.0
    clock = _FakeClock(t0)
    pred = Predictor(Tle.from_lines(*TLE), Observer(58.26541, 26.46667, 76.0))
    sched = RealtimeTrackScheduler(pred, 437505000.0, 5000.0, fs, clock=clock)
    record = []

    class Recording:
        def shifts(self, counts):
            out = list(sched.shifts(counts))
            record.append((clock.reads[-1], len(counts), out))
            return out

    lines = []
    handler = logging.Handler()
    handler.emit = lambda r: lines.append(r.getMessage())
    logger = logging.getLogger("doppler_tpu_torch.track")
    old_level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        p = Pipeline(fs, "i16", "i16", Recording(), chunk_blocks=B,
                     prefetch_chunks=depth, device="cpu")
        out = io.BytesIO()
        p.run(_PacedSource(raw, clock, fs), out)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    got = out.getvalue()
    assert len(got) == len(raw) // 4 * 4          # nothing dropped

    lag = B * bd * (depth + 2 if depth else 1)
    tol = 1e-4                           # float64 sums of block times at ~3e8 s
    shifts, k = [], 0
    for now, n, out_shifts in record:
        for j in range(n):
            arrival = t0 + (k + 1) * bd          # block k fully delivered
            at = now + j * bd                    # where the scheduler put it
            assert -tol <= at - arrival <= lag + tol, (k, at - arrival)
            dop, _ = pred.doppler_hz(at, 437505000.0)
            assert out_shifts[j] == float(np.float32(dop) + np.float32(5000.0))
            k += 1
        shifts += out_shifts
    assert k == n_blocks + 1                      # + the ragged last block
    if depth == 0:
        # each chunk is planned the moment its last block arrived
        assert all(abs(now - (t0 + (c + 1) * B * bd)) < tol
                   for c, (now, _, _) in enumerate(record[:-1]))
    stamps = [m for m in lines if m.startswith("time")]
    span = record[-1][0] - t0
    assert int(span) - 1 <= len(stamps) <= int(span) + 1, (len(stamps), span)
    want = _run(Pipeline(fs, "i16", "i16", _ListScheduler(shifts),
                         chunk_blocks=B, device="cpu"), raw)
    assert got == want


# -- the CLI ------------------------------------------------------------------

def test_cli_checks_a_split_run_before_the_rendezvous(tmp_path):
    """A bad configuration fails at once (rc 1) instead of waiting in the
    group for its peers: nothing listens on the coordinator's port."""
    inp = tmp_path / "in.iq"
    inp.write_bytes(_i16(4096, 1))
    dist = ["--distributed", "coordinator=127.0.0.1:9,num_processes=2,process_id=0"]
    const = ["const", "-s", str(FS), "-i", "i16", "--shift", "1", "--device",
             "cpu", "--log-level", "error"]
    track = ["track", "-s", str(FS), "-i", "i16", "--tlefile", "x.txt",
             "--tlename", "T", "--location", "lat=1,lon=2,alt=3",
             "--frequency", "1e8", "--device", "cpu", "--log-level", "error"]
    cfg = tmp_path / "ch.json"
    cfg.write_text(json.dumps({"channels": [{"name": "a", "shift": 1.0}]}))
    chans = ["channels", "-s", str(FS), "-i", "i16", "--config", str(cfg),
             "--device", "cpu", "--log-level", "error"]
    t0 = time.perf_counter()
    for argv in (const + dist + ["--output", "o"],              # no --input
                 const + dist + ["--input", str(inp)],          # no --output
                 track + dist + ["--input", str(inp), "--output", "o"],  # no --time
                 chans + dist + ["--input", str(inp), "--host-channels", "3"],
                 const + ["--distributed", "num_processes=2,process_id=5",
                          "--input", str(inp), "--output", "o"],
                 const + ["--distributed", "nonsense"]):
        assert cli.main(argv, stdin=io.BytesIO(), stdout=io.BytesIO()) == 1, argv
    assert time.perf_counter() - t0 < 30
    # one process: no group, no split, the plain run
    out = tmp_path / "one.iq"
    assert cli.main(const + ["--distributed", "num_processes=1", "--input",
                             str(inp), "--output", str(out)]) == 0
    assert out.stat().st_size == inp.stat().st_size
    assert not torch.distributed.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(argv):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "doppler_tpu_torch"] + argv
        + ["--device", "cpu", "--log-format", "json"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=env)


def _wait(procs, timeout=240):
    """Each process's (rc, stderr); kills what is left on a timeout."""
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            out.append((p.returncode, err.decode()[-3000:]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _two_hosts(argv, extra=()):
    port = _free_port()
    return [_spawn(argv + list(extra) + [
        "--distributed",
        f"coordinator=127.0.0.1:{port},num_processes=2,process_id={pid}"])
        for pid in range(2)]


def _one_process(argv):
    assert cli.main(argv + ["--device", "cpu", "--log-level", "error"]) == 0


def _parts(out):
    return out.with_name(out.name + ".part0").read_bytes() + out.with_name(
        out.name + ".part1").read_bytes()


@pytest.mark.parametrize("fs", [
    FS,                                  # config 3's default route: cascade
    6_250_000,                           # heavy odd-Q rate: multi-block history
])
def test_two_process_stream_split(tmp_path, fs):
    """Two CLI processes, one shared capture, chunk-aligned byte ranges:
    concat(out.part0, out.part1) == the one-process output."""
    raw = _i16(2048 * 16 * 5 + 3111, 21)
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    base = ["const", "-s", str(fs), "-i", "i16", "--shift", str(_shift(fs)),
            "--resample-to", "48000", "--chunk-blocks", "16",
            "--input", str(inp)]
    if fs != FS:
        assert _port(fs, "multi").seek_history_blocks() > 1
    single = tmp_path / "single.iq"
    _one_process(base + ["--output", str(single)])
    out = tmp_path / "out.iq"
    for rc, err in _wait(_two_hosts(base + ["--output", str(out)])):
        assert rc == 0, err
    assert _parts(out) == single.read_bytes() and single.stat().st_size > 0


def test_two_process_elastic_restart(tmp_path):
    """Host 0 of a two-process run is stopped mid-stream with
    ``--save-state``; both restart with ``--load-state`` (``PATH.hK``), host
    0 appending to its part file.  The parts equal the one-process bytes;
    a third start on the completed checkpoints (host 1's drained) appends
    nothing."""
    raw = _i16(2048 * 16 * 24, 22)
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    out = tmp_path / "out.iq"
    ck = tmp_path / "ck.npz"
    base = ["const", "-s", str(FS), "-i", "i16", "--shift", "-15000",
            "--resample-to", "48000", "--resample-stages", "single",
            "--chunk-blocks", "16", "--drain", "--input", str(inp)]
    single = tmp_path / "single.iq"
    _one_process(base + ["--output", str(single)])

    base += ["--output", str(out)]
    procs = _two_hosts(base, ["--save-state", str(ck)])
    part0 = tmp_path / "out.iq.part0"
    deadline = time.time() + 120
    while time.time() < deadline and procs[0].poll() is None:
        if part0.exists() and part0.stat().st_size > 0:
            procs[0].send_signal(signal.SIGTERM)
            break
        time.sleep(0.01)
    (rc0, err0), (rc1, err1) = _wait(procs)
    assert rc0 in (0, 130) and rc1 == 0, (err0, err1)
    assert (tmp_path / "ck.npz.h0").exists() and (tmp_path / "ck.npz.h1").exists()

    for extra in (["--load-state", str(ck), "--save-state", str(ck)],
                  ["--load-state", str(ck)]):
        for rc, err in _wait(_two_hosts(base, extra)):
            assert rc == 0, err
        assert _parts(out) == single.read_bytes() and single.stat().st_size > 0


def test_two_process_channels_split(tmp_path):
    """Channels mode: hosts split the channel axis, each checkpointing its
    own slice (``PATH.hK``); every channel's file equals the one-process
    run's."""
    raw = _i16(2048 * 16 * 2 + 777, 23)
    inp = tmp_path / "in.iq"
    inp.write_bytes(raw)
    cfg = tmp_path / "chan.json"
    cfg.write_text(json.dumps({"channels": [
        {"name": f"ch{k}", "shift": -30000.0 + 9000 * k,
         "center_offset": 250.0 * k} for k in range(4)]}))

    def argv(outdir):
        return ["channels", "-s", str(FS), "-i", "i16", "--config", str(cfg),
                "--resample-to", "48000", "--chunk-blocks", "16",
                "--input", str(inp), "--output-dir", str(outdir)]

    _one_process(argv(tmp_path / "single"))
    ck = tmp_path / "ck.npz"
    # the second start resumes each host's own checkpoint at the end of the
    # capture: it appends nothing
    for extra in (["--save-state", str(ck)], ["--load-state", str(ck)]):
        for rc, err in _wait(_two_hosts(argv(tmp_path / "dist"), extra)):
            assert rc == 0, err
        for k in range(4):
            a = (tmp_path / "single" / f"ch{k}.iq").read_bytes()
            assert (tmp_path / "dist" / f"ch{k}.iq").read_bytes() == a and a
    assert (tmp_path / "ck.npz.h0").exists() and (tmp_path / "ck.npz.h1").exists()
