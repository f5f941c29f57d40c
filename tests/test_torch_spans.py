"""The run loops' chunk-keyed spans (``runtime/telemetry.py``): the eight
spans of every chunk in the loop's order, the early emit of a chunk whose
copy is done between the next chunk's block reads (``run_chunks``),
``host_s`` summed from them, the bounded ring with exact totals, the
planner's lane counters, and the CLI's ``spans:`` line after ``done:``."""

from __future__ import annotations

import io
import json
import logging

import numpy as np
import pytest
import torch

from doppler_tpu_torch import cli
from doppler_tpu_torch.ops.resample import attach_resampler
from doppler_tpu_torch.runtime import channels as channels_mod
from doppler_tpu_torch.runtime import pipeline as pipeline_mod
from doppler_tpu_torch.runtime import telemetry
from doppler_tpu_torch.runtime.channels import ChannelSpec, MultiChannelPipeline
from doppler_tpu_torch.runtime.pipeline import ConstScheduler, Pipeline

torch.set_num_threads(1)   # leave the other test workers their cores

FS = 1024000
L = 2048                   # samples a default 8192-byte block
B = 8
N_CHUNKS = 4               # three full chunks and a partial one


def _raw(n_samples: int, seed: int = 5) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(-9000, 9000, size=2 * n_samples,
                        dtype=np.int16).tobytes()


RAW = _raw(L * B * (N_CHUNKS - 1) + 3 * L + 100)


def _by_chunk(spans):
    """``{chunk: [(name, t0, t1), ...]}`` in the ring's order."""
    out: dict = {}
    for name, k, t0, t1 in spans.records:
        out.setdefault(k, []).append((name, t0, t1))
    return out


def _stream_run(prefetch):
    pipe = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                    chunk_blocks=B, prefetch_chunks=prefetch, device="cpu")
    attach_resampler(pipe, 48000, stages="auto")
    out = io.BytesIO()
    pipe.run(io.BytesIO(RAW), out)
    return pipe, [out]


def _channels_cascade_run():
    specs = [ChannelSpec(f"c{k}", ConstScheduler(1234.567 * (k + 1)))
             for k in range(3)]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, out_rate=48000,
                              resample_stages="multi", chunk_blocks=B,
                              device="cpu")
    writers = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(RAW), writers)
    assert mp._cascade_k > 0          # the full chunks took the cascade
    return mp, writers


# the channels planner's lane counters for 3 channels over 4 chunks: the
# three full chunks in the uniform lane, the partial one per channel; on
# the CPU every chunk but the last is emitted early
CHANNELS_COUNTERS = {"chunks": N_CHUNKS, "plans_uniform": 3,
                     "plans_per_channel": 1, "emits_early": N_CHUNKS - 1,
                     "chan_plans_periodic": 0, "chan_plans_uniform": 9,
                     "chan_plans_per_channel": 3}


# both pipelines run the one loop (``pipeline.run_chunks``): the stream
# with and without the reader thread, and channels through the cascade.
# On the CPU a chunk's copy is done at once, so the block reader's loop
# emits chunk k before the first block of chunk k + 1; the reader thread's
# chunks have no block boundaries, so chunk k is emitted after chunk k + 1
# is read and launched
@pytest.mark.parametrize("make, counters, early", [
    pytest.param(lambda: _stream_run(0),
                 {"chunks": N_CHUNKS, "emits_early": N_CHUNKS - 1}, True,
                 id="0"),
    pytest.param(lambda: _stream_run(2), {"chunks": N_CHUNKS}, False, id="2"),
    pytest.param(_channels_cascade_run, CHANNELS_COUNTERS, True,
                 id="channels-cascade"),
])
def test_every_chunk_has_the_eight_spans_in_the_loops_order(make, counters,
                                                            early):
    pipe, outs = make()
    assert all(len(out.getvalue()) > 0 for out in outs)
    spans = pipe.spans
    assert telemetry.last_spans() is spans
    assert spans.counters == counters
    chunks = _by_chunk(spans)
    assert sorted(chunks) == list(range(N_CHUNKS))
    for k, recs in chunks.items():
        assert [n for n, _, _ in recs] == list(telemetry.SPAN_NAMES)
        # each span starts where or after the one before it ends
        for (_, _, end), (_, start, _) in zip(recs, recs[1:]):
            assert start >= end
        # schedule, plan, stage, launch tile without a gap (channels: the
        # planner closes its plan span, the stage span opens after it)
        for (_, _, end), (name, start, _) in zip(recs[1:4], recs[2:5]):
            if isinstance(pipe, Pipeline) or name != "stage":
                assert start == end
        if k + 1 < N_CHUNKS:
            read_next, launch_next = chunks[k + 1][0], chunks[k + 1][4]
            assert (read_next[0], launch_next[0]) == ("read", "launch")
            assert read_next[2] <= launch_next[1]
            if early:
                # chunk k waits, is cut and written inside the next
                # chunk's read
                assert read_next[1] <= recs[5][1]
                assert recs[7][2] <= read_next[2]
            else:
                # one chunk deep: chunk k waits, is cut and written after
                # the next chunk is read and launched
                assert recs[5][1] >= launch_next[2]
    # the ring in the loop's order; a span is recorded when it ends
    head, tail = telemetry.SPAN_NAMES[:5], telemetry.SPAN_NAMES[5:]
    if early:
        # chunk k's wait, cut and write end before chunk k + 1's read does
        want = [(n, k) for k in range(N_CHUNKS)
                for n in telemetry.SPAN_NAMES]
    else:
        # chunk k's wait, cut and write follow chunk k + 1's read … launch
        want = [(n, 0) for n in head]
        for k in range(1, N_CHUNKS):
            want += [(n, k) for n in head] + [(n, k - 1) for n in tail]
        want += [(n, N_CHUNKS - 1) for n in tail]
    assert [(n, k) for n, k, _, _ in spans.records] == want


class _Blocks:
    """An input of ``n`` zero bytes that logs each read that returns some."""

    def __init__(self, n: int, log: list):
        self._f = io.BytesIO(bytes(n))
        self._log = log

    def read(self, n=-1):
        piece = self._f.read(n)
        if piece:
            self._log.append("b")
        return piece


def _loop_log(ready_after, *, blocks=7, stop_after=None):
    """Run ``run_chunks`` over ``blocks`` blocks in chunks of three with
    fake dispatch and emit: its log (``b`` a block read, ``D``/``E`` and
    the chunk a dispatch and an emit), the emits' ``(k, bytes_in,
    blocks)``, the counters and the return.  A chunk's finalizer is ready
    once ``ready_after`` blocks were read after its dispatch (never: None;
    no ``ready`` at all: "absent")."""
    log, emitted = [], []

    def dispatch(chunk, k):
        log.append(f"D{k}")
        if not chunk.data:
            return None

        def finalize():
            return b""
        if ready_after != "absent":
            start = log.count("b")
            finalize.ready = lambda: (ready_after is not None and
                                      log.count("b") - start >= ready_after)
        return finalize

    def emit(pending, bytes_in, n_blocks, k):
        log.append(f"E{k}")
        emitted.append((k, bytes_in, n_blocks))

    def should_stop():
        return (stop_after is not None
                and sum(e.startswith("D") for e in log) >= stop_after)

    spans = telemetry.Spans()
    eof = pipeline_mod.run_chunks(
        pipeline_mod.streaming.BlockReader(_Blocks(blocks * 8, log), 8), 3,
        spans, dispatch, emit, should_stop)
    return " ".join(log), emitted, spans.counters, eof


@pytest.mark.parametrize("ready_after, want, early", [
    # ready at once: chunk k before chunk k + 1's first block
    (0, "b b b D0 E0 b b b D1 E1 b D2 E2", 2),
    # ready after two blocks: chunk 0 lands after chunk 1's second block;
    # chunk 2 has one block, so chunk 1 falls back to after its dispatch
    (2, "b b b D0 b b E0 b D1 b D2 E1 E2", 1),
    # never ready, or no readiness test: each chunk after the next one's
    # dispatch
    (None, "b b b D0 b b b D1 E0 b D2 E1 E2", 0),
    ("absent", "b b b D0 b b b D1 E0 b D2 E1 E2", 0),
])
def test_run_chunks_emits_a_chunk_once_its_copy_is_done(ready_after, want,
                                                        early):
    log, emitted, counters, eof = _loop_log(ready_after)
    assert log == want
    # each chunk once, in order, with its own bytes and blocks
    assert emitted == [(0, 24, 3), (1, 24, 3), (2, 8, 1)]
    assert counters == ({"chunks": 3, "emits_early": early} if early
                        else {"chunks": 3})
    assert eof


def test_a_stop_between_chunks_emits_the_chunk_in_flight():
    log, emitted, counters, eof = _loop_log(0, stop_after=2)
    assert log == "b b b D0 E0 b b b D1 E1"
    assert [k for k, _, _ in emitted] == [0, 1]
    assert counters == {"chunks": 2, "emits_early": 1}
    assert not eof       # a pause: the caller must not drain


def test_host_s_is_the_schedule_plan_and_stage_spans():
    pipe = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                    chunk_blocks=B, device="cpu")
    attach_resampler(pipe, 48000, stages="auto")
    pipe.run(io.BytesIO(RAW), io.BytesIO())
    want = sum(t1 - t0 for n, _, t0, t1 in pipe.spans.records
               if n in ("schedule", "plan", "stage"))
    assert pipe.host_s > 0
    assert abs(pipe.host_s - want) <= 1e-9
    assert pipe.spans.totals["schedule"][0] == N_CHUNKS


def test_the_ring_drops_its_oldest_records_and_the_totals_stay_exact():
    spans = telemetry.Spans(capacity=16)
    for k in range(100):
        spans.add("read", k, float(k), k + 0.25)
        spans.add("write", k, k + 0.5, k + 1.0)
    spans.bump("chunks", 100)
    assert len(spans.records) == 16
    assert spans.records[0] == ("read", 92, 92.0, 92.25)
    assert spans.records[-1] == ("write", 99, 99.5, 100.0)
    assert spans.totals == {"read": [100, 25.0], "write": [100, 50.0]}
    assert spans.seconds("read", "write", "plan") == 75.0
    line = spans.summary()
    assert line.startswith("read 100 in 25.000000 s (p95 250.000 ms); "
                           "write 100 in 50.000000 s (p95 500.000 ms)")
    assert line.endswith("; chunks 100")
    assert telemetry.Spans().records.maxlen == 65536


def test_a_new_run_starts_a_new_recorder():
    pipe = Pipeline(FS, "i16", "i16", ConstScheduler(-15000.0),
                    chunk_blocks=B, device="cpu")
    pipe.run(io.BytesIO(RAW), io.BytesIO())
    first = pipe.spans
    pipe.run(io.BytesIO(RAW[:4 * L]), io.BytesIO())
    assert pipe.spans is not first and telemetry.last_spans() is pipe.spans
    assert pipe.spans.counters == {"chunks": 1}
    assert first.counters == {"chunks": N_CHUNKS, "emits_early": N_CHUNKS - 1}


def _channels(shifts, n_chunks=4):
    specs = [ChannelSpec(f"c{k}", ConstScheduler(s))
             for k, s in enumerate(shifts)]
    mp = MultiChannelPipeline(FS, "i16", "i16", specs, chunk_blocks=B,
                              device="cpu")
    writers = [io.BytesIO() for _ in specs]
    mp.run(io.BytesIO(_raw(L * B * n_chunks)), writers)
    assert all(len(w.getvalue()) == 4 * L * B * n_chunks for w in writers)
    return mp


def test_uniform_channels_count_the_uniform_lane():
    # f32 ratios with no short exact period: the vectorised lane, once the
    # first chunk has left the genesis state
    mp = _channels([1234.567 + 1000.0 * k for k in range(4)])
    c = mp.spans.counters
    assert c["chunks"] == 5                       # 4 full and the empty EOF
    assert c["plans_uniform"] == 3 and c["plans_per_channel"] == 1
    chunks = _by_chunk(mp.spans)
    for k in range(4):
        assert [n for n, _, _ in chunks[k]] == list(telemetry.SPAN_NAMES)
    assert [n for n, _, _ in chunks[4]] == ["read"]
    assert mp.host_s == mp.spans.seconds("schedule", "plan", "stage")


def test_a_short_exact_period_counts_the_per_channel_planners():
    # shift k · fs / 256: the ratio k / 256 has an exact period of 256 ≤ 2^20,
    # so every chunk, the genesis chunk too, plans in the periodic lane and
    # the per-channel planners' counters read none
    mp = _channels([FS / 256 * k for k in range(1, 5)])
    c = mp.spans.counters
    assert c["plans_uniform"] == 4 and "plans_per_channel" not in c
    assert c["chan_plans_periodic"] == 16
    assert c["chan_plans_uniform"] == c["chan_plans_per_channel"] == 0


class _Keep(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


@pytest.fixture
def fresh_logger():
    # the CLI binds its stderr handler to the stream it first sees
    logger = logging.getLogger("doppler_tpu_torch")
    logger.handlers.clear()
    yield logger
    logger.handlers.clear()


@pytest.fixture
def made(monkeypatch):
    """The pipeline the CLI builds."""
    got = {}
    for mod, name in ((pipeline_mod, "Pipeline"),
                      (channels_mod, "MultiChannelPipeline")):
        cls = getattr(mod, name)

        def make(*a, _cls=cls, **kw):
            got["pipe"] = _cls(*a, **kw)
            return got["pipe"]
        monkeypatch.setattr(mod, name, make)
    return got


@pytest.mark.parametrize("fmt", ["fern", "json"])
@pytest.mark.parametrize("mode", ["const", "channels"])
def test_the_cli_logs_spans_after_done(tmp_path, capsys, fresh_logger, made,
                                       mode, fmt):
    argv = [mode, "-s", str(FS), "-i", "i16", "--chunk-blocks", str(B),
            "--device", "cpu", "--log-format", fmt]
    if mode == "const":
        argv += ["--shift", "-15000", "--resample-to", "48000"]
    else:
        (tmp_path / "ch.json").write_text(json.dumps({"channels": [
            {"name": f"c{k}", "shift": 1234.567 * (k + 1)} for k in range(3)]}))
        argv += ["--config", str(tmp_path / "ch.json"),
                 "--output-dir", str(tmp_path / "out")]
    # the stderr handler first (the CLI formats it), the records beside it
    telemetry.setup_logger(fmt=fmt)
    keep = _Keep()
    fresh_logger.addHandler(keep)
    rc = cli.main(argv, stdin=io.BytesIO(RAW), stdout=io.BytesIO())
    assert rc == 0
    lines = capsys.readouterr().err.strip().splitlines()
    msgs = ([json.loads(ln)["msg"] for ln in lines] if fmt == "json"
            else [ln.split("]  ", 1)[1] for ln in lines])
    i = next(i for i, m in enumerate(msgs) if m.startswith("done:"))
    assert msgs[i + 1].startswith("spans: read ")
    assert "device wait" in msgs[i] and "device span" not in msgs[i]
    for name in telemetry.SPAN_NAMES:
        assert f"; {name} " in "; " + msgs[i + 1][len("spans: "):]
    assert "chunks " in msgs[i + 1]
    if mode == "channels":
        assert "plans_uniform " in msgs[i + 1]
        assert "plans_per_channel " in msgs[i + 1]
    done = next(r for r in keep.records
                if isinstance(r.msg, str) and r.msg.startswith("done:"))
    pipe = made["pipe"]
    assert done.args[-2] == pipe.host_s > 0
    assert done.args[-1] == pipe.spans.seconds("wait")
    assert pipe.spans is telemetry.last_spans()
