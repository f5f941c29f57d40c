"""One run of a cell: make its capture, warm the program, measure a window.

Every cell drives ``doppler_tpu_torch.cli.main(argv, stdin=, stdout=)`` in
this process, as a user's pipe would: the source of :mod:`.traffic` is its
standard input; in ``const`` and ``track`` mode the :class:`.traffic.Sink`
is its standard output, and in ``channels`` mode it writes one file a
channel under ``--output-dir`` in the run's working directory (under
``TMPDIR``), which is read back after the window.  A warm call of the same
arguments on a short input comes first; the timed call then runs until the
source ends the stream at the close of the window, and the CLI drains and
returns: that call is the measured window.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np

from benchmark.capture import make_capture
from benchmark.cell import Cell
from benchmark.reference.schedule import expand_channels
from benchmark.trace import Tracer
from benchmark.traffic import ReplaySource, Sink, make_source

__all__ = ["Run", "drive", "build_argv", "launch_counts", "FUSED"]

_BPS = 4                      # bytes of an i16 IQ pair


@dataclass
class Run:
    """What a run measured and kept, for the metric readers and the check."""

    cell: Cell
    seed: int
    setup_s: float = 0.0
    wall_s: float = 0.0
    n_in: int = 0
    host_s: float = float("nan")
    memory_peak_bytes: int = 0
    source: object = None
    sink: object = None
    outputs: list = field(default_factory=list)
    capture: np.ndarray | None = None
    stretch: object = None
    argv: list = field(default_factory=list)
    setup_parts: list = field(default_factory=list)


class _DoneLine(logging.Handler):
    """Keeps the CLI's ``done:`` record (its host plan + stage seconds)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.args = None

    def emit(self, record: logging.LogRecord) -> None:
        if isinstance(record.msg, str) and record.msg.startswith("done:"):
            self.args = record.args


def build_argv(config: dict, traffic: dict, workdir: str, out_dir: str,
               device: str) -> list:
    """The CLI arguments of a cell.  The configuration's ``argv`` may name
    ``{output_dir}``, ``{block_bytes}``; ``{channels}``, a channel file
    written from its
    channels; and, from its first tracked channel, ``{tlefile}`` (written
    here), ``{tlename}``, ``{location}``, ``{time}``, ``{frequency}`` and
    ``{offset}``."""
    chans = expand_channels(config)
    subs = {"output_dir": out_dir, "block_bytes": config["block_bytes"]}
    track = [c["track"] for c in chans if "track" in c]
    if track:
        t = track[0]
        subs["tlefile"] = os.path.join(workdir, "sat.txt")
        with open(subs["tlefile"], "w") as f:
            f.write(f"{t['name']}\n{t['tle'][0]}\n{t['tle'][1]}\n")
        loc = t["location"]
        subs.update(tlename=t["name"], time=t["time"],
                    frequency=repr(float(t["frequency"])),
                    offset=repr(float(t.get("offset", 0.0))),
                    location=f"lat={loc['lat']!r},lon={loc['lon']!r},"
                             f"alt={loc['alt']!r}")
    if config["mode"] == "channels":
        subs["channels"] = os.path.join(workdir, "channels.json")
        with open(subs["channels"], "w") as f:
            json.dump({"channels": chans}, f)
    argv = [a.format(**subs) for a in config["argv"]]
    return argv + list(traffic.get("argv", [])) + ["--device", device]


FUSED = ("cascade", "cascade_channels", "chain")   # one launch a chunk


def launch_counts() -> dict:
    """The program's own launch counters of the fused kernels and of the
    resampler's kernel (program counters)."""
    from doppler_tpu_torch.ops.cuda import cascade, chain
    from doppler_tpu_torch.ops.resample import window_resample

    return {"cascade": cascade.mix_cascade_stream.launches,
            "cascade_channels": cascade.mix_cascade_channels.launches,
            "chain": chain.mix_resample_chain_stream.launches,
            "window": window_resample.launches}


def _read_outputs(config: dict, out_dir: str, sink: Sink) -> list:
    if config["mode"] != "channels":
        return [np.frombuffer(bytes(sink.data), dtype="<i2").reshape(-1, 2)]
    outs = []
    for ch in expand_channels(config):
        with open(os.path.join(out_dir, f"{ch['name']}.iq"), "rb") as f:
            outs.append(np.frombuffer(f.read(), dtype="<i2").reshape(-1, 2))
    return outs


def drive(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
          t_process: float, workdir: str) -> Run:
    """Set up, warm, and measure one window of ``cell``."""
    import torch

    from doppler_tpu_torch import cli

    cfg, traffic = cell.config, cell.traffic
    run = Run(cell, seed)
    marks = [("imports", time.perf_counter())]
    cap = make_capture(cfg, seed, device)
    run.capture = cap.cpu().numpy()
    del cap
    buf = run.capture.tobytes()
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    marks.append(("capture", time.perf_counter()))
    warm_dir, out_dir = (os.path.join(workdir, d) for d in ("warm", "out"))
    argv_warm = build_argv(cfg, traffic, workdir, warm_dir, device)
    run.argv = build_argv(cfg, traffic, workdir, out_dir, device)
    rc = cli.main(argv_warm, stdin=ReplaySource(
        buf, limit=int(cfg["warm_samples"]) * _BPS),
        stdout=Sink(_BPS, keep=False))
    if rc != 0:
        raise RuntimeError(f"the warm call returned {rc}")
    marks.append(("warm call", time.perf_counter()))
    done = _DoneLine()
    logging.getLogger("doppler_tpu_torch").addHandler(done)

    sink = Sink(_BPS)
    tracer = None
    if trace:
        Tracer.warm()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    run.setup_s = t0 - t_process
    marks.append(("tracer" if trace else "sync", t0))
    run.setup_parts = [(name, t - prev) for (name, t), prev in
                       zip(marks, [t_process] + [t for _, t in marks[:-1]])]

    def on_read(now):
        if tracer is not None:
            tracer.poll(now, source.bytes)

    source = make_source(traffic, buf, t0=t0, seconds=seconds,
                         bytes_per_sample=_BPS,
                         samplerate=int(cfg["samplerate"]), on_read=on_read)
    if trace:
        # one stretch from 40% of the window, a fifth of it, at most 4 s
        tracer = Tracer(t0 + 0.4 * seconds, min(0.2 * seconds, 4.0),
                        launch_counts, [source.spans, sink.spans], workdir)
    try:
        rc = cli.main(run.argv, stdin=source, stdout=sink)
        if on_card:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        if tracer is not None:
            tracer.close()
    finally:
        logging.getLogger("doppler_tpu_torch").removeHandler(done)
    if rc != 0:
        raise RuntimeError(f"the timed call returned {rc}")
    run.wall_s = t1 - t0
    run.n_in = source.bytes // _BPS
    run.memory_peak_bytes = (int(torch.cuda.max_memory_allocated())
                             if on_card else 0)
    if done.args is not None:
        run.host_s = float(done.args[-2])
    run.source, run.sink = source, sink
    run.outputs = _read_outputs(cfg, out_dir, sink)
    if tracer is not None:
        tracer.read_back(_complete)
        run.stretch = tracer.stretch
    return run


def _complete(st) -> bool:
    """Does the stretch hold a record of every fused launch it saw?"""
    fused = sum(st.launches.get(k, 0) for k in FUSED)
    seen = sum(1 for name, _, _ in st.events
               if "cascade_kernel" in name or "chain_kernel" in name)
    return fused > 0 and seen == fused
