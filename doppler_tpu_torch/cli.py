"""``doppler``-compatible command line on one GPU: const, track, channels.

Flag-compatible with ``doppler_tpu/cli.py`` for what this package runs:

- ``const``: ``-s/--samplerate``, ``-i/--intype {i16,f32}``,
  ``-o/--outtype`` (defaults to intype), ``--shift Hz``.
- ``track``: the same I/O flags plus ``--tlefile``, ``--tlename``,
  ``--location lat=..,lon=..,alt=..``, ``--time UTC``
  (``%Y-%m-%dT%H:%M:%S``), ``--frequency Hz``, ``--offset Hz``.
- ``channels``: the I/O flags plus ``--config JSON`` (see
  ``docs/channels.md``) and ``--output-dir DIR``: N channels out of one
  wideband capture, one ``<name>.iq`` file per channel.
- framework flags: ``--block-bytes``, ``--chunk-blocks``,
  ``--resample-to``, ``--resample-stages {single,auto,multi}`` (default
  ``auto``: the halfband cascade when decimating by 4× or more, as in the
  JAX package), ``--exact-ratio``, ``--drain``, ``--log-format``,
  ``--log-level``, ``--input``, ``--output``, ``--save-state`` /
  ``--load-state`` (a resumable checkpoint in the JAX package's format;
  a resumed run seeks ``--input`` and appends to its output),
  ``--prefetch-chunks DEPTH`` (a reader thread stages chunks ahead; channels
  mode accepts and ignores it, as the JAX CLI does),
  ``--distributed SPEC`` and ``--host-channels HC`` (processes split the
  capture by chunk-aligned byte range, or channels mode by channel, with no
  traffic between them: each seeks to its range; host k writes
  ``FILE.partK`` and checkpoints ``PATH.hK``),
  ``--precision {exact,fast}`` (default ``exact``; ``fast`` runs the
  single-stage chain's FIR dot, stream and channel-batched, on bf16 tensor
  cores as three exact products a tap, within 1 LSB of ``exact``; cascades,
  the EOF chunk and ``--mesh`` stay exact), ``--mesh SPEC`` (``time=T`` or
  ``time=T,channel=C``, channel > 1 only in channels mode: each chunk is
  sharded over a grid of the local cards, ``parallel.mesh``; the bytes are
  the unsharded run's) and ``--device {cuda,cpu}`` (default ``cuda``; no
  silent CPU fallback; with ``cpu`` every shard of a mesh is the CPU).
- the JAX package's implementation flags, with its choices and defaults:
  ``--impl {auto,xla,pallas}`` (``auto`` and ``pallas``: the fused chain
  and cascade kernels where the gates take a chunk; ``xla``: the unfused
  route, the mixer kernel and then the resampler on every chunk — unfused,
  not the plain versions), ``--resample-impl {auto,conv,window}`` (the
  resampler's form: ``conv`` is the banded windows-matmul,
  ``csrc/conv.cu`` on the card; ``auto`` means ``window`` here, because
  the fused kernels compute the ``window`` bytes and the EOF chunk of the
  same stream takes the resampler; channels mode ignores the flag, as the
  JAX CLI does) and ``--platform {cpu,tpu,default}`` (``cpu`` is
  ``--device cpu``, and ``--device cuda`` beside it is a usage error;
  ``default`` leaves ``--device`` as it is; ``tpu`` is a usage error: there
  is no TPU here, use ``--device``).  Usage errors exit with 2.

IQ bytes flow stdin → stdout; telemetry goes to stderr only (main.rs:212-233).
"""

from __future__ import annotations

import argparse
import calendar
import contextlib
import os
import signal
import sys
import time as _time

__all__ = ["main", "build_parser", "parse_location", "parse_mesh"]


def stream_bps(dtype: str) -> int:
    from doppler_tpu_torch.runtime.stream import bytes_per_sample

    return bytes_per_sample(dtype)


def parse_location(text: str):
    """``lat=58.64560,lon=23.15163,alt=8`` → (lat, lon, alt) floats.

    Mirrors usage.rs:85-115: keys may appear in any order; every key must
    parse as a float; otherwise a usage error.
    """
    if not ("lat" in text and "lon" in text and "alt" in text):
        raise ValueError(
            "--location should be defined as: lat=58.64560,lon=23.15163,alt=8"
        )
    vals: dict[str, float] = {}
    for part in text.split(","):
        if "=" not in part:
            continue
        key, _, raw = part.partition("=")
        key = key.strip()
        if key in ("lat", "lon", "alt"):
            try:
                vals[key] = float(raw)
            except ValueError:
                pass
    if set(vals) != {"lat", "lon", "alt"}:
        raise ValueError(
            f"{text!r} isn't a valid value for --location "
            "[use as: lat=58.64560,lon=23.15163,alt=8]"
        )
    return vals["lat"], vals["lon"], vals["alt"]


def parse_mesh(text: str) -> tuple[int, int]:
    """``time=2,channel=4`` → (time, channel); either key may be omitted."""
    vals = {"time": 1, "channel": 1}
    for part in text.split(","):
        key, _, raw = part.partition("=")
        key = key.strip()
        if key not in vals:
            raise ValueError(
                f"{text!r} isn't a valid value for --mesh "
                "[use as: time=2,channel=4]"
            )
        try:
            vals[key] = int(raw)
        except ValueError:
            raise ValueError(f"--mesh {key} must be an integer") from None
    if vals["time"] < 1 or vals["channel"] < 1:
        raise ValueError("--mesh axes must be >= 1")
    return vals["time"], vals["channel"]


def parse_time_utc(text: str) -> float:
    """``%Y-%m-%dT%H:%M:%S`` UTC → unix seconds (usage.rs:303-313)."""
    try:
        st = _time.strptime(text, "%Y-%m-%dT%H:%M:%S")
    except ValueError as e:
        raise ValueError(
            f"{e}. --time should be defined in Y-m-dTH:M:S format: "
            "eg. 2015-05-13T14:28:48"
        ) from None
    return float(calendar.timegm(st))


def _add_io_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("-s", "--samplerate", type=int, required=True,
                   help="IQ data samplerate")
    p.add_argument("-i", "--intype", choices=["i16", "f32"], required=True,
                   help="IQ data input type")
    p.add_argument("-o", "--outtype", choices=["i16", "f32"],
                   help="IQ data output type (default: same as --intype)")
    p.add_argument("--block-bytes", type=int, default=8192,
                   help="stream framing block size in bytes (reference: 8192)")
    p.add_argument("--chunk-blocks", default=None,
                   help="blocks per device dispatch (int), or 'auto' to "
                        "target ~64 ms of stream per dispatch (default: "
                        "'auto' in realtime track mode, 256 elsewhere)")
    p.add_argument("--prefetch-chunks", type=int, default=0, metavar="DEPTH",
                   help="stage up to DEPTH input chunks on a reader thread "
                        "(overlaps stdin I/O with device compute; 0 = off)")
    p.add_argument("--resample-to", type=float, default=None, metavar="RATE",
                   help="polyphase-resample output to RATE sps after mixing")
    p.add_argument("--resample-stages", choices=["single", "auto", "multi"],
                   default="auto",
                   help="resampler structure: 'auto' (default) uses the "
                        "multi-stage halfband cascade (fused into one CUDA "
                        "kernel) when decimating ≥4x and the single-stage "
                        "polyphase design otherwise; 'single'/'multi' force "
                        "one structure")
    p.add_argument("--resample-impl", choices=["auto", "conv", "window"],
                   default="auto",
                   help="resampler formulation: banded windows-matmul "
                        "(conv, a CUDA kernel on the card) or gather+fixed-"
                        "tree (window); 'auto' (default) is window, the "
                        "bytes of the fused kernels.  Channels mode ignores "
                        "it, as the JAX CLI does")
    p.add_argument("--exact-ratio", action="store_true",
                   help="use exact rational NCO rate instead of mirroring the "
                        "reference's f32-rounded shift/samplerate ratio")
    p.add_argument("--impl", choices=["auto", "xla", "pallas"], default="auto",
                   help="'pallas' and 'auto' (default) run the fused chain "
                        "and cascade kernels where they take a chunk; 'xla' "
                        "runs the unfused route on every chunk: the mixer "
                        "kernel, then the resampler")
    p.add_argument("--precision", choices=["exact", "fast"], default="exact",
                   help="resampler dot precision: 'exact' (default) sums "
                        "float32 products; 'fast' runs the fused single-"
                        "stage chain (stream and channels) as three bf16 "
                        "tensor-core products a tap (x_h·t_h + x_h·t_l + "
                        "x_l·t_h), within 1 LSB of 'exact'; cascades and "
                        "the EOF chunk stay exact")
    p.add_argument("--drain", action="store_true",
                   help="flush the resampler FIR tail with zeros at EOF")
    p.add_argument("--log-format", choices=["fern", "json"], default="fern",
                   help="stderr telemetry format")
    p.add_argument("--platform", choices=["cpu", "tpu", "default"],
                   default="default",
                   help="the JAX CLI's platform override: 'cpu' is --device "
                        "cpu, 'default' keeps --device, 'tpu' is refused")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"])
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="shard every chunk over a device mesh of the local "
                        "cards, e.g. 'time=4' or 'time=2,channel=4' "
                        "(channel>1 only in channels mode); emitted bytes "
                        "are identical to the unsharded run")
    p.add_argument("--input", metavar="FILE", default=None,
                   help="read IQ from a seekable file instead of stdin "
                        "(required with --distributed)")
    p.add_argument("--output", metavar="FILE", default=None,
                   help="write IQ to a file instead of stdout; under "
                        "--distributed host k writes FILE.partK and "
                        "concatenating the parts reproduces the "
                        "single-process stream bitwise")
    p.add_argument("--distributed", metavar="SPEC", default=None,
                   help="join a multi-host run: coordinator=HOST:PORT,"
                        "num_processes=N,process_id=K.  Hosts split the "
                        "capture by chunk-aligned byte ranges (channels "
                        "mode: by channel) with zero cross-host traffic — "
                        "state at each boundary is seeded exactly from "
                        "absolute stream position (resume = seek)")
    p.add_argument("--host-channels", type=int, default=None, metavar="HC",
                   help="channels mode: channel-parallel host count; must "
                        "equal num_processes (channels mode splits by "
                        "channel only — a time split of the channels grid "
                        "is not implemented).  Default: all hosts split "
                        "the channel axis")
    p.add_argument("--save-state", metavar="PATH", default=None,
                   help="write a resumable checkpoint (.npz) at EOF or on "
                        "SIGTERM/SIGINT; under --distributed host k writes "
                        "PATH.hK (state is host-local)")
    p.add_argument("--load-state", metavar="PATH", default=None,
                   help="resume from a checkpoint written by --save-state: "
                        "seeks --input to the saved offset (a pipe must be "
                        "fed from there) and appends to the output; under "
                        "--distributed host k restores PATH.hK and appends "
                        "to its own part file")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="'cuda' (default) runs the hand-written kernels on "
                        "the GPU and fails without one; 'cpu' runs their "
                        "plain torch versions")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="doppler",
        description="Compensates IQ data stream doppler shift based on TLE "
                    "information, also can be used for doing constant "
                    "baseband shifting (PyTorch + CUDA implementation)",
    )
    from doppler_tpu_torch import __version__
    ap.add_argument("-V", "--version", action="version",
                    version=f"doppler_tpu_torch {__version__} "
                            "(reference surface: cubehub/doppler 1.1.10)")
    sub = ap.add_subparsers(dest="mode", required=True)

    const = sub.add_parser("const", help="Constant shift mode")
    _add_io_args(const)
    const.add_argument("--shift", type=float, required=True,
                       help="frequency shift in Hz")

    track = sub.add_parser("track", help="Doppler tracking mode")
    _add_io_args(track)
    track.add_argument("--tlefile", required=True,
                       help="TLE file: eg. cubesat.txt")
    track.add_argument("--tlename", required=True,
                       help="TLE name in TLE file: eg. ESTCUBE 1")
    track.add_argument("--location", required=True,
                       help="Observer location: lat=<deg>,lon=<deg>,alt=<m>")
    track.add_argument("--time", default=None,
                       help="Observation start time UTC Y-m-dTH:M:S "
                            "(default: current time)")
    track.add_argument("--frequency", type=float, required=True,
                       help="Satellite transmitter frequency in Hz")
    track.add_argument("--offset", type=float, default=0.0,
                       help="Constant frequency shift in Hz added on top")

    chans = sub.add_parser(
        "channels",
        help="Multi-satellite batch: N channels from one wideband capture",
    )
    _add_io_args(chans)
    chans.add_argument("--config", required=True,
                       help="JSON channel config (see docs/channels.md)")
    chans.add_argument("--output-dir", default=".",
                       help="directory for per-channel <name>.iq outputs")
    return ap


def _resolve_device(args) -> str:
    """``--platform`` onto ``--device``: ``cpu`` → ``cpu``, ``default`` →
    ``--device`` (``cuda`` when unset).  Raises ``ValueError`` (a usage
    error) for ``tpu`` and for ``--platform cpu --device cuda``."""
    if args.platform == "tpu":
        raise ValueError("--platform tpu: this package runs on CUDA cards "
                         "or the CPU; choose with --device {cuda,cpu}")
    if args.platform == "cpu":
        if args.device == "cuda":
            raise ValueError("--platform cpu contradicts --device cuda")
        return "cpu"
    return args.device or "cuda"


def _pipeline_impl(impl: str) -> str:
    """``--impl``: ``xla`` → the unfused route; ``auto`` and ``pallas`` →
    the fused kernels (the JAX CLI's ``auto`` picks ``pallas`` on a TPU)."""
    return "xla" if impl == "xla" else "pallas"


def _resolve_chunk_blocks(arg, samplerate: int, block_samples: int,
                          realtime: bool = False) -> int:
    """'auto' targets ~64 ms of stream per device dispatch (live-SDR
    latency); otherwise parses an explicit block count.  Unset defaults to
    'auto' in realtime track mode and to 256 otherwise."""
    if arg is None:
        arg = "auto" if realtime else "256"
    if isinstance(arg, str) and arg.lower() == "auto":
        return max(8, min(1024, round(0.064 * samplerate / block_samples)))
    n = int(arg)
    if n <= 0:
        raise ValueError("--chunk-blocks must be positive")
    return n


def _make_scheduler(args, log, outtype):
    """The const or track scheduler the arguments describe (None after
    logging a usage error)."""
    from doppler_tpu_torch.runtime.pipeline import ConstScheduler

    if args.mode == "const":
        log.info("constant shift mode")
        log.info("\tIQ samplerate   : %d", args.samplerate)
        log.info("\tIQ input type   : %s", args.intype)
        log.info("\tIQ output type  : %s", outtype)
        log.info("\tfrequency shift : %s Hz", args.shift)
        return ConstScheduler(args.shift)
    try:
        lat, lon, alt = parse_location(args.location)
        start_time = None if args.time is None else parse_time_utc(args.time)
    except ValueError as e:
        log.error("%s", e)
        return None

    from doppler_tpu_torch.orbit import make_track_scheduler

    log.info("tracking mode")
    log.info("\tIQ samplerate   : %d", args.samplerate)
    log.info("\tIQ input type   : %s", args.intype)
    log.info("\tIQ output type  : %s", outtype)
    log.info("\tTLE file        : %s", args.tlefile)
    log.info("\tTLE name        : %s", args.tlename)
    log.info("\tlocation        : lat=%s lon=%s alt=%s", lat, lon, alt)
    log.info("\tfrequency       : %s Hz", args.frequency)
    log.info("\toffset          : %s Hz", args.offset)
    try:
        return make_track_scheduler(
            tlefile=args.tlefile,
            tlename=args.tlename,
            lat=lat, lon=lon, alt=alt,
            frequency_hz=args.frequency,
            offset_hz=args.offset,
            samplerate=args.samplerate,
            start_time=start_time,
        )
    except (FileNotFoundError, ValueError) as e:
        log.error("%s", e)
        return None


def _log_device(log, device) -> None:
    if device.type == "cuda":
        import torch

        log.info("device          : %s (%s)", device,
                 torch.cuda.get_device_name(device))
    else:
        log.info("device          : cpu (plain torch versions of the kernels)")


def _resume_byte(args, log, meta, key: str, bps: int):
    """Where a restored run resumes in the input: the byte offset, or the
    exit code when there is nothing to run.  A checkpoint written after an
    EOF drain is complete: running again would drain again and append the
    FIR tails a second time (the outputs open in append mode)."""
    resume_byte = meta[key] * bps
    if meta.get("drained"):
        size = os.stat(args.input).st_size if args.input else None
        if size is None or resume_byte >= size:
            log.info("checkpoint is complete (drained); nothing to do")
            return None, 0
        log.error(
            "checkpoint was written after an EOF drain but the capture has "
            "grown since; the flushed FIR tail already ended the output, so "
            "resuming would corrupt it — reprocess the full capture instead")
        return None, 1
    log.info("resumed at input sample %d (byte %d)", meta[key], resume_byte)
    return resume_byte, None


@contextlib.contextmanager
def _stop_on_signal(enabled: bool):
    """With ``--save-state``, SIGTERM/SIGINT finish the chunk in flight and
    then stop, so the checkpoint is consistent with the bytes already
    written.  Yields the flag; restores the previous handlers on exit."""
    flag = {"stop": False}
    if not enabled:
        yield flag
        return

    def on_signal(signum, frame):
        flag["stop"] = True

    previous = {sig: signal.signal(sig, on_signal)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        yield flag
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)


def _host_path(path: str, host, suffix: str) -> str:
    """A per-host file under ``--distributed``: ``PATH`` + ``suffix`` + k."""
    pid, nproc = host
    return path if nproc == 1 else f"{path}{suffix}{pid}"


def _join(args, log):
    """``--distributed``: parse the spec, check the arguments a split run
    needs, then join the group.  Returns ``((pid, nproc), None)``, or
    ``(None, rc)`` after logging the error.  The checks come before the
    rendezvous, so a host with a bad configuration fails at once instead
    of waiting for its peers."""
    from doppler_tpu_torch.parallel import distributed

    try:
        spec = distributed.resolve_spec(
            **distributed.parse_distributed_spec(args.distributed))
    except ValueError as e:
        log.error("%s", e)
        return None, 1
    pid, nproc = spec["process_id"], spec["num_processes"]
    if nproc > 1:
        if not args.input:
            log.error("--distributed needs --input FILE (hosts seek to "
                      "their own byte ranges; a pipe cannot be split)")
            return None, 1
        if args.mode == "channels":
            if args.host_channels is not None and args.host_channels != nproc:
                # the channels arm splits the channel axis only: hosts
                # sharing a channel slice would reprocess the whole capture
                # and race on the same output files
                log.error(
                    "--host-channels %d != num_processes %d: channels mode "
                    "splits by channel only (the time axis of the host grid "
                    "is not implemented here); drop --host-channels or set "
                    "it to num_processes", args.host_channels, nproc)
                return None, 1
        elif not args.output:
            log.error("--distributed needs --output FILE "
                      "(per-host part files)")
            return None, 1
        elif args.mode == "track" and args.time is None:
            log.error("--distributed track mode needs --time "
                      "(wall-clock schedules are not host-splittable)")
            return None, 1
    distributed.init(**spec)
    log.info("distributed: process %d of %d", pid, nproc)
    return (pid, nproc), None


def _host_range(args, log, pipe, fin, host, chunk_blocks: int, bps: int):
    """``--distributed``, one stream: this host's chunk-aligned byte range
    of ``--input`` as a reader, its state seeded by a seek to the range's
    first block (history read from just before it), or restored from its
    own checkpoint ``PATH.hK``.  Returns ``(reader, None)``, or
    ``(None, rc)`` when there is nothing to run."""
    from doppler_tpu_torch.parallel.distributed import host_slice
    from doppler_tpu_torch.runtime import checkpoint
    from doppler_tpu_torch.runtime.stream import ByteRangeReader

    pid, nproc = host
    size = os.stat(args.input).st_size
    chunk_bytes = args.block_bytes * chunk_blocks
    n_chunks = max(1, -(-size // chunk_bytes))
    shard = host_slice(1, n_chunks, process_index=pid, process_count=nproc)
    lo = shard.block_lo * chunk_bytes
    hi = min(size, shard.block_hi * chunk_bytes)
    if args.load_state:
        # elastic restart: the host's own checkpoint carries its absolute
        # stream position and FIR state, and replaces the seek
        try:
            meta = checkpoint.restore(_host_path(args.load_state, host, ".h"),
                                      pipe)
        except (ValueError, OSError) as e:
            log.error("%s", e)
            return None, 1
        resume_lo = meta["sample_offset"] * bps
        if (not (lo <= resume_lo <= hi)
                or (resume_lo % chunk_bytes and resume_lo != hi)):
            log.error(
                "checkpoint at byte %d is outside this host's range "
                "[%d, %d) or not chunk-aligned", resume_lo, lo, hi)
            return None, 1
        if meta.get("drained"):
            # the host finished and flushed its FIR tail: running again
            # would append the tail a second time; a capture that grew since
            # cannot continue a part stream the tail already ended
            if resume_lo >= hi:
                log.info("host %d checkpoint is complete (drained); "
                         "nothing to do", pid)
                return None, 0
            log.error(
                "host %d checkpoint was written after an EOF drain but "
                "the capture has grown since; the flushed FIR tail "
                "already ended the part stream — reprocess the full "
                "capture instead", pid)
            return None, 1
        lo = resume_lo
        log.info("host %d resumed at input sample %d", pid,
                 meta["sample_offset"])
    else:
        history = None
        n_hist = pipe.seek_history_blocks()
        if lo > 0 and n_hist:
            hist_bytes = n_hist * args.block_bytes
            if hist_bytes > lo:
                log.error(
                    "host %d needs %d history blocks before byte %d "
                    "but the capture is shorter there", pid, n_hist, lo)
                return None, 1
            fin.seek(lo - hist_bytes)
            history = fin.read(hist_bytes)
        try:
            pipe.seek_to_block(shard.block_lo * chunk_blocks, history=history)
        except ValueError as e:
            log.error("%s", e)
            return None, 1
    if pid != nproc - 1:
        pipe.drain_on_eof = False   # only the stream's last host drains
    log.info("host %d owns chunks [%d, %d) = bytes [%d, %d)",
             pid, shard.block_lo, shard.block_hi, lo, hi)
    return ByteRangeReader(fin, lo, hi), None


def _make_mesh(args, log):
    """``--mesh``: the ``(ok, mesh)`` of the spec on ``--device``'s local
    devices; ``ok`` is False after logging the error."""
    if not args.mesh:
        return True, None
    from doppler_tpu_torch.parallel.mesh import make_mesh

    try:
        mesh_time, mesh_channel = parse_mesh(args.mesh)
        if mesh_channel > 1 and args.mode != "channels":
            raise ValueError(
                "--mesh channel>1 needs channels mode "
                "(a single stream has one channel)")
        mesh = make_mesh(time=mesh_time, channel=mesh_channel,
                         device=args.device)
    except ValueError as e:
        log.error("%s", e)
        return False, None
    log.info("device mesh: time=%d channel=%d", mesh_time, mesh_channel)
    return True, mesh


def _main_channels(args, log, outtype: str, chunk_blocks: int, stdin,
                   host, mesh) -> int:
    """The ``channels`` arm: N channels of one wideband capture into
    ``--output-dir/<name>.iq``; under ``--distributed`` each host takes its
    slice of the channels."""
    from doppler_tpu_torch.orbit import RealtimeTrackScheduler
    from doppler_tpu_torch.orbit.sgp4 import SGP4Error
    from doppler_tpu_torch.runtime import checkpoint
    from doppler_tpu_torch.runtime.channels import (
        MultiChannelPipeline,
        load_channel_config,
    )

    bps = stream_bps(args.intype)
    try:
        specs, _ = load_channel_config(args.config, args.samplerate)
    except (OSError, KeyError, ValueError) as e:
        log.error("bad channel config: %s", e)
        return 1
    pid, nproc = host
    if nproc > 1:
        from doppler_tpu_torch.parallel.distributed import host_slice

        shard = host_slice(len(specs), 1, process_index=pid,
                           process_count=nproc, channel_parallel_hosts=nproc)
        specs = specs[shard.channel_lo:shard.channel_hi]
        log.info("host %d owns channels [%d, %d)", pid, shard.channel_lo,
                 shard.channel_hi)
        if not specs:
            log.info("host %d: no channels to process", pid)
            return 0
    log.info("multi-channel mode: %d channels", len(specs))
    for s in specs:
        log.info("\tchannel %-16s center offset %+.0f Hz",
                 s.name, s.center_offset_hz)
    # realtime channel schedulers re-evaluate their Doppler curve once per
    # dispatch, exactly like realtime track mode: an unset --chunk-blocks
    # shrinks to the ~64 ms 'auto' target here too
    if args.chunk_blocks is None and any(
            isinstance(s.scheduler, RealtimeTrackScheduler) for s in specs):
        chunk_blocks = _resolve_chunk_blocks("auto", args.samplerate,
                                             args.block_bytes // bps)
        log.info("realtime channel(s): chunk-blocks auto = %d", chunk_blocks)
    try:
        mpipe = MultiChannelPipeline(
            args.samplerate, args.intype, outtype, specs,
            out_rate=args.resample_to,
            block_bytes=args.block_bytes,
            chunk_blocks=chunk_blocks,
            quantize_ratio_f32=not args.exact_ratio,
            drain_on_eof=args.drain,
            resample_stages=args.resample_stages,
            precision=args.precision,
            impl=_pipeline_impl(args.impl),
            device=args.device,
            mesh=mesh,
        )
    except (ValueError, RuntimeError) as e:
        log.error("%s", e)
        return 1
    _log_device(log, mpipe.device)

    with contextlib.ExitStack() as files:
        try:
            fin = (files.enter_context(open(args.input, "rb")) if args.input
                   else stdin or sys.stdin.buffer)
        except OSError as e:
            log.error("%s", e)
            return 1
        if args.load_state:
            try:
                meta = checkpoint.restore_channels(
                    _host_path(args.load_state, host, ".h"), mpipe)
            except (ValueError, OSError) as e:
                log.error("%s", e)
                return 1
            resume_byte, rc = _resume_byte(args, log, meta, "samples_in", bps)
            if rc is not None:
                return rc
            if args.input:
                # seekable capture: fast-forward to the checkpoint
                fin.seek(resume_byte)
        try:
            os.makedirs(args.output_dir, exist_ok=True)
            # resuming appends to the per-channel files written before the cut
            writers = [
                files.enter_context(open(
                    os.path.join(args.output_dir, f"{s.name}.iq"),
                    "ab" if args.load_state else "wb"))
                for s in specs
            ]
        except OSError as e:
            log.error("%s", e)
            return 1
        with _stop_on_signal(bool(args.save_state)) as stop:
            try:
                counters = mpipe.run(fin, writers,
                                     should_stop=lambda: stop["stop"])
            except SGP4Error as e:
                log.error("orbit propagation failed: %s (supply a current "
                          "TLE, or a start time near the TLE epoch)", e)
                return 1

    if args.save_state:
        state_path = _host_path(args.save_state, host, ".h")
        checkpoint.save_channels(state_path, mpipe)
        log.info("checkpoint written to %s", state_path)
    if stop["stop"]:
        log.warning("stopped by signal after a consistent chunk boundary")
        return 130
    dt = counters.elapsed()
    log.info(
        "done: %d wideband samples x %d channels in %.6f s (%.6f Msps in); "
        "host plan+stage %.6f s, device wait %.6f s",
        counters.samples, len(specs), dt,
        (counters.samples / dt if dt > 0 else 0.0) / 1e6,
        mpipe.host_s, mpipe.spans.seconds("wait"),
    )
    log.info("spans: %s", mpipe.spans.summary())
    return 0


def _main_stream(args, log, outtype: str, chunk_blocks: int, stdin, stdout,
                 host, mesh) -> int:
    """The ``const`` and ``track`` arms: one stream; under
    ``--distributed`` each host takes its byte range of ``--input``."""
    bps = stream_bps(args.intype)
    scheduler = _make_scheduler(args, log, outtype)
    if scheduler is None:
        return 1

    from doppler_tpu_torch.ops.resample import attach_resampler
    from doppler_tpu_torch.orbit.sgp4 import SGP4Error
    from doppler_tpu_torch.runtime import checkpoint
    from doppler_tpu_torch.runtime.pipeline import Pipeline

    try:
        pipe = Pipeline(
            args.samplerate, args.intype, outtype, scheduler,
            block_bytes=args.block_bytes,
            chunk_blocks=chunk_blocks,
            quantize_ratio_f32=not args.exact_ratio,
            drain_on_eof=args.drain,
            prefetch_chunks=args.prefetch_chunks,
            precision=args.precision,
            impl=_pipeline_impl(args.impl),
            device=args.device,
            mesh=mesh,
        )
        if args.resample_to is not None:
            attach_resampler(pipe, args.resample_to,
                             stages=args.resample_stages,
                             impl=args.resample_impl)
    except (ValueError, RuntimeError) as e:
        log.error("%s", e)
        return 1
    _log_device(log, pipe.device)

    with contextlib.ExitStack() as files:
        try:
            fin = (files.enter_context(open(args.input, "rb")) if args.input
                   else stdin or sys.stdin.buffer)
            # resume appends: the bytes written before the cut are exactly
            # consistent with the checkpoint, so the resumed run completes
            # the file the uninterrupted run would have written
            fout = (files.enter_context(
                        open(_host_path(args.output, host, ".part"),
                             "ab" if args.load_state else "wb"))
                    if args.output else stdout or sys.stdout.buffer)
        except OSError as e:
            log.error("%s", e)
            return 1
        if host[1] > 1:
            fin, rc = _host_range(args, log, pipe, fin, host, chunk_blocks,
                                  bps)
            if rc is not None:
                return rc
        elif args.load_state:
            try:
                meta = checkpoint.restore(args.load_state, pipe)
            except (ValueError, OSError) as e:
                log.error("%s", e)
                return 1
            resume_byte, rc = _resume_byte(args, log, meta, "sample_offset", bps)
            if rc is not None:
                return rc
            if args.input:
                fin.seek(resume_byte)
        with _stop_on_signal(bool(args.save_state)) as stop:
            try:
                counters = pipe.run(fin, fout, should_stop=lambda: stop["stop"])
            except SGP4Error as e:
                log.error("orbit propagation failed: %s (supply a current "
                          "TLE, or --time near the TLE epoch)", e)
                return 1

    if args.save_state:
        state_path = _host_path(args.save_state, host, ".h")
        checkpoint.save(state_path, pipe)
        log.info("checkpoint written to %s", state_path)
    if stop["stop"]:
        log.warning("stopped by signal after a consistent chunk boundary")
        return 130

    # report the INPUT rate (the reference's realtime contract is on the
    # capture rate; with a resampler the output count is P/Q of it)
    n_in = counters.bytes_in // bps
    dt = counters.elapsed()
    log.info(
        "done: %d samples in, %d out in %.6f s (%.6f Msps in); host plan+"
        "stage %.6f s, device wait %.6f s",
        n_in, counters.samples, dt, (n_in / dt if dt > 0 else 0.0) / 1e6,
        pipe.host_s, pipe.spans.seconds("wait"),
    )
    log.info("spans: %s", pipe.spans.summary())
    return 0


def main(argv=None, stdin=None, stdout=None) -> int:
    import logging

    from doppler_tpu_torch.parallel import distributed
    from doppler_tpu_torch.runtime.telemetry import setup_logger

    ap = build_parser()
    try:
        args = ap.parse_args(argv)
        try:
            args.device = _resolve_device(args)
        except ValueError as e:
            ap.error(str(e))
    except SystemExit as e:
        return int(e.code or 0)

    log = setup_logger(getattr(logging, args.log_level.upper()),
                       fmt=args.log_format)
    bps = stream_bps(args.intype)
    if args.block_bytes < bps or args.block_bytes % bps:
        log.error("--block-bytes must be a positive multiple of %d "
                  "(the %s sample size); got %d",
                  bps, args.intype, args.block_bytes)
        return 1
    outtype = args.outtype or args.intype
    try:
        chunk_blocks = _resolve_chunk_blocks(
            args.chunk_blocks, args.samplerate, args.block_bytes // bps,
            realtime=(args.mode == "track"
                      and getattr(args, "time", None) is None),
        )
    except ValueError as e:
        log.error("%s", e)
        return 1
    # the mesh is process-local (each host shards its own range over its
    # own cards) and is checked before a --distributed rendezvous
    ok, mesh = _make_mesh(args, log)
    if not ok:
        return 1
    host = (0, 1)
    if args.distributed:
        host, rc = _join(args, log)
        if rc is not None:
            return rc
    try:
        if args.mode == "channels":
            return _main_channels(args, log, outtype, chunk_blocks, stdin,
                                  host, mesh)
        return _main_stream(args, log, outtype, chunk_blocks, stdin, stdout,
                            host, mesh)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.exit(main())
