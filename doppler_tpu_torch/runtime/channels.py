"""Multi-channel pipeline: N satellites from one wideband capture.

BASELINE configs 4-5, the torch statement of
``doppler_tpu/runtime/channels.py``: a single wideband IQ stream carries
many satellite downlinks; each channel c gets its own correction chain

    mix by (center_offset_c + doppler_c(t) + offset_c)  →  resample  →  encode

run as ONE batched device computation over the shared chunk.  Host side per
channel: an independent Doppler scheduler (const or TLE track) and an
independent samplenum-emulation state; the channel's center offset is folded
into the per-block shift before planning, which is what C separate reference
binaries with ``--offset (offset + center)`` would do.

Routes, per chunk, decided as the JAX package decides them so both send the
same chunks the same way:

- every channel at one output rate, a single-stage resampler, a full chunk →
  the channel-batched chain kernel (``ops.cuda.chain``; its ``split3``
  kernel under ``precision='fast'``);
- one rate, a ``MultiStageResampler``, a full chunk → the channel-batched
  cascade kernel (``ops.cuda.cascade``) over its leading ``split_point``
  stages; when that is not all of them the front's float32 planes run the
  remaining stages' batched ``process``;
- anything else (mixed rates, the partial EOF chunk, no resampler, and
  every chunk under ``impl='xla'``, the JAX package's unfused route) → the
  channel-batched mixer kernel, then each rate group's batched resampler.

Under a ``mesh`` (``parallel.mesh``) each rate group shards its channels
over the ``channel`` axis and the chunk's blocks over ``time``
(``parallel.sharded``), as the JAX package does: no resampler → the
channel mixer per shard; a single-stage resampler → the channel mixer and
the window resampler per shard (not the channel chain); a cascade → the
channel-batched cascade per shard, each time shard k > 0 replaying the
raw blocks before it for its carries.  The bytes are the unsharded run's
(on the card a uniform single-stage capture's unsharded chunks run the
channel chain, whose dot sums in another order: ≤ 1 LSB).  The partial
EOF chunk with a resampler, a group that does not divide over the channel
axis and a cascade a shard cannot take run unsharded (the last two warn).

At most one chunk is in flight: :meth:`MultiChannelPipeline.dispatch_chunk`
plans, stages into pinned host memory, copies with ``non_blocking=True``,
launches and starts the copy back; the finalizer it returns waits on the
chunk's event.  ``run`` finalizes chunk k−1 during chunk k's read once its
copy is done, else after dispatching chunk k.  The loop,
the fused routes, the carries, the copy-out and the drain are
``runtime.pipeline``'s (``ChunkPipeline``, ``run_chunks``), shared with the
single-stream ``Pipeline``.

Outputs go to per-channel files (stdout cannot interleave C streams).
``device`` is explicit and nothing falls back: ``'cuda'`` raises when no
card is present; ``'cpu'`` runs the kernels' plain versions.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from doppler_tpu_torch.ops import codec
from doppler_tpu_torch.ops.cuda import cascade, chain, mixer
from doppler_tpu_torch.ops.multistage import make_resampler
from doppler_tpu_torch.ops.phase_plan import (
    NCOState,
    const_lane,
    plan_blocks,
    plan_fields_periodic,
    plan_fields_uniform,
)
from doppler_tpu_torch.parallel import sharded
from doppler_tpu_torch.runtime import native
from doppler_tpu_torch.runtime import stream as streaming
from doppler_tpu_torch.runtime.pipeline import (
    ChunkPipeline,
    ConstScheduler,
    Scheduler,
    host_buffer,
    run_chunks,
    stage_chunk,
)
from doppler_tpu_torch.runtime import telemetry
from doppler_tpu_torch.runtime.telemetry import Counters, get_logger

__all__ = ["ChannelSpec", "MultiChannelPipeline", "load_channel_config"]

log = get_logger("channels")

# a chunk's shift steps cut it into at most this many segments for the
# lanes; past it (a chunk over a few seconds, or a shift that varies block
# to block) its varying channels go to ``plan_blocks`` whole
_MAX_SEGMENTS = 4


@dataclass
class ChannelSpec:
    """One channel of a wideband capture.

    ``out_rate`` overrides the pipeline-wide ``--resample-to`` for this
    channel (None = use the pipeline default, which may itself be None =
    no resampling).
    """

    name: str
    scheduler: Scheduler
    center_offset_hz: float = 0.0
    out_rate: float | None = None
    state: NCOState = field(default_factory=NCOState)


class MultiChannelPipeline(ChunkPipeline):
    """Batched multi-satellite corrector over one input stream.

    ``spans``: the newest :meth:`run`'s ``telemetry.Spans``, as
    ``Pipeline``'s, with the planner's counters: ``chan_plans_periodic``,
    ``chan_plans_uniform`` and ``chan_plans_per_channel``, the
    channel-chunks each lane planned; ``plans_uniform`` and
    ``plans_per_channel``, the chunks in which no channel, and at least
    one, ran ``plan_blocks``; with track channels, ``track_evals``, the
    instants their schedulers propagated, ``track_steps``, the
    channel-chunks whose shift changes inside the chunk, and
    ``chan_plans_split``, those of them that the lanes planned a segment
    at a time.  ``host_s`` is the
    host's planning and staging seconds, the ``schedule``, ``plan`` and
    ``stage`` totals.

    ``impl``: ``'pallas'`` (the default) or ``'xla'``, as ``Pipeline``'s:
    'xla' never runs the fused channel kernels (under a mesh a cascade group
    runs unsharded, as in the JAX package).

    ``precision``: ``'exact'`` or ``'fast'``, as in the JAX package: 'fast'
    runs only the channel-batched chain's dot as ``split3``; the cascade,
    the unfused route and every sharded step stay exact.

    ``mesh``: a ``parallel.mesh.Mesh`` whose first device is ``device``;
    the channel count must divide over its channel axis and
    ``chunk_blocks`` over its time axis.
    """

    def __init__(
        self,
        samplerate: int,
        intype: str,
        outtype: str,
        channels: list[ChannelSpec],
        *,
        out_rate: int | None = None,
        block_bytes: int = streaming.REFERENCE_BLOCK_BYTES,
        chunk_blocks: int = 64,
        quantize_ratio_f32: bool = True,
        reset_quirk: bool = True,
        drain_on_eof: bool = False,
        resample_stages: str = "single",
        precision: str = "exact",
        impl: str = "pallas",
        device="cuda",
        mesh=None,
    ):
        if not channels:
            raise ValueError("need at least one channel")
        super().__init__(
            samplerate, intype, outtype, block_bytes=block_bytes,
            chunk_blocks=chunk_blocks, quantize_ratio_f32=quantize_ratio_f32,
            drain_on_eof=drain_on_eof, precision=precision, impl=impl,
            device=device, mesh=mesh)
        self._rows = list(range(len(channels)))    # every channel
        self.samples_in = 0     # absolute input samples consumed (checkpoint)
        self.channels = channels
        self.reset_quirk = reset_quirk

        # group channels by effective output rate (per-channel out_rate
        # overrides the pipeline default); each group gets its own batched
        # resampler so different rates coexist in one wideband run
        rates: dict[float | None, list[int]] = {}
        for idx, ch in enumerate(channels):
            rate = ch.out_rate if ch.out_rate is not None else out_rate
            rates.setdefault(rate, []).append(idx)
        self._groups = [
            (idxs,
             make_resampler(samplerate, rate, stages=resample_stages,
                            channels=len(idxs), device=self.device)
             if rate is not None else None)
            for rate, idxs in rates.items()
        ]
        # mixed-rate captures never fuse: the fused kernels batch one
        # resampler over every channel
        self._uniform = len(self._groups) == 1
        self.resampler = self._groups[0][1] if self._uniform else None
        # the schedulers that propagate an orbit (track channels)
        self._tracked = [ch.scheduler for ch in channels
                         if hasattr(ch.scheduler, "last_evals")]
        self._warned: set = set()
        if mesh is not None:
            n_chan = mesh.shape["channel"]
            if len(channels) % n_chan:
                raise ValueError(
                    f"{len(channels)} channels must divide over mesh "
                    f"channel={n_chan}")
            for _, rs in self._groups:
                if rs is not None and getattr(rs, "bank", None) is not None:
                    self._check_shard_history(rs)

    def _warn_once(self, msg: str) -> None:
        if msg not in self._warned:
            self._warned.add(msg)
            log.warning(msg)

    # -- planning -------------------------------------------------------------

    def _plan_all(self, counts, k=None) -> np.ndarray:
        """Plan words of every channel for one chunk: ``(7, C, B)`` uint32,
        zero past ``len(counts)`` blocks.  Records the chunk's ``schedule``
        and ``plan`` spans under ``k`` and counts the lanes that planned
        it, and the track channels' propagated instants and steps."""
        t0 = time.perf_counter()
        # per-channel shifts for the chunk: f32(scheduler) + f32(center),
        # added in float32 exactly as the single-stream path composes them
        # (main.rs:177)
        shifts_all = [
            (np.asarray(ch.scheduler.shifts(counts), dtype=np.float64)
             .astype(np.float32) + np.float32(ch.center_offset_hz))
            .astype(np.float64)
            for ch in self.channels
        ]
        t1 = time.perf_counter()
        lanes, steps, split, fields = self._plan_fields(counts, shifts_all)
        for lane, n in lanes.items():
            self.spans.bump(f"chan_plans_{lane}", n)
        self.spans.bump("plans_per_channel" if lanes["per_channel"]
                        else "plans_uniform")
        if self._tracked:
            self.spans.bump("track_evals",
                            sum(s.last_evals for s in self._tracked))
            self.spans.bump("track_steps", steps)
            self.spans.bump("chan_plans_split", split)
        self.spans.add("schedule", k, t0, t1)
        self.spans.add("plan", k, t1, time.perf_counter())
        return fields

    def _plan_fields(self, counts, shifts_all) -> tuple:
        """``({lane: channels it planned}, channels whose shift varies,
        of them those the lanes planned segment by segment, plan words)``
        of one chunk.

        Each channel whose shift is constant over the chunk goes to a lane
        by its f32 ratio (``phase_plan.const_lane``): a short exact period
        that full blocks keep in the exact-periodic regime →
        ``plan_fields_periodic``, else ``plan_fields_uniform``; each lane
        one vectorised ``(C', B)`` pass.  The chunk's shift steps (the
        blocks where a track channel's shift changes, over all of them) cut
        it into segments, at most ``_MAX_SEGMENTS``; the varying channels
        go to the lanes a segment at a time, each state carried from one
        segment into the next.  A lane refuses a channel whose state leaves
        its regime (genesis, a seeked state, a wrap: its planner tests the
        states); that channel, and every varying channel of a chunk cut
        into more segments, goes to one ``plan_blocks`` from where it was
        refused to the chunk's end.  Every lane gives ``plan_blocks``'
        words and states bit for bit.  A channel counts under the lane of
        its last segment, or under ``per_channel`` if ``plan_blocks``
        planned any of it.
        """
        C, B, n = len(self.channels), self.chunk_blocks, len(counts)
        fs, L = self.samplerate, self.block_samples
        opts = dict(quantize_f32=self.quantize_ratio_f32,
                    reset_quirk=self.reset_quirk)
        planners = (("periodic", plan_fields_periodic,
                     {"quantize_f32": self.quantize_ratio_f32}),
                    ("uniform", plan_fields_uniform, opts))
        const, varying, cuts = [], [], set()
        for c, s in enumerate(shifts_all if n else ()):
            at = np.flatnonzero(s[1:] != s[:-1]) + 1
            (varying if at.size else const).append(c)
            cuts.update(at.tolist())
        bounds = [0, *sorted(cuts), n]
        segments = [(0, n, const)]
        refused: dict = {}          # channel → block its plan_blocks starts
        if len(bounds) - 1 <= _MAX_SEGMENTS:
            segments += [(b0, b1, varying)
                         for b0, b1 in zip(bounds[:-1], bounds[1:])]
        else:
            refused.update((c, 0) for c in varying)
        fields = None
        last: dict = {}             # channel → lane of its last segment
        for b0, b1, idx in segments:
            by_lane: dict = {"periodic": [], "uniform": []}
            for c in idx:
                if c not in refused:
                    by_lane[const_lane(float(shifts_all[c][b0]), fs,
                                       block_len=L, **opts)].append(c)
            for lane, planner, kw in planners:
                ids = by_lane[lane]
                if not ids:
                    continue
                f, out = planner(
                    [float(shifts_all[c][b0]) for c in ids], counts[b0:b1],
                    fs, [self.channels[c].state for c in ids], L, **kw)
                if not out and len(ids) == C and b1 - b0 == B:
                    # one lane planned the whole chunk
                    return {"periodic": 0, "uniform": 0, "per_channel": 0,
                            lane: C}, 0, 0, f
                if fields is None:
                    fields = np.zeros((7, C, B), dtype=np.uint32)
                fields[:, ids, b0:b1] = f
                last.update((c, lane) for c in ids)
                refused.update((ids[i], b0) for i in out)

        if fields is None:
            fields = np.zeros((7, C, B), dtype=np.uint32)
        for c, b0 in refused.items():
            plan = plan_blocks(
                shifts_all[c][b0:], counts[b0:], fs,
                self.channels[c].state, L, **opts)
            for fi, arr in enumerate(
                (plan.d_hi, plan.d_lo, plan.c1_hi, plan.c1_lo,
                 plan.c2_hi, plan.c2_lo, plan.t)
            ):
                fields[fi, c, b0:n] = arr
            last[c] = "per_channel"
        planned = {"periodic": 0, "uniform": 0, "per_channel": 0}
        for lane in last.values():
            planned[lane] += 1
        split = sum(c not in refused for c in varying)
        return planned, len(varying), split, fields

    # -- dispatch -------------------------------------------------------------

    def dispatch_chunk(self, chunk: streaming.Chunk, k=None):
        """Host planning + device dispatch without waiting → zero-argument
        finalizer returning the per-channel byte strings (None for a chunk
        of no samples).  The chunk's spans carry the chunk id ``k``.

        All pipeline and resampler state advances here (host integers and
        device tensors in stream order), so a finalizer is a pure
        conversion and may run after the next chunk's dispatch.
        """
        counts = [size // self._bps_in for size in chunk.block_sizes]
        total = sum(counts)
        C = len(self.channels)
        if total == 0:
            if counts:
                self._plan_all(counts, k)   # still advance the schedulers
            return None
        B, L = self.chunk_blocks, self.block_samples
        fields = self._plan_all(counts, k)
        t0 = time.perf_counter()
        self.samples_in += total
        data = stage_chunk(chunk.data, self.intype, B, L, self.device)
        plans = host_buffer((7, C, B), torch.int32, self.device)
        plans.numpy()[...] = fields.view(np.int32)
        t1 = time.perf_counter()
        self.spans.add("stage", k, t0, t1)
        return self._launch(data, plans, total, k, t1)

    def _dispatch_local(self, data, plans, total: int):
        """Launch one staged host chunk down its route.  Returns the parts
        ``(channel indices, device output, n_valid)``; an output is int32
        ``(C_g, …)`` or float32 ``(2, C_g, …)``."""
        if self.device.type == "cuda":
            # one (7, C, B) transfer a chunk, from the pinned staging buffer
            plans = plans.to(self.device, non_blocking=True)
            data = data.to(self.device, non_blocking=True)
        fused = self._dispatch_fused(data, plans, total)
        if fused is not None:
            return fused
        # the unfused route: one mixer launch for all channels, then each
        # rate group's batched resampler
        everyone = self._rows
        no_resampling = all(g_rs is None for _, g_rs in self._groups)
        out = mixer.mix_blocks_fmt_channels(
            data, plans, intype=self.intype,
            outtype=self.outtype if no_resampling else "f32")
        if no_resampling:
            return [(everyone, out, total)]
        # any later fused chunk must reseed its carries from the histories
        self.drop_carries()
        planes = out.reshape(2, len(everyone), -1)
        parts = []
        for idxs, g_rs in self._groups:
            if idxs == everyone:
                sub_i, sub_q = planes[0], planes[1]
            else:
                sel = torch.tensor(idxs, device=self.device)
                sub_i, sub_q = planes[0][sel], planes[1][sel]
            if g_rs is None:
                parts.append((idxs, codec.encode(sub_i, sub_q, self.outtype),
                              total))
            else:
                yi, yq, n_out = g_rs.process(
                    sub_i, sub_q, total,
                    M=g_rs.max_out_for(self.chunk_blocks * self.block_samples))
                parts.append((idxs, codec.encode(yi, yq, self.outtype), n_out))
        return parts

    def _dispatch_sharded(self, data, plans, total: int):
        """``--mesh`` dispatch of one staged host chunk, per rate group.
        Returns the ``(channel indices, device output, n_valid)`` parts, or
        None for the unsharded dispatch (the partial EOF chunk with a
        resampler; a group that does not divide over the channel axis, or
        a cascade a shard cannot take, with a warning)."""
        B, L = self.chunk_blocks, self.block_samples
        n_chan = self.mesh.shape["channel"]
        if any(rs is not None for _, rs in self._groups) and total != B * L:
            return None
        for g, (idxs, rs) in enumerate(self._groups):
            if len(idxs) % n_chan:
                self._warn_once(
                    f"mesh mode: group of {len(idxs)} channels does not "
                    f"divide over mesh channel={n_chan} — running unsharded")
                return None
            # the sharded cascade step is the cascade kernel: impl='xla'
            # runs the cascade unsharded, as in the JAX package
            if (rs is not None and getattr(rs, "bank", None) is None
                    and (self.impl != "pallas"
                         or self._casc_group_cfg(g, rs) is None)):
                self._warn_once(
                    "mesh mode: this cascade cannot run the sharded fused "
                    "step (geometry/impl) — running unsharded")
                return None

        parts = []
        for g, (idxs, rs) in enumerate(self._groups):
            C_g = len(idxs)
            plans_g = plans if C_g == len(self.channels) else plans[:, idxs]
            if rs is None:
                shards = self._sharded_mix(("mix", g), C_g, data, plans_g,
                                           total)
            elif getattr(rs, "bank", None) is not None:
                shards = self._sharded_window(("window", g), C_g, rs, data,
                                              plans_g, total)
            else:
                parts += self._sharded_cascade_group(g, rs, idxs, data,
                                                     plans_g, total)
                continue
            parts += [(idxs[cs], out, n) for cs, out, n in shards]
        # a later unsharded fused chunk reseeds from the histories
        self.drop_carries()
        return parts

    def _sharded_cascade_group(self, g, rs, idxs, data, plans, total):
        """One rate group's sharded fused-cascade chunk (full or split).
        Its carries are seeded from each fused stage's batched history
        every chunk, as in the JAX package, so the mesh and the unsharded
        route hand over to each other and to checkpoints bitwise."""
        k = self._sharded_casc_cfg[g]
        split = k < len(rs.stages)
        fused = rs.stages[:k]
        run = self._step(("cascade", g), lambda: sharded.make_cascade_channels_step(
            self.mesh, resampler=rs, fused=k, C=len(idxs), intype=self.intype,
            outtype="f32" if split else self.outtype, final_dense=split))
        out_parts, carries = run(data, plans, self._seed(fused))
        n_mid = self._advance(fused, carries, total)
        n_time = self.mesh.shape["time"]
        if not split:
            return [(idxs[cs], out, n_mid // n_time) for cs, _, out in out_parts]
        # split: the tail stages run once, over the gathered front planes,
        # on the mesh's first device
        by_rows: dict = {}
        for cs, _, out in out_parts:
            by_rows.setdefault(cs.start, []).append(
                out.reshape(2, cs.stop - cs.start, -1).to(self.device))
        planes = torch.cat([torch.cat(by_rows[c], dim=2)
                            for c in sorted(by_rows)], dim=1)
        yi, yq, n_out = rs.process(planes[0], planes[1], n_mid, start=k)
        return [(idxs, codec.encode(yi, yq, self.outtype), n_out)]

    # -- output ---------------------------------------------------------------

    _channel_dims = 1       # carries (C, 2, T−1); outputs (C, n) or (2, C, n)

    def _chain_carry_span(self) -> int:
        return self.chunk_blocks * self.block_samples

    def _fused_kernels(self):
        return chain.mix_resample_chain_channels, cascade.mix_cascade_channels

    def _lead(self, rows) -> tuple:
        return (len(rows),)

    def _stage_out(self, hosts) -> list[bytes]:
        """The cut: copied-out outputs ``(channel indices, host tensor)`` →
        each channel's bytes, in stream order."""
        outs: list[bytes] = [b""] * len(self.channels)
        for idxs, host in hosts:
            arr = host.numpy()
            for row, cidx in enumerate(idxs):
                if self.outtype == "i16":
                    outs[cidx] += codec.i16_words_to_bytes(arr[row])
                else:
                    outs[cidx] += codec.f32_pairs_to_bytes(
                        native.planar_to_f32_pairs(arr[0, row], arr[1, row]))
        return outs

    # -- main loop ------------------------------------------------------------

    def run(self, fin, writers, should_stop=None) -> Counters:
        """Pump the stream; ``writers`` is one binary file object per channel.

        At most one chunk in flight, as ``Pipeline.run``: chunk k's files
        are written once its device→host copy is done, between the blocks
        of chunk k+1's read, or else after chunk k+1 is planned and
        dispatched (:func:`run_chunks`).  ``should_stop``
        is polled between chunks; a stop leaves the state consistent with
        the bytes written and does not drain.  Each run records its chunks'
        spans in a fresh ``self.spans``.
        """
        if len(writers) != len(self.channels):
            raise ValueError(f"{len(writers)} writers for "
                             f"{len(self.channels)} channels")
        reader = streaming.BlockReader(fin, self.block_bytes)
        counters = Counters()
        spans = self.spans = telemetry.start_spans()
        clock = time.perf_counter

        def emit(finalize, bytes_in, blocks, k):
            if finalize is None:
                return
            outs = finalize()
            t0 = clock()
            for w, ob in zip(writers, outs):
                if ob:
                    w.write(ob)
            counters.add(
                samples=bytes_in // self._bps_in,
                bytes_in=bytes_in,
                bytes_out=sum(len(ob) for ob in outs),
                blocks=blocks,
            )
            spans.add("write", k, t0, clock())

        if (run_chunks(reader, self.chunk_blocks, spans, self.dispatch_chunk,
                       emit, should_stop) and self.drain_on_eof):
            for w, ob in zip(writers, self.drain()):
                if ob:
                    w.write(ob)
                    counters.add(samples=0, bytes_in=0,
                                 bytes_out=len(ob), blocks=0)
            self._drained = True   # checkpointed: a resumed run must not
            #                        append the FIR tails a second time
        for w in writers:
            w.flush()
        return counters


def load_channel_config(path: str, samplerate: int, use_native="auto"):
    """Build ChannelSpecs from a JSON config (see docs/channels.md).

    Shared keys may live at the top level (tlefile, location, time); each
    entry in ``channels`` is either const (``shift``) or track (``tlename`` +
    ``frequency`` [+ ``offset``]), plus optional ``center_offset`` and
    ``resample_to``.  ``use_native`` is the track channels' ``Predictor``'s.
    Returns ``(specs, config dict)``.
    """
    with open(path) as f:
        cfg = json.load(f)
    specs = []
    for ch in cfg["channels"]:
        center = float(ch.get("center_offset", 0.0))
        out_rate = ch.get("resample_to")
        if out_rate is not None:
            out_rate = float(out_rate)
        if "shift" in ch:
            sched = ConstScheduler(float(ch["shift"]))
        else:
            from doppler_tpu_torch.cli import parse_location, parse_time_utc
            from doppler_tpu_torch.orbit import make_track_scheduler

            time_s = ch.get("time", cfg.get("time"))
            tlef = ch.get("tlefile", cfg.get("tlefile"))
            loc = ch.get("location", cfg.get("location"))
            for key, value in (("tlefile", tlef), ("location", loc)):
                if value is None:
                    # open(None) would raise a TypeError that escapes the
                    # CLI's bad-config handling — fail like every other
                    # config error
                    raise ValueError(
                        f"channel {ch.get('name')!r}: track entry needs "
                        f"{key!r} (at the channel or top level)")
            lat, lon, alt = parse_location(loc)
            sched = make_track_scheduler(
                tlefile=tlef,
                tlename=ch["tlename"],
                lat=lat, lon=lon, alt=alt,
                frequency_hz=float(ch["frequency"]),
                offset_hz=float(ch.get("offset", 0.0)),
                samplerate=samplerate,
                start_time=parse_time_utc(time_s) if time_s else None,
                use_native=use_native,
            )
        specs.append(ChannelSpec(
            name=ch["name"], scheduler=sched, center_offset_hz=center,
            out_rate=out_rate,
        ))
    return specs, cfg
