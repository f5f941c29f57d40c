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

One chunk is in flight: :meth:`MultiChannelPipeline.dispatch_chunk` plans,
stages into pinned host memory, copies with ``non_blocking=True``, launches
and starts the copy back; the finalizer it returns waits on the chunk's
event.  ``run`` finalizes chunk k−1 after dispatching chunk k.

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
    ConstScheduler,
    Scheduler,
    carry_rows,
    copy_events,
    host_buffer,
    resolve_device,
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


class MultiChannelPipeline:
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
        if impl not in ("xla", "pallas"):
            raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
        self.impl = impl
        if precision not in ("exact", "fast"):
            raise ValueError(
                f"precision must be 'exact' or 'fast', got {precision!r}")
        self._chain_dot = "split3" if precision == "fast" else "highest"
        self.device = resolve_device(device)
        self.drain_on_eof = drain_on_eof
        self._drained = False   # did THIS run flush the FIR tails? (checkpoint)
        self.samples_in = 0     # absolute input samples consumed (checkpoint)
        self.samplerate = int(samplerate)
        self.intype = intype
        self.outtype = outtype
        self.channels = channels
        self.block_bytes = int(block_bytes)
        self.chunk_blocks = int(chunk_blocks)
        self.quantize_ratio_f32 = quantize_ratio_f32
        self.reset_quirk = reset_quirk
        self._bps_in = streaming.bytes_per_sample(intype)
        self._bps_out = streaming.bytes_per_sample(outtype)
        self.block_samples = self.block_bytes // self._bps_in

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
        self._chain_carries = None    # (C, 2, T−1) chain carries
        self._chain_bank = None
        self._cascade_k = None        # fused stages; 0 = never fused
        self._cascade_stages = None   # their (P, Q, T)
        self._cascade_banks = None
        self._cascade_carries = None  # per fused stage (C, 2, T_s−1)
        self.spans = telemetry.Spans()
        # the schedulers that propagate an orbit (track channels)
        self._tracked = [ch.scheduler for ch in channels
                         if hasattr(ch.scheduler, "last_evals")]

        # --mesh: channels × time-blocks over a grid of devices, per rate
        # group; the bytes are the unsharded run's
        self.mesh = mesh
        self._sharded_steps: dict = {}       # (kind, group) → sharded step
        self._sharded_casc_cfg: dict = {}    # group → fused count or None
        self._warned: set = set()
        if mesh is not None:
            n_chan, n_time = mesh.shape["channel"], mesh.shape["time"]
            if len(channels) % n_chan:
                raise ValueError(
                    f"{len(channels)} channels must divide over mesh "
                    f"channel={n_chan}")
            if self.chunk_blocks % n_time:
                raise ValueError(
                    f"chunk_blocks={self.chunk_blocks} must be divisible by "
                    f"mesh time={n_time}")
            if mesh.device() != self.device:
                raise ValueError(
                    f"the mesh starts on {mesh.device()}, the pipeline "
                    f"runs on {self.device}")
            n_loc = self.chunk_blocks * self.block_samples // n_time
            for _, rs in self._groups:
                if rs is None or getattr(rs, "bank", None) is None:
                    continue
                if rs.T - 1 > n_loc:
                    raise ValueError(
                        f"resampler history ({rs.T - 1}) exceeds one time "
                        f"shard ({n_loc} samples); use fewer/larger chunks")
                if n_loc * rs.P >= (1 << 30):
                    raise ValueError("time shard too large for 32-bit phase math")

    @property
    def host_s(self) -> float:
        return self.spans.seconds("schedule", "plan", "stage")

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

    # -- the gates ------------------------------------------------------------

    def _chain_eligible(self, total: int) -> bool:
        """May this chunk run the channel-batched chain kernel?

        The rule of ``doppler_tpu``'s channels pipeline, term for term.  The
        128-sample terms are the TPU's lane geometry; the carry term is the
        channels form (rows of the whole chunk, not of one block).
        """
        rs = self.resampler
        B, L = self.chunk_blocks, self.block_samples
        return (
            rs is not None
            and self.impl == "pallas"
            and getattr(rs, "bank", None) is not None   # single-stage only
            and L % 128 == 0
            and 128 % rs.Q == 0
            and total == B * L          # padded tails would poison the carry
            and carry_rows(rs.T) <= (B * L) // 128
        )

    def _cascade_eligible(self, total: int) -> bool:
        """May this chunk run the channel-batched cascade kernel?

        The JAX rule with the TPU's step geometry replaced by the kernel's
        ``chunk_out_count``, as ``Pipeline._cascade_eligible``.  Decided
        once: ``_cascade_k`` is the fused stage count, 0 when the cascade
        never fuses.
        """
        rs = self.resampler
        if (rs is None or self.impl != "pallas"
                or getattr(rs, "stages", None) is None):
            return False
        B, L = self.chunk_blocks, self.block_samples
        if self._cascade_k is None:
            k = cascade.split_point(rs.stages) if L % 128 == 0 else 0
            fused = tuple((st.P, st.Q, st.T) for st in rs.stages[:k])
            ok = cascade.chunk_out_count(fused, B, L) is not None
            self._cascade_k = k if ok else 0
            self._cascade_stages = fused
        return self._cascade_k > 0 and total == B * L

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
        pending = None
        if self.mesh is not None:
            parts = self._dispatch_sharded(data, plans, total)
            if parts is not None:
                pending = self._start_out(parts, k)
        if pending is None:
            if self.device.type == "cuda":
                # one (7, C, B) transfer a chunk
                plans = plans.to(self.device, non_blocking=True)
                data = data.to(self.device, non_blocking=True)
            pending = self._start_out(self._dispatch_local(data, plans, total),
                                      k)
        self.spans.add("launch", k, t1, time.perf_counter())
        return pending

    def _dispatch_local(self, data, plans, total: int):
        """Launch one staged chunk down its route.  Returns the parts
        ``(channel indices, device output, n_valid)``; an output is int32
        ``(C_g, …)`` or float32 ``(2, C_g, …)``."""
        C = len(self.channels)
        everyone = list(range(C))
        rs = self.resampler
        if self._chain_eligible(total):
            if self._chain_bank is None:
                self._chain_bank = torch.from_numpy(rs.bank).to(self.device)
            if self._chain_carries is None:
                # seed from the batched resampler's per-channel history, so
                # chunks interleaved with the unfused route (or a restored
                # checkpoint) resume bitwise
                self._chain_carries = torch.stack(
                    [rs._hist_i, rs._hist_q], dim=1).to(self.device,
                                                       torch.float32)
            out, self._chain_carries = chain.mix_resample_chain_channels(
                data, plans, self._chain_bank, self._chain_carries,
                P=rs.P, Q=rs.Q, T=rs.T, intype=self.intype,
                outtype=self.outtype, dot_precision=self._chain_dot)
            n_out = self._advance([rs], [self._chain_carries], total)
            return [(everyone, out, n_out)]

        if self._cascade_eligible(total):
            k = self._cascade_k
            fused = rs.stages[:k]
            split = k < len(rs.stages)
            if self._cascade_banks is None:
                self._cascade_banks = tuple(
                    torch.from_numpy(st.bank).to(self.device) for st in fused)
            if self._cascade_carries is None:
                self._cascade_carries = tuple(
                    torch.stack([st._hist_i, st._hist_q], dim=1).to(
                        self.device, torch.float32)
                    for st in fused)
            out, self._cascade_carries = cascade.mix_cascade_channels(
                data, plans, self._cascade_banks, self._cascade_carries,
                stages=self._cascade_stages, intype=self.intype,
                outtype="f32" if split else self.outtype, final_dense=split)
            n_mid = self._advance(fused, self._cascade_carries, total)
            if not split:
                return [(everyone, out, n_mid)]
            # split: the front's planes (2, C, B, M_mid) run the remaining
            # stages batched (plain torch on the device, as the JAX package
            # runs them in XLA)
            planes = out.reshape(2, C, -1)
            yi, yq, n_out = planes[0], planes[1], n_mid
            for st in rs.stages[k:]:
                yi, yq, n_out = st.process(yi, yq, n_out,
                                           M=st.max_out_for(int(yi.shape[-1])))
            return [(everyone, self._encode(yi, yq), n_out)]

        # the unfused route: one mixer launch for all channels, then each
        # rate group's batched resampler
        no_resampling = all(g_rs is None for _, g_rs in self._groups)
        out = mixer.mix_blocks_fmt_channels(
            data, plans, intype=self.intype,
            outtype=self.outtype if no_resampling else "f32")
        if no_resampling:
            return [(everyone, out, total)]
        # any later fused chunk must reseed its carries from the histories
        self._chain_carries = None
        self._cascade_carries = None
        planes = out.reshape(2, C, -1)
        parts = []
        for idxs, g_rs in self._groups:
            if idxs == everyone:
                sub_i, sub_q = planes[0], planes[1]
            else:
                sel = torch.tensor(idxs, device=self.device)
                sub_i, sub_q = planes[0][sel], planes[1][sel]
            if g_rs is None:
                parts.append((idxs, self._encode(sub_i, sub_q), total))
            else:
                yi, yq, n_out = g_rs.process(
                    sub_i, sub_q, total,
                    M=g_rs.max_out_for(self.chunk_blocks * self.block_samples))
                parts.append((idxs, self._encode(yi, yq), n_out))
        return parts

    def _casc_group_cfg(self, g: int, rs):
        """The fused stage count with which rate group ``g``'s cascade runs
        the sharded step, or None when a shard cannot take it: the JAX
        rule on the port's geometry (``sharded.cascade_shard_replay``).
        Cached per group."""
        if g not in self._sharded_casc_cfg:
            B, L = self.chunk_blocks, self.block_samples
            k = cascade.split_point(rs.stages) if L % 128 == 0 else 0
            ok = k > 0 and sharded.cascade_shard_replay(
                rs, k, L, B // self.mesh.shape["time"]) is not None
            self._sharded_casc_cfg[g] = k if ok else None
        return self._sharded_casc_cfg[g]

    def _dispatch_sharded(self, data, plans, total: int):
        """``--mesh`` dispatch of one staged host chunk, per rate group.
        Returns the ``(channel indices, device output, n_valid)`` parts, or
        None for the unsharded dispatch (the partial EOF chunk with a
        resampler; a group that does not divide over the channel axis, or
        a cascade a shard cannot take, with a warning)."""
        B, L = self.chunk_blocks, self.block_samples
        n_chan, n_time = self.mesh.shape["channel"], self.mesh.shape["time"]
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

        def step(kind, g, make):
            if (kind, g) not in self._sharded_steps:
                self._sharded_steps[kind, g] = make()
            return self._sharded_steps[kind, g]

        parts = []
        for g, (idxs, rs) in enumerate(self._groups):
            C_g = len(idxs)
            plans_g = plans if C_g == len(self.channels) else plans[:, idxs]
            if rs is None:
                mix = step("mix", g, lambda: sharded.make_wideband_mix_step(
                    self.mesh, intype=self.intype, outtype=self.outtype, C=C_g))
                parts += [(idxs[cs], out,
                           max(0, min(L * (bs.stop - bs.start), total - bs.start * L)))
                          for cs, bs, out in mix(data, plans_g)]
            elif getattr(rs, "bank", None) is not None:
                run = step("window", g, lambda: sharded.make_wideband_stream_step(
                    self.mesh, intype=self.intype, outtype=self.outtype,
                    C=C_g, resampler=rs))
                rem, off, counts = sharded.stream_step_alignment(
                    rs, rs.in_consumed, B * L // n_time, n_time)
                out_parts, rs._hist_i, rs._hist_q = run(
                    data, plans_g, rs._hist_i, rs._hist_q, rem, off, counts)
                rs.m_next += sum(counts)
                rs.in_consumed += total
                parts += [(idxs[cs], out, counts[bs.start * n_time // B])
                          for cs, bs, out in out_parts]
            else:
                parts += self._sharded_cascade_group(g, rs, idxs, data,
                                                     plans_g, total, step)
        # a later unsharded fused chunk reseeds from the histories
        self._chain_carries = None
        self._cascade_carries = None
        return parts

    def _sharded_cascade_group(self, g, rs, idxs, data, plans, total, step):
        """One rate group's sharded fused-cascade chunk (full or split).
        Its carries are seeded from each fused stage's batched history
        every chunk, as in the JAX package, so the mesh and the unsharded
        route hand over to each other and to checkpoints bitwise."""
        k = self._sharded_casc_cfg[g]
        split = k < len(rs.stages)
        fused = rs.stages[:k]
        C_g = len(idxs)
        run = step("cascade", g, lambda: sharded.make_cascade_channels_step(
            self.mesh, resampler=rs, fused=k, C=C_g, intype=self.intype,
            outtype="f32" if split else self.outtype, final_dense=split))
        carries = tuple(torch.stack([st._hist_i, st._hist_q], dim=1)
                        for st in fused)
        out_parts, carries = run(data, plans, carries)
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
        yi, yq, n_out = planes[0], planes[1], n_mid
        for st in rs.stages[k:]:
            yi, yq, n_out = st.process(yi, yq, n_out,
                                       M=st.max_out_for(int(yi.shape[-1])))
        return [(idxs, self._encode(yi, yq), n_out)]

    def _advance(self, stages, carries, total: int) -> int:
        """Advance the fused stages' stream counters and mirror each one's
        per-channel history out of its ``(C, 2, T−1)`` device carry (no
        sync).  Returns the count leaving the last of them."""
        n_in = total
        for st, carry in zip(stages, carries):
            n_out = st.out_count_for(n_in)
            st.m_next += n_out
            st.in_consumed += n_in
            st._hist_i = carry[:, 0]
            st._hist_q = carry[:, 1]
            n_in = n_out
        return n_in

    def _encode(self, yi, yq) -> torch.Tensor:
        if self.outtype == "i16":
            return codec.iq_to_i16_words(yi, yq)
        return torch.stack([yi, yq])

    # -- output ---------------------------------------------------------------

    def _start_out(self, parts, k=None):
        """Start the device→host copies of every part's valid outputs;
        returns the finalizer that waits for them and cuts the per-channel
        byte strings, its ``wait`` and ``cut`` spans under chunk ``k`` (none
        for the drain, ``k`` None).  ``parts``: ``(channel indices, output,
        n_valid)``; a channel's parts are in stream order."""
        hosts, devices = [], []
        for idxs, out, n_valid in parts:
            if self.outtype == "i16":
                valid = out.reshape(len(idxs), -1)[:, :n_valid]
            else:
                valid = out.reshape(2, len(idxs), -1)[:, :, :n_valid]
            valid = valid.contiguous()
            if valid.device.type == "cuda":
                host = host_buffer(tuple(valid.shape), valid.dtype, valid.device)
                host.copy_(valid, non_blocking=True)
                devices.append(valid.device)
                valid = host
            hosts.append((idxs, valid))
        events = copy_events(devices)

        def finalize() -> list[bytes]:
            t0 = time.perf_counter()
            for ev in events:
                ev.synchronize()
            t1 = time.perf_counter()
            outs = self._cut(hosts)
            hosts.clear()   # free the host buffers inside the cut span, not after it
            if k is not None:
                self.spans.add("wait", k, t0, t1)
                self.spans.add("cut", k, t1, time.perf_counter())
            return outs
        return finalize

    def _cut(self, hosts) -> list[bytes]:
        """Copied-out outputs ``(channel indices, host tensor)`` → each
        channel's bytes, in stream order."""
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

    def drain(self) -> list[bytes]:
        """Flush every resampler group's FIR tail with T−1 zero samples —
        the per-channel form of ``Pipeline._drain``."""
        parts = []
        for idxs, rs in self._groups:
            if rs is None:
                continue
            pad = rs.T - 1
            if pad <= 0:
                continue
            zeros = torch.zeros((len(idxs), pad), dtype=torch.float32,
                                device=self.device)
            yi, yq, n_out = rs.process(zeros, zeros, pad, M=rs.max_out_for(pad))
            if n_out:
                parts.append((idxs, self._encode(yi, yq), n_out))
        self._chain_carries = None    # histories advanced past the stream end
        self._cascade_carries = None
        return self._start_out(parts)()

    # -- main loop ------------------------------------------------------------

    def run(self, fin, writers, should_stop=None) -> Counters:
        """Pump the stream; ``writers`` is one binary file object per channel.

        One chunk in flight, as ``Pipeline.run``: chunk k+1 is planned and
        dispatched before chunk k's output is waited for.  ``should_stop``
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

        pending = None
        pending_meta = (0, 0, None)
        hit_eof = False
        k = 0
        while True:
            if should_stop is not None and should_stop():
                break
            t0 = clock()
            chunk = reader.read_chunk(self.chunk_blocks)
            spans.add("read", k, t0, clock())
            spans.bump("chunks")
            new_pending = self.dispatch_chunk(chunk, k)
            if pending is not None:
                emit(pending, *pending_meta)
            pending = new_pending
            pending_meta = (len(chunk.data), chunk.n_blocks, k)
            k += 1
            if chunk.eof:
                hit_eof = True
                break
        if pending is not None:
            emit(pending, *pending_meta)
        # drain only on a true EOF exit: a stop between chunks is a pause,
        # and must neither flush the tails nor set the drained flag
        if hit_eof and self.drain_on_eof:
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
