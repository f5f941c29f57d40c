"""The streaming pipeline: bytes in → device chunk kernel → bytes out.

Host/device split as in ``doppler_tpu/runtime/pipeline.py``: the host does
O(blocks) work — framing, schedule evaluation, plan words, staging — and
the device runs one kernel per *chunk* of ``chunk_blocks`` reference blocks:

- a full chunk with a single-stage resampler → the fused chain kernel
  (``ops.cuda.chain``), carrying the FIR history from chunk to chunk; under
  ``precision='fast'`` its ``split3`` kernel (bf16 tensor-core dots, ≤ 1 LSB
  of the exact one);
- a full chunk with a ``MultiStageResampler`` → the fused cascade kernel
  (``ops.cuda.cascade``) over its leading ``split_point`` stages: all of
  them (mix + every stage + encode), or the ÷2^k front when the final
  stage's Q does not divide 128, whose float32 planes then run the
  remaining stages' ``RationalResampler.process``;
- any other chunk with a resampler (the partial EOF chunk) → the mixer
  kernel to float32 planes, then the resampler's ``process`` (its
  ``'window'`` or ``'conv'`` form);
- no resampler → the mixer kernel alone.

``impl='xla'`` is the JAX package's unfused route: every chunk takes the
mixer kernel and then the resampler's ``process``, never the chain or the
cascade kernel.  It is "unfused", not "plain": on the card the mixer and
the resampler's step (``csrc/window.cu`` or ``csrc/conv.cu``) are kernels.
With the ``'window'`` form its bytes are the fused route's: the window
kernel sums each output as the chain and cascade kernels do, so on the
card the bytes of a chunk depend on neither its route nor the chunk width.

:meth:`Pipeline.seek_to_block` starts a fresh pipeline at a block of the
stream without processing the blocks before it (the host split of
``parallel.distributed``): it replays the scheduler and the plan words over
the skipped blocks on the host, and rebuilds the FIR history from the raw
history blocks before the seek point through the kernel the stream runs —
a 1-block chain launch, a zero-prepadded cascade launch, or the mixer —
so the carry is bitwise the one the uninterrupted run holds there.

Dispatch never synchronises: the chunk is staged into pinned host memory,
copied to the card with ``non_blocking=True``, the kernel launches, the
device→host copy starts and an event is recorded; the finalizer
:meth:`ChunkPipeline._start_out` returns waits on that event, and its
``ready()`` asks the event without waiting.  :func:`run_chunks` calls the
finalizer of chunk k between the blocks of chunk k+1's read once
``ready()`` is true, else after chunk k+1's dispatch, so host planning of
chunk k+1 overlaps the device work of chunk k.

:class:`ChunkPipeline` holds what this pipeline shares with
``channels.MultiChannelPipeline``: the fused kernels' gates, their device
carries (seeded from and mirrored into the resampler's history, dropped by
:meth:`ChunkPipeline.drop_carries`), the fused routes, the copy-out and the
drain; :func:`run_chunks` is the loop of both.

``mesh`` (``parallel.mesh``, channel axis 1) shards each chunk's blocks
over a time grid of devices: the mixer, the chain and the cascade run per
shard (``parallel.sharded``), each shard k > 0 rebuilding its FIR carries
by replaying the raw blocks before it, so the bytes are the unsharded
run's.  The partial EOF chunk, and a cascade whose stages a shard cannot
take, run unsharded on ``device``, the mesh's first device.

``device`` is explicit and nothing falls back: ``'cuda'`` raises when no card
is present; ``'cpu'`` runs the kernels' plain versions.
"""

from __future__ import annotations

import time
from typing import Protocol, Sequence

import numpy as np
import torch

from doppler_tpu_torch.ops import codec
from doppler_tpu_torch.ops.cuda import cascade, chain, mixer
from doppler_tpu_torch.ops.cuda.cascade import carry_rows
from doppler_tpu_torch.ops.nco import PLAN_FIELDS, plan_tensor
from doppler_tpu_torch.ops.phase_plan import NCOState, plan_blocks
from doppler_tpu_torch.parallel import sharded
from doppler_tpu_torch.runtime import native
from doppler_tpu_torch.runtime import stream as streaming
from doppler_tpu_torch.runtime import telemetry
from doppler_tpu_torch.runtime.telemetry import Counters, get_logger

__all__ = ["Scheduler", "ConstScheduler", "ChunkPipeline", "Pipeline",
           "resolve_device", "carry_rows", "host_buffer", "stage_chunk",
           "copy_events", "fused_prefix", "run_chunks"]

log = get_logger("pipeline")


class Scheduler(Protocol):
    """Produces the per-block frequency shift (Hz) for successive blocks.

    ``shifts(block_counts)`` is called once per chunk with the sample count of
    each block about to be processed, in order, and must return one shift per
    block.  The pipeline presents blocks exactly once, in stream order.
    """

    def shifts(self, block_counts: Sequence[int]) -> Sequence[float]: ...


class ConstScheduler:
    """const mode: one fixed shift for the whole stream (main.rs:101-119)."""

    def __init__(self, shift_hz: float):
        self.shift_hz = float(shift_hz)

    def shifts(self, block_counts: Sequence[int]) -> Sequence[float]:
        return [self.shift_hz] * len(block_counts)


def resolve_device(device) -> torch.device:
    """``'cuda'``/``'cuda:N'``/``'cpu'`` → a torch device; raises when CUDA
    is asked for and absent (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain torch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def host_buffer(shape, dtype, device: torch.device) -> torch.Tensor:
    """A host staging tensor, pinned when ``device`` is a card."""
    return torch.empty(shape, dtype=dtype, pin_memory=device.type == "cuda")


def copy_events(devices) -> list:
    """An event (no timing) recorded now on the current stream of each card
    among ``devices``, none for the CPU: once each has completed, the
    device→host copies enqueued before it are done."""
    events = {}
    for dev in devices:
        if dev.type == "cuda" and dev not in events:
            with torch.cuda.device(dev):
                events[dev] = torch.cuda.Event()
                events[dev].record()
    return list(events.values())


def stage_chunk(data: bytes, intype: str, B: int, L: int,
                device: torch.device) -> torch.Tensor:
    """Raw chunk bytes → host tensor of the kernels' wire layout, zero
    padded to the chunk shape: int32 words ``(B, L)`` for i16, float32
    planes ``(2, B, L)`` for f32 (split by the native library's
    ``f32_pairs_to_planar_into``).  Pinned when the device is a card."""
    if intype == "i16":
        words = codec.bytes_to_i16_words(data)
        host = host_buffer((B, L), torch.int32, device)
        flat = host.numpy().reshape(-1)
        flat[:words.size] = words
        flat[words.size:] = 0
        return host
    pairs = codec.bytes_to_f32_pairs(data)
    host = host_buffer((2, B, L), torch.float32, device)
    planes = host.numpy().reshape(2, -1)
    n = pairs.shape[0]
    native.f32_pairs_to_planar_into(pairs, planes[0], planes[1])
    planes[:, n:] = 0.0
    return host


def fused_prefix(rs, B: int, L: int):
    """``(k, fused (P, Q, T))``: the leading stages of the cascade ``rs``
    that the fused cascade kernel runs over chunks of ``B`` blocks of ``L``
    samples, or None when it fuses none.

    The JAX rule, a non-empty prefix ``k = split_point(stages)`` when
    ``L % 128 == 0``, with the TPU's step geometry replaced by the kernel's
    ``chunk_out_count`` (each fused stage's chunk input count a multiple of
    its Q, a whole output count per block).
    """
    k = cascade.split_point(rs.stages) if L % 128 == 0 else 0
    fused = tuple((st.P, st.Q, st.T) for st in rs.stages[:k])
    if cascade.chunk_out_count(fused, B, L) is None:
        return None
    return k, fused


def run_chunks(reader, chunk_blocks: int, spans, dispatch, emit,
               should_stop=None) -> bool:
    """The run loop of both pipelines, at most one chunk deep.

    Reads chunk k (its ``read`` span and one ``chunks`` count) and hands it
    to ``dispatch(chunk, k)``, which returns the chunk's ``pending``
    finalizer.  The chunk before it is handed to ``emit(pending, bytes_in,
    blocks, k − 1)`` as soon as its copies are done: before each block of
    chunk k's read, the loop asks ``pending.ready()`` (non-blocking) and
    emits chunk k − 1 at the first true, bumping ``emits_early``.  If the
    read ends first (or the reader has no block boundaries, or ``pending``
    has no ``ready``), chunk k − 1 is emitted after chunk k's dispatch, so
    the host plans chunk k while the device runs chunk k − 1.  Every emit
    runs on this thread, in chunk order.  ``should_stop`` is polled before
    each read.  Returns True when the loop ended at a true EOF: only then
    may the caller drain, since a stop between chunks is a pause and
    flushing the FIR tail there would corrupt the output.
    """
    clock = time.perf_counter
    last = None         # (pending, bytes_in, blocks, k) of the chunk in flight
    eof = False
    k = 0

    def emit_if_ready():
        nonlocal last
        if last is not None and last[0].ready():
            emit(*last)
            last = None
            spans.bump("emits_early")

    while not eof and (should_stop is None or not should_stop()):
        t0 = clock()
        early = last is not None and hasattr(last[0], "ready")
        chunk = reader.read_chunk(chunk_blocks,
                                  emit_if_ready if early else None)
        spans.add("read", k, t0, clock())
        spans.bump("chunks")
        pending = dispatch(chunk, k)
        if last is not None:
            emit(*last)
        last = (pending, len(chunk.data), chunk.n_blocks, k)
        eof = chunk.eof
        k += 1
    if last is not None:
        emit(*last)
    return eof


class ChunkPipeline:
    """What :class:`Pipeline` and ``channels.MultiChannelPipeline`` share:
    the options both take and their checks, the fused kernels' gates,
    routes and device carries, the copy-out of a chunk's outputs and the
    drain.  Each subclass plans and stages its chunks, launches the unfused
    and the sharded routes, cuts its outputs (``_stage_out``) and writes
    them in its ``run`` (:func:`run_chunks`).

    Each subclass also says what its chunks are: ``_rows``, the channel
    indices of a fused chunk's part (None for the stream);
    ``_channel_dims``, the axes before a carry's I/Q (0 for the stream's
    ``(2, T−1)``, 1 for channels' ``(C, 2, T−1)``); and three methods:
    :meth:`_chain_carry_span`, the samples the chain's carry must fit in
    (a block for the stream, the chunk for channels); :meth:`_fused_kernels`,
    the chain and cascade entry points; :meth:`_lead`, the axes of a part's
    output before its samples.  ``_groups`` are its ``(rows, resampler)``
    rate groups, which :meth:`drain` flushes.
    """

    def __init__(self, samplerate: int, intype: str, outtype: str, *,
                 block_bytes: int, chunk_blocks: int, quantize_ratio_f32: bool,
                 drain_on_eof: bool, precision: str, impl: str, device, mesh):
        if impl not in ("xla", "pallas"):
            raise ValueError(f"impl must be 'xla' or 'pallas', got {impl!r}")
        self.impl = impl
        if precision not in ("exact", "fast"):
            raise ValueError(
                f"precision must be 'exact' or 'fast', got {precision!r}")
        self._chain_dot = "split3" if precision == "fast" else "highest"
        self.device = resolve_device(device)
        self.samplerate = int(samplerate)
        self.intype = intype
        self.outtype = outtype
        self.block_bytes = int(block_bytes)
        self.chunk_blocks = int(chunk_blocks)
        self.quantize_ratio_f32 = quantize_ratio_f32
        self.drain_on_eof = drain_on_eof  # flush the FIR tail with zeros at EOF
        self._drained = False  # did THIS run reach EOF and flush the tail?
        self._bps_in = streaming.bytes_per_sample(intype)
        self._bps_out = streaming.bytes_per_sample(outtype)
        self.block_samples = self.block_bytes // self._bps_in
        self.resampler = None
        # --mesh: shard the chunk's blocks over the time axis (and channels
        # over the channel axis); the bytes are the unsharded run's
        self.mesh = mesh
        if mesh is not None:
            n_time = mesh.shape["time"]
            if self.chunk_blocks % n_time:
                raise ValueError(
                    f"chunk_blocks={self.chunk_blocks} must be divisible by "
                    f"mesh time={n_time}")
            if mesh.device() != self.device:
                raise ValueError(
                    f"the mesh starts on {mesh.device()}, the pipeline "
                    f"runs on {self.device}")
        self._reset_fused_state()
        self.spans = telemetry.Spans()

    @property
    def host_s(self) -> float:
        return self.spans.seconds("schedule", "plan", "stage")

    def _reset_fused_state(self) -> None:
        self._chain_carry = None
        self._chain_bank = None
        self._cascade_k = None          # fused stages; 0 = never fused
        self._cascade_stages = None     # their (P, Q, T)
        self._cascade_banks = None
        self._cascade_carries = None    # one per fused stage
        self._sharded_casc_cfg = {}     # rate group → fused count or None
        self._sharded_steps = {}        # key → parallel.sharded step

    def drop_carries(self) -> None:
        """Drop the fused kernels' device carries, so the next fused chunk
        reseeds them from the resampler's history: after any route that
        moves the history without them (the unfused route, the sharded
        steps, the drain) and after a restored checkpoint."""
        self._chain_carry = None
        self._cascade_carries = None

    def _check_shard_history(self, rs) -> None:
        """A single-stage resampler's history must fit in one time shard."""
        n_loc = self.chunk_blocks * self.block_samples // self.mesh.shape["time"]
        if rs.T - 1 > n_loc:
            raise ValueError(
                f"resampler history ({rs.T - 1} samples) exceeds one time "
                f"shard ({n_loc} samples); use fewer/larger chunks")
        if n_loc * rs.P >= (1 << 30):
            raise ValueError("time shard too large for 32-bit phase math")

    # -- the gates ------------------------------------------------------------

    def _chain_eligible(self, total: int) -> bool:
        """May this chunk run the fused chain kernel?

        The rule of ``doppler_tpu``'s pipelines, term for term, so both
        packages send the same chunks down the same route.  The 128-sample
        terms are the TPU's lane geometry; the kernel here needs only
        ``L % Q == 0``, which they imply.  The carry's rows must fit in one
        block for the stream, in the chunk for channels
        (``_chain_carry_span``).
        """
        rs = self.resampler
        if rs is None or self.impl != "pallas":
            return False
        B, L = self.chunk_blocks, self.block_samples
        return (
            getattr(rs, "bank", None) is not None   # single-stage only
            and L % 128 == 0
            and 128 % rs.Q == 0
            and carry_rows(rs.T) <= self._chain_carry_span() // 128
            # padded tail chunks would poison the carry with zeros;
            # only the EOF chunk is partial, so this costs nothing
            and total == B * L
        )

    def _cascade_eligible(self, total: int) -> bool:
        """May this chunk run the fused cascade kernel?

        The JAX rule: a ``MultiStageResampler``, a :func:`fused_prefix` and
        a full chunk.  Decided once per resampler: ``_cascade_k`` is the
        fused stage count, 0 when the cascade never fuses.
        """
        rs = self.resampler
        if (rs is None or self.impl != "pallas"
                or getattr(rs, "stages", None) is None):
            return False
        B, L = self.chunk_blocks, self.block_samples
        if self._cascade_k is None:
            self._cascade_k, self._cascade_stages = (
                fused_prefix(rs, B, L) or (0, ()))
        return self._cascade_k > 0 and total == B * L

    def _casc_group_cfg(self, g: int, rs):
        """The fused stage count with which rate group ``g``'s cascade (the
        stream's is group 0) runs the sharded step, or None when a shard
        cannot take it: the JAX rule on the port's geometry
        (``sharded.cascade_shard_replay``).  Cached per group."""
        if g not in self._sharded_casc_cfg:
            B, L = self.chunk_blocks, self.block_samples
            pre = fused_prefix(rs, B, L)
            ok = pre is not None and sharded.cascade_shard_replay(
                rs, pre[0], L, B // self.mesh.shape["time"]) is not None
            self._sharded_casc_cfg[g] = pre[0] if ok else None
        return self._sharded_casc_cfg[g]

    # -- device carries -------------------------------------------------------

    def _seed(self, stages) -> tuple:
        """Device carries seeded from each stage's FIR history, so a fused
        chunk after the unfused route or a restore resumes bitwise."""
        return tuple(
            torch.stack([st._hist_i, st._hist_q], dim=self._channel_dims).to(
                self.device, torch.float32)
            for st in stages)

    def _advance(self, stages, carries, total: int) -> int:
        """Advance the fused stages' stream counters by a chunk of ``total``
        inputs and mirror each one's history out of its device carry (no
        sync).  Returns the count leaving the last of them."""
        n_in = total
        for st, carry in zip(stages, carries):
            n_out = st.out_count_for(n_in)
            st.m_next += n_out
            st.in_consumed += n_in
            st._hist_i = carry.select(self._channel_dims, 0)
            st._hist_q = carry.select(self._channel_dims, 1)
            n_in = n_out
        return n_in

    def _ensure_chain_state(self) -> None:
        """Seed the chain's carry and bank (idempotent; reseeds after
        :meth:`drop_carries`)."""
        if self._chain_carry is None:
            self._chain_carry, = self._seed([self.resampler])
        if self._chain_bank is None:
            self._chain_bank = torch.from_numpy(self.resampler.bank).to(
                self.device)

    def _ensure_cascade_state(self) -> None:
        """Seed the fused stages' banks and carries (idempotent; reseeds
        after :meth:`drop_carries`)."""
        fused = self.resampler.stages[:self._cascade_k]
        if self._cascade_banks is None:
            self._cascade_banks = tuple(
                torch.from_numpy(st.bank).to(self.device) for st in fused)
        if self._cascade_carries is None:
            self._cascade_carries = self._seed(fused)

    # -- dispatch -------------------------------------------------------------

    def _launch(self, data, plans, total: int, k, t0: float):
        """Launch one staged host chunk and start the copy-out of its
        outputs: the sharded steps under a mesh where they take the chunk,
        else the local route, which copies it to the device.  The
        ``launch`` span runs from ``t0``; returns the finalizer."""
        parts = None
        if self.mesh is not None:
            parts = self._dispatch_sharded(data, plans, total)
        if parts is None:
            parts = self._dispatch_local(data, plans, total)
        finalize = self._start_out(parts, k)
        self.spans.add("launch", k, t0, time.perf_counter())
        return finalize

    def _dispatch_fused(self, data, plans, total: int):
        """Run a chunk the fused chain or cascade kernel takes: its one part
        ``[(rows, device output, n_valid)]``, or None when neither gate
        passes.  A split cascade's front planes then run the remaining
        stages (plain torch on the device, as the JAX package runs them in
        XLA)."""
        rs = self.resampler
        run_chain, run_cascade = self._fused_kernels()
        if self._chain_eligible(total):
            self._ensure_chain_state()
            out, self._chain_carry = run_chain(
                data, plans, self._chain_bank, self._chain_carry,
                P=rs.P, Q=rs.Q, T=rs.T, intype=self.intype,
                outtype=self.outtype, dot_precision=self._chain_dot)
            n_out = self._advance([rs], [self._chain_carry], total)
            return [(self._rows, out, n_out)]
        if not self._cascade_eligible(total):
            return None
        self._ensure_cascade_state()
        k = self._cascade_k
        split = k < len(rs.stages)
        out, self._cascade_carries = run_cascade(
            data, plans, self._cascade_banks, self._cascade_carries,
            stages=self._cascade_stages, intype=self.intype,
            outtype="f32" if split else self.outtype, final_dense=split)
        n_out = self._advance(rs.stages[:k], self._cascade_carries, total)
        if split:
            # the front's planes (2, [C,] B, M_mid), flattened per channel
            planes = out.flatten(1 + self._channel_dims)
            yi, yq, n_out = rs.process(planes[0], planes[1], n_out, start=k)
            out = codec.encode(yi, yq, self.outtype)
        return [(self._rows, out, n_out)]

    def _step(self, key, make):
        """The sharded step under ``key``, made on first use."""
        if key not in self._sharded_steps:
            self._sharded_steps[key] = make()
        return self._sharded_steps[key]

    def _sharded_mix(self, key, C: int, data, plans, total: int) -> list:
        """The sharded mixer over ``C`` channels: ``(channel slice, output,
        n_valid)`` a shard."""
        L = self.block_samples
        mix = self._step(key, lambda: sharded.make_wideband_mix_step(
            self.mesh, intype=self.intype, outtype=self.outtype, C=C))
        return [(cs, out, max(0, min(L * (bs.stop - bs.start),
                                     total - bs.start * L)))
                for cs, bs, out in mix(data, plans)]

    def _sharded_window(self, key, C: int, rs, data, plans, total: int) -> list:
        """The sharded mixer + window resampler step over ``C`` channels of
        the single-stage ``rs``, which it advances: ``(channel slice,
        output, n_valid)`` a shard."""
        B, L = self.chunk_blocks, self.block_samples
        n_time = self.mesh.shape["time"]
        run = self._step(key, lambda: sharded.make_wideband_stream_step(
            self.mesh, intype=self.intype, outtype=self.outtype, C=C,
            resampler=rs))
        rem, off, counts = sharded.stream_step_alignment(
            rs, rs.in_consumed, B * L // n_time, n_time)
        parts, rs._hist_i, rs._hist_q = run(data, plans, rs._hist_i,
                                            rs._hist_q, rem, off, counts)
        rs.m_next += sum(counts)
        rs.in_consumed += total
        return [(cs, out, counts[bs.start * n_time // B])
                for cs, bs, out in parts]

    # -- output ---------------------------------------------------------------

    def _start_out(self, parts, k=None):
        """Start the device→host copies of the valid outputs; returns the
        finalizer that waits for them and returns :meth:`_stage_out` of the
        host copies, its ``wait`` and ``cut`` spans under chunk ``k`` (none
        for the drain, ``k`` None).  The finalizer's ``ready()`` says,
        without waiting, whether every copy is done (always, on the CPU).
        ``parts``: ``(rows, device output, n_valid)``, in stream order for
        each row; the finalizer's ``hosts``: ``(rows, host tensor)``."""
        hosts, devices = [], []
        for rows, out, n_valid in parts:
            shape = (*self._lead(rows), -1)
            if self.outtype != "i16":
                shape = (2, *shape)
            valid = out.reshape(shape)[..., :n_valid].contiguous()
            if valid.device.type == "cuda":
                host = host_buffer(tuple(valid.shape), valid.dtype, valid.device)
                host.copy_(valid, non_blocking=True)
                devices.append(valid.device)
                valid = host
            hosts.append((rows, valid))
        events = copy_events(devices)

        def finalize():
            t0 = time.perf_counter()
            for ev in events:
                ev.synchronize()
            t1 = time.perf_counter()
            outs = self._stage_out(hosts)
            hosts.clear()   # free the host buffers inside the cut span, not after it
            if k is not None:
                self.spans.add("wait", k, t0, t1)
                self.spans.add("cut", k, t1, time.perf_counter())
            return outs
        finalize.ready = lambda: all(ev.query() for ev in events)
        return finalize

    def drain(self):
        """Flush each ``(rows, resampler)`` group's FIR tail by feeding T−1
        zero samples — the outputs whose windows straddle the end of the
        stream — and return their :meth:`_stage_out` cut (empty with no
        tail).  The histories move past the stream's end, so the carries
        drop."""
        parts = []
        for rows, rs in self._groups:
            pad = 0 if rs is None else rs.T - 1
            if pad <= 0:
                continue
            shape = (*self._lead(rows), pad)
            zeros = torch.zeros(shape, dtype=torch.float32, device=self.device)
            yi, yq, n_out = rs.process(zeros, zeros, pad, M=rs.max_out_for(pad))
            if n_out:
                parts.append((rows, codec.encode(yi, yq, self.outtype), n_out))
        self.drop_carries()
        return self._start_out(parts)()


class Pipeline(ChunkPipeline):
    """Streaming Doppler corrector on one device.

    Parameters mirror the reference CLI surface: sample rate, input/output
    IQ dtypes, and a :class:`Scheduler` supplying per-block shifts.
    ``block_bytes`` defaults to the reference's 8192 so track-mode schedules
    match the reference; ``chunk_blocks`` blocks form one device dispatch.
    ``prefetch_chunks``: chunks a reader thread stages ahead of the
    dispatch (``streaming.ChunkPrefetcher``; 0 = read in the loop).
    ``impl``: ``'pallas'`` (the default) runs full chunks through the fused
    chain or cascade kernel where the gates take them; ``'xla'`` runs every
    chunk through the mixer kernel and the resampler (the JAX package's
    ``impl='xla'``; under a mesh, the sharded mixer + resampler step for a
    single-stage resampler, and a cascade unsharded).
    ``precision``: ``'exact'`` or ``'fast'``, as in the JAX package: 'fast'
    runs the fused single-stage chain's dot as ``split3``
    (``ops.cuda.chain``); the cascade, the mixer + resampler route of the
    EOF chunk and the drain stay exact, so with a cascade 'fast' gives the
    exact bytes.

    ``mesh``: a ``parallel.mesh.Mesh`` with channel axis 1 whose first
    device is ``device``; ``chunk_blocks`` must divide over its time axis.
    Its bytes are the unsharded run's (``--precision`` does not apply to
    its chain chunks, which keep the exact dot, as in the JAX package).

    ``spans``: the newest :meth:`run`'s ``telemetry.Spans``, each chunk's
    ``read``, ``schedule``, ``plan``, ``stage``, ``launch``, ``wait``,
    ``cut`` and ``write``.  ``host_s`` is the host's planning and staging
    seconds, the ``schedule``, ``plan`` and ``stage`` totals.
    """

    _rows = None            # the stream's parts have no channel rows
    _channel_dims = 0       # carries (2, T−1); outputs (n,) or (2, n)

    def __init__(
        self,
        samplerate: int,
        intype: str,
        outtype: str,
        scheduler: Scheduler,
        *,
        block_bytes: int = streaming.REFERENCE_BLOCK_BYTES,
        chunk_blocks: int = 256,
        quantize_ratio_f32: bool = True,
        drain_on_eof: bool = False,
        prefetch_chunks: int = 0,
        precision: str = "exact",
        impl: str = "pallas",
        device="cuda",
        mesh=None,
    ):
        if samplerate <= 0:
            raise ValueError("samplerate must be positive")
        super().__init__(
            samplerate, intype, outtype, block_bytes=block_bytes,
            chunk_blocks=chunk_blocks, quantize_ratio_f32=quantize_ratio_f32,
            drain_on_eof=drain_on_eof, precision=precision, impl=impl,
            device=device, mesh=mesh)
        self.scheduler = scheduler
        self.prefetch_chunks = int(prefetch_chunks)  # staged-read queue depth
        self.nco_state = NCOState()   # the stream's entire resumable DSP state
        if self.block_bytes % self._bps_in != 0:
            raise ValueError(
                f"block_bytes={block_bytes} not a multiple of the "
                f"{intype} sample size {self._bps_in}"
            )
        self._sample_offset = 0  # absolute index of next input sample
        if mesh is not None and mesh.shape["channel"] != 1:
            raise ValueError(
                "single-stream pipeline needs mesh channel=1 "
                "(use channels mode for channel parallelism)")

    def set_resampler(self, resampler) -> None:
        """Insert a post-mix resampler stage (``ops.resample``)."""
        if resampler.device != self.device:
            raise ValueError(
                f"resampler lives on {resampler.device}, pipeline on "
                f"{self.device}")
        self.resampler = resampler
        self._reset_fused_state()
        if self.mesh is None:
            return
        if getattr(resampler, "bank", None) is not None:
            self._check_shard_history(resampler)
        elif not self._cascade_mesh_ok():
            log.warning(
                "mesh mode: this cascade cannot run the sharded fused "
                "step (geometry/impl) — resampling runs on the default "
                "device")

    def _cascade_mesh_ok(self) -> bool:
        """May ``--mesh`` chunks run the sharded fused cascade step?  The
        fused prefix of a full chunk, when a shard takes it
        (:meth:`_casc_group_cfg`); the split form shards its ÷2^k front."""
        return (self.mesh is not None
                and self._cascade_eligible(self.chunk_blocks * self.block_samples)
                and self._casc_group_cfg(0, self.resampler) is not None)

    # -- multi-host seek -----------------------------------------------------

    def seek_history_blocks(self) -> int:
        """Raw capture blocks :meth:`seek_to_block` needs as ``history``
        (read them from just before the seek point).  1 for single-stage
        resamplers; for cascades, enough blocks to cover the replay's
        corrupt head + carry cone (heavy rates — e.g. config 5's
        100 Msps → 48 ksps — need several reference blocks).

        The count is the JAX package's, whose fused carries are whole
        128-sample rows (:func:`carry_rows`); the port's flat ``(2, T−1)``
        carries need fewer samples, but both packages then read the same
        history bytes before a host's range."""
        rs = self.resampler
        if rs is None or rs.T <= 1:
            return 0
        if getattr(rs, "bank", None) is not None:
            return 1
        L = self.block_samples
        if self._cascade_eligible(self.chunk_blocks * L):
            return -(-self._cascade_replay_need() // L)
        return -(-(2 * (rs.T - 1)) // L)

    def _cascade_replay_need(self) -> int:
        """Input samples the seek's replay needs: the corrupt head of the
        whole cascade plus its longest stage carry, whole 128-sample rows
        for the fused stages and T−1 for the tail's."""
        return cascade.cascade_replay_need(self.resampler.stages,
                                           self.samplerate, self._cascade_k)

    def _stage_history(self, history: bytes, n_blocks: int, tail) -> tuple:
        """The last ``tail.shape[1]`` history blocks, zero-prepadded to
        ``n_blocks`` blocks, on the device: ``(data, plans)`` with the
        padding blocks' plan words zero (they mix to zeros)."""
        k_h = tail.shape[1]
        pad = b"\0" * ((n_blocks - k_h) * self.block_bytes)
        data = stage_chunk(pad + history[len(history) - k_h * self.block_bytes:],
                           self.intype, n_blocks, self.block_samples,
                           self.device)
        fields = np.zeros((7, n_blocks), dtype=np.uint32)
        fields[:, n_blocks - k_h:] = tail
        return (data.to(self.device),
                plan_tensor(list(fields), device=self.device))

    def seek_to_block(self, n_blocks: int, history: bytes | None = None) -> None:
        """Fast-forward a FRESH pipeline to block ``n_blocks`` without
        processing the prefix — the multi-host "distribute = seek"
        primitive (``parallel.distributed``).

        Replays the scheduler and the exact NCO-counter emulation over the
        skipped prefix (host work only), seeds the resampler's stream
        counters from absolute-index arithmetic, and rebuilds its FIR
        history by mixing ``history`` — the raw bytes of the
        :meth:`seek_history_blocks` blocks ending at ``n_blocks``, read
        straight from the shared capture — through the kernel the stream
        runs.  A pipeline seeked this way emits exactly the bytes the
        uninterrupted run emits from that block on.
        """
        if n_blocks < 0:
            raise ValueError("n_blocks must be >= 0")
        if self._sample_offset:
            raise ValueError("seek_to_block needs a fresh pipeline")
        L = self.block_samples
        k_h = 0 if history is None else len(history) // self.block_bytes
        # rolling per-block plan tail for the history replay (each history
        # block needs its OWN plan words)
        tail_fields = None
        done = 0
        while done < n_blocks:
            n = min(self.chunk_blocks, n_blocks - done)
            counts = [L] * n
            shifts = list(self.scheduler.shifts(counts))
            plan = plan_blocks(
                shifts, counts, self.samplerate, self.nco_state, L,
                quantize_f32=self.quantize_ratio_f32,
            )
            if k_h:
                fields = np.stack([np.asarray(getattr(plan, f), dtype=np.uint32)
                                   for f in PLAN_FIELDS])
                tail_fields = (
                    fields if tail_fields is None
                    else np.concatenate([tail_fields, fields], axis=1)
                )[:, -k_h:]
            done += n
        self._sample_offset = n_blocks * L
        rs = self.resampler
        if rs is None:
            return
        if getattr(rs, "bank", None) is None:
            self._seek_cascade(n_blocks, history, tail_fields)
            return
        s_lo = n_blocks * L
        rs.in_consumed = s_lo
        rs.m_next = -(-s_lo * rs.P // rs.Q)
        if rs.T <= 1 or n_blocks == 0:
            return
        h = rs.T - 1
        if history is None or len(history) < self.block_bytes:
            raise ValueError(
                "seek with a resampler needs the raw bytes of the "
                "preceding full block as history"
            )
        if h > L:
            raise ValueError(
                f"history of one block ({L} samples) is shorter than the "
                f"resampler's {h}-sample FIR history")
        # the single-stage path needs exactly one block — the last
        data, plans = self._stage_history(history, 1, tail_fields[:, -1:])
        if self._chain_eligible(self.chunk_blocks * L):
            # replay through a 1-block call of the chain kernel with the
            # stream's dot: its carry is the mixed history, bitwise the
            # stream's
            self._ensure_chain_state()
            _, carry = chain.mix_resample_chain_stream(
                data, plans, self._chain_bank, torch.zeros_like(self._chain_carry),
                P=rs.P, Q=rs.Q, T=rs.T, intype=self.intype, outtype=self.outtype,
                dot_precision=self._chain_dot,
            )
            self._chain_carry = carry
            rs._hist_i, rs._hist_q = carry[0], carry[1]
            return
        # the mixer route: the kernel the stream's mixer + resampler chunks
        # run, bitwise whatever the chunk width
        mixed = mixer.mix_blocks_fmt(data, plans, intype=self.intype,
                                     outtype="f32").reshape(2, L)
        rs._hist_i, rs._hist_q = mixed[0, L - h:], mixed[1, L - h:]

    def _seek_cascade(self, n_blocks: int, history: bytes | None,
                      tail_fields) -> None:
        """Cascade arm of :meth:`seek_to_block`: rebuild every stage's FIR
        history from the raw history blocks (``tail_fields`` holds their
        plan words, ``(7, k_h)``).

        The replay starts each stage with zero history, so its first
        ``rs.T − 1`` input-referred samples are corrupt; each stage's carry
        depends only on the span's tail (its cone), so the history suffices
        whenever the cone and the corrupt head do not overlap (checked).
        The replay runs the program the stream runs: the fused cascade
        kernel (its carries are bitwise whatever the chunk width), or the
        mixer and the cascade's own ``process``.
        """
        rs = self.resampler
        L = self.block_samples
        n_in = n_blocks * L
        counters = []
        for st in rs.stages:
            n_out = -(-n_in * st.P // st.Q)
            counters.append((n_in, n_out))
            n_in = n_out

        def pin(stages, counts):
            for st, (c_in, c_out) in zip(stages, counts):
                st.in_consumed = c_in
                st.m_next = c_out

        if rs.T <= 1 or n_blocks == 0:
            pin(rs.stages, counters)
            return
        if (history is None or len(history) < self.block_bytes
                or len(history) % self.block_bytes):
            raise ValueError(
                "seek with a resampler needs whole raw capture blocks as "
                "history (see seek_history_blocks)"
            )
        k_h = min(len(history) // self.block_bytes, tail_fields.shape[1])
        tail = tail_fields[:, -k_h:]
        if self._cascade_eligible(self.chunk_blocks * L):
            # the zero-history corrupt head plus every stage's carry cone
            # must fit inside the replayed real blocks
            need = self._cascade_replay_need()
            if k_h * L < need:
                raise ValueError(
                    f"history ({k_h} blocks = {k_h * L} samples) too short "
                    f"to reconstruct the cascade's state (needs ≥ "
                    f"{need}; see seek_history_blocks)"
                )
            self._ensure_cascade_state()
            # zero-prepad to the fewest blocks the kernel takes, the real
            # blocks last: zero blocks with zero plan words mix to zeros, so
            # each carry (inside the real span by the cone bound) is bitwise
            # what the stream held entering block n_blocks
            stages = self._cascade_stages
            B_r = k_h
            while cascade.chunk_out_count(stages, B_r, L) is None:
                B_r += 1
            data, plans = self._stage_history(history, B_r, tail)
            k = self._cascade_k
            split = k < len(rs.stages)
            out, carries = cascade.mix_cascade_stream(
                data, plans, self._cascade_banks,
                tuple(torch.zeros_like(c) for c in self._cascade_carries),
                stages=stages, intype=self.intype,
                outtype="f32" if split else self.outtype, final_dense=split,
            )
            self._cascade_carries = carries
            for st, carry in zip(rs.stages, carries):
                st._hist_i, st._hist_q = carry[0], carry[1]
            pin(rs.stages[:k], counters)
            if split:
                # the tail stages: the real blocks' front planes through the
                # stream's own ``process`` leave each tail stage holding the
                # stream's FIR history; then pin the absolute counters
                planes = out.reshape(2, B_r, -1)[:, B_r - k_h:]
                yi, yq = planes[0].reshape(-1), planes[1].reshape(-1)
                rs.process(yi, yq, int(yi.shape[-1]), start=k)
                pin(rs.stages[k:], counters[k:])
            return
        # unfused: each stage only needs its T−1 input-referred history
        # past the corrupt head — no 128-row carry padding
        if k_h * L < 2 * (rs.T - 1):
            raise ValueError(
                f"history ({k_h} blocks = {k_h * L} samples) too short to "
                f"reconstruct the cascade's state (needs ≥ "
                f"{2 * (rs.T - 1)}; see seek_history_blocks)"
            )
        data, plans = self._stage_history(history, k_h, tail)
        mixed = mixer.mix_blocks_fmt(data, plans, intype=self.intype,
                                     outtype="f32").reshape(2, -1)
        rs.process(mixed[0], mixed[1], k_h * L)
        pin(rs.stages, counters)

    # -- output ---------------------------------------------------------------

    @property
    def _groups(self) -> list:
        return [(None, self.resampler)]     # the stream is one rate group

    def _chain_carry_span(self) -> int:
        return self.block_samples

    def _fused_kernels(self):
        return chain.mix_resample_chain_stream, cascade.mix_cascade_stream

    def _lead(self, rows) -> tuple:
        return ()

    def _stage_out(self, hosts) -> bytes:
        """The cut: valid outputs in stream order (int32 words, or float32
        planes ``(2, n)``) → bytes."""
        if not hosts:
            return b""      # a drain with no tail
        arr = np.concatenate([h.numpy() for _, h in hosts], axis=-1)
        if self.outtype == "i16":
            return codec.i16_words_to_bytes(arr)
        return codec.f32_pairs_to_bytes(native.planar_to_f32_pairs(arr[0], arr[1]))

    # -- dispatch -------------------------------------------------------------

    def _dispatch(self, chunk: streaming.Chunk, k=None):
        """Plan + launch one chunk on the device WITHOUT waiting for it;
        its ``schedule``, ``plan``, ``stage`` and ``launch`` spans carry
        the chunk id ``k``.  Returns the finalizer of its bytes, None for
        a chunk of no samples.

        All host state (scheduler, NCO counter, resampler bookkeeping)
        advances here, so the next chunk can be dispatched while this one
        computes.
        """
        counts = [size // self._bps_in for size in chunk.block_sizes]
        total = sum(counts)
        clock = time.perf_counter
        t0 = clock()
        shifts = list(self.scheduler.shifts(counts)) if counts else []
        t1 = clock()
        self.spans.add("schedule", k, t0, t1)
        if total == 0:
            return None     # empty tail blocks still advanced the scheduler
        assert len(shifts) == len(counts)
        plan = plan_blocks(
            shifts, counts, self.samplerate, self.nco_state, self.block_samples,
            quantize_f32=self.quantize_ratio_f32,
        )
        plans = plan_tensor(plan, self.chunk_blocks)
        t2 = clock()
        data = stage_chunk(chunk.data, self.intype, self.chunk_blocks,
                           self.block_samples, self.device)
        t3 = clock()
        self.spans.add("plan", k, t1, t2)
        self.spans.add("stage", k, t2, t3)
        self._sample_offset += total
        return self._launch(data, plans, total, k, t3)

    def _dispatch_sharded(self, data, plans, total: int):
        """``--mesh`` dispatch of one staged host chunk over the time shards.
        Returns the ``(None, device output, n_valid)`` parts in stream
        order, or None for the unsharded dispatch: the partial EOF chunk
        with a resampler, and a cascade whose stages a shard cannot take
        (which ``set_resampler`` warned of).

        Mix-only streams shard every chunk.  A full chunk runs the chain
        step when the chain gate passes, the cascade step (full or split)
        when ``_cascade_mesh_ok``, else — a single-stage resampler the
        chain gate refuses — the mixer + window resampler step.
        """
        rs = self.resampler
        n_time = self.mesh.shape["time"]
        if rs is None:
            return [(None, out, n) for _, out, n
                    in self._sharded_mix("mix", 1, data, plans, total)]
        if total != self.chunk_blocks * self.block_samples:
            return None            # the EOF chunk: mixer + resampler

        if self._chain_eligible(total):
            run = self._step("chain", lambda: sharded.make_chain_stream_step(
                self.mesh, resampler=rs, intype=self.intype,
                outtype=self.outtype))
            self._ensure_chain_state()
            outs, self._chain_carry = run(data, plans, self._chain_carry)
            self._advance([rs], [self._chain_carry], total)
            b_loc = self.chunk_blocks // n_time
            return [(None, out, out.shape[-1] * b_loc) for out in outs]

        if self._cascade_mesh_ok():
            self._ensure_cascade_state()
            k = self._cascade_k
            split = k < len(rs.stages)
            run = self._step("cascade", lambda: sharded.make_cascade_stream_step(
                self.mesh, resampler=rs, fused=k, intype=self.intype,
                outtype="f32" if split else self.outtype, final_dense=split))
            outs, self._cascade_carries = run(data, plans,
                                              self._cascade_carries)
            n_mid = self._advance(rs.stages[:k], self._cascade_carries, total)
            if not split:
                return [(None, out, n_mid // n_time) for out in outs]
            # split: the tail stages run once, over the gathered front
            # planes, on the mesh's first device
            planes = torch.cat([out.reshape(2, -1).to(self.device)
                                for out in outs], dim=1)
            yi, yq, n_out = rs.process(planes[0], planes[1], n_mid, start=k)
            return [(None, codec.encode(yi, yq, self.outtype), n_out)]

        if getattr(rs, "bank", None) is None:
            return None            # a cascade the mesh cannot shard
        return [(None, out, n) for _, out, n
                in self._sharded_window("window", 1, rs, data, plans, total)]

    def _dispatch_local(self, data, plans, total: int):
        """Launch one staged host chunk: the fused chain or cascade on a
        full chunk, else the mixer (+ the resampler).  Returns its one part
        ``(None, device output, n_valid)``."""
        if self.device.type == "cuda":
            # plan_tensor's words are pageable: pin them for an async copy
            plans = plans.pin_memory().to(self.device, non_blocking=True)
            data = data.to(self.device, non_blocking=True)
        fused = self._dispatch_fused(data, plans, total)
        if fused is not None:
            return fused
        rs = self.resampler
        out = mixer.mix_blocks_fmt(data, plans, intype=self.intype,
                                   outtype=self.outtype if rs is None else "f32")
        if rs is None:
            return [(None, out, total)]
        planes = out.reshape(2, -1)
        yi, yq, n_out = rs.process(
            planes[0], planes[1], total,
            M=rs.max_out_for(self.chunk_blocks * self.block_samples),
        )
        self.drop_carries()   # a later fused chunk reseeds from the history
        return [(None, codec.encode(yi, yq, self.outtype), n_out)]

    # -- main loop ----------------------------------------------------------

    def run(self, fin, fout, should_stop=None) -> Counters:
        """Pump ``fin`` → ``fout`` until EOF (short read), reference framing.

        A chunk is written once its device→host copy is done, between the
        blocks of the next chunk's read, or else after the next chunk's
        dispatch (:func:`run_chunks`; with ``prefetch_chunks`` always
        after).  ``should_stop``: optional callable polled between chunks —
        a stop leaves the pipeline state consistent with the bytes written,
        so a later ``run`` on the rest of the stream continues it exactly.
        Each run records its chunks' spans in a fresh ``self.spans``.
        """
        reader = streaming.BlockReader(fin, self.block_bytes)
        if self.prefetch_chunks > 0:
            reader = streaming.ChunkPrefetcher(
                reader, self.chunk_blocks, depth=self.prefetch_chunks)
        counters = Counters()
        spans = self.spans = telemetry.start_spans()
        clock = time.perf_counter

        def emit(finalize, bytes_in, blocks, k):
            out_bytes = b"" if finalize is None else finalize()
            t0 = clock()
            if out_bytes:
                fout.write(out_bytes)
                fout.flush()
            counters.add(
                samples=len(out_bytes) // self._bps_out,
                bytes_in=bytes_in,
                bytes_out=len(out_bytes),
                blocks=blocks,
            )
            if finalize is not None:
                spans.add("write", k, t0, clock())

        eof = run_chunks(reader, self.chunk_blocks, spans, self._dispatch,
                         emit, should_stop)
        if eof and self.resampler is not None and self.drain_on_eof:
            out_bytes = self.drain()
            self._drained = True   # checkpointed: a resumed run must not
            if out_bytes:          # append the FIR tail a second time
                fout.write(out_bytes)
                counters.add(
                    samples=len(out_bytes) // self._bps_out,
                    bytes_in=0, bytes_out=len(out_bytes), blocks=0,
                )
        fout.flush()
        return counters
