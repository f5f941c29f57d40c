"""Sharded chunk processing: the device steps of ``--mesh`` over a
``(channel, time)`` grid of devices.

The torch statement of ``doppler_tpu/parallel/sharded.py``.  Each step is a
plain function that loops over the mesh's shards and launches the port's
kernels on each shard's device (``parallel.mesh``); nothing is compiled
per mesh.

The mixer shards as it is: the phase is a pure function of a block's plan
words.  The FIR stages carry history across a time shard's left edge.  In
JAX the left neighbour's last raw blocks travel there by ``lax.ppermute``;
here the host already holds the whole raw chunk, so shard k's host→device
copy takes the ``r`` blocks before its own with it, and the shard replays
them through the stream's own kernel from zero carries — a 1-block chain
call, an ``r_h``-block cascade call, or the mixer for a single-stage
resampler's T−1 mixed samples.  The replay runs the stream's program on
the stream's inputs, so its carries are bitwise the ones the unsharded run
holds there, and a mesh run's bytes equal the unsharded run's.  Shard 0
takes the streamed carry instead; the last shard's carry, moved to the
mesh's first device, seeds the next chunk.

Alignment is arithmetic, not communicated: shard k owns inputs
``[k·n_loc, (k+1)·n_loc)`` of the chunk and computes exactly the outputs m
whose newest input ``⌊mQ/P⌋`` falls there (:func:`shard_alignment`).

Every step launches on the current stream of each shard's device: shards
on one card run one after the other on its stream, in stream order.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from doppler_tpu_torch.ops import codec
from doppler_tpu_torch.ops.cuda import cascade, chain, mixer
from doppler_tpu_torch.ops.resample import (
    conv_stream_geometry,
    resample_conv_stream,
    window_resample,
)
from doppler_tpu_torch.parallel.mesh import shard_slices

__all__ = [
    "make_sharded_step",
    "shard_valid_out_counts",
    "shard_alignment",
    "shard_conv_alignment",
    "stream_step_alignment",
    "cascade_shard_replay",
    "make_wideband_mix_step",
    "make_wideband_stream_step",
    "make_chain_stream_step",
    "make_cascade_stream_step",
    "make_cascade_channels_step",
]


def shard_valid_out_counts(n_samples_per_shard: int, n_time: int, P_: int, Q_: int):
    """Host: valid output count per time shard (for slicing padded outputs)."""
    counts = []
    for k in range(n_time):
        s0 = k * n_samples_per_shard
        s1 = (k + 1) * n_samples_per_shard
        m_lo = -(-s0 * P_ // Q_)
        m_hi = -(-s1 * P_ // Q_)
        counts.append(m_hi - m_lo)
    return counts


def shard_alignment(s_abs: int, n_loc: int, n_time: int, P_: int, Q_: int):
    """Host: exact per-time-shard resample alignment for one full chunk.

    The chunk's first input has absolute index ``s_abs``; shard k owns inputs
    ``[s_abs + k·n_loc, s_abs + (k+1)·n_loc)`` and therefore the outputs m
    whose newest-needed input ``⌊mQ/P⌋`` lands in that range.  Exact Python
    ints — O(n_time) per chunk, valid for arbitrary stream length.

    Returns ``(rem, off, counts)``: int32 arrays ``(n_time,)`` of each
    shard's first-output phase remainder and window offset, plus the Python
    list of valid output counts per shard.
    """
    ms = [-(-(s_abs + k * n_loc) * P_ // Q_) for k in range(n_time + 1)]
    rem = np.zeros(n_time, np.int32)
    off = np.zeros(n_time, np.int32)
    for k in range(n_time):
        a_k = s_abs + k * n_loc
        rem[k] = (ms[k] * Q_) % P_
        off[k] = (ms[k] * Q_) // P_ - a_k
    counts = [ms[k + 1] - ms[k] for k in range(n_time)]
    return rem, off, counts


def shard_conv_alignment(s_abs: int, n_loc: int, n_time: int,
                         P_: int, Q_: int):
    """Host: per-time-shard ``(start0, p0, counts)`` for the conv step.

    Same ownership rule as :func:`shard_alignment`; shard k behaves exactly
    like a streaming chunk with ``in_consumed = s_abs + k·n_loc`` and
    ``m_next = ms[k]`` (``ops.resample.conv_stream_geometry``).
    """
    ms = [-(-(s_abs + k * n_loc) * P_ // Q_) for k in range(n_time + 1)]
    start0 = np.zeros(n_time, np.int32)
    p0 = np.zeros(n_time, np.int32)
    for k in range(n_time):
        a_k = s_abs + k * n_loc
        i0, pk = divmod(ms[k], P_)
        start0[k] = i0 * Q_ - a_k
        p0[k] = pk
    counts = [ms[k + 1] - ms[k] for k in range(n_time)]
    return start0, p0, counts


def stream_step_alignment(rs, s_abs: int, n_loc: int, n_time: int):
    """Host: the ``(a1, a2, counts)`` triple of ``rs.impl``'s sharded step:
    ``(rem, off)`` for ``'window'``, ``(start0, p0)`` for ``'conv'``."""
    if rs.impl == "conv":
        return shard_conv_alignment(s_abs, n_loc, n_time, rs.P, rs.Q)
    return shard_alignment(s_abs, n_loc, n_time, rs.P, rs.Q)


def cascade_shard_replay(resampler, fused: int, L: int, b_loc: int) -> int | None:
    """Replay span in blocks of the sharded cascade over the first ``fused``
    stages of ``resampler`` at shards of ``b_loc`` blocks of ``L``
    samples, or None when such a shard cannot run them: the stages do not
    take ``b_loc`` blocks (``ops.cuda.cascade.chunk_out_count``) or the
    span is longer than a shard."""
    stages = tuple((st.P, st.Q, st.T) for st in resampler.stages[:fused])
    if not stages or cascade.chunk_out_count(stages, b_loc, L) is None:
        return None
    need = cascade.cascade_replay_need(resampler.stages[:fused],
                                       resampler.in_rate)
    r_h = cascade.widen_replay_span(need, L, b_loc, stages)
    return r_h if r_h <= b_loc else None


# -- plumbing -------------------------------------------------------------------

def _on(dev: torch.device):
    """Make ``dev`` the current card while a shard launches (the kernels
    launch on the current device)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _to(part: torch.Tensor, dev) -> torch.Tensor:
    """A host slice on ``dev`` without waiting for the card: a host→device
    copy from pageable memory first synchronises the stream, which would
    hold each shard's copy until the shards before it have run, so a slice
    that is not a contiguous piece of pinned memory goes through a pinned
    buffer."""
    if (dev.type == "cuda" and part.device.type == "cpu"
            and not (part.is_contiguous() and part.is_pinned())):
        staged = torch.empty(part.shape, dtype=part.dtype, pin_memory=True)
        part = staged.copy_(part)
    return part.to(dev, non_blocking=True)


def _blocks(data: torch.Tensor, lo: int, hi: int, dev) -> torch.Tensor:
    """Blocks ``[lo, hi)`` of a raw chunk — int32 ``(B, L)`` or float32
    ``(2, B, L)`` — on ``dev``."""
    return _to(data[lo:hi] if data.dim() == 2 else data[:, lo:hi], dev)


def _plans(plans: torch.Tensor, lo: int, hi: int, dev, cs=None) -> torch.Tensor:
    """Plan words of blocks ``[lo, hi)`` — of channels ``cs`` when given —
    on ``dev``."""
    return _to(plans[..., lo:hi] if cs is None else plans[:, cs, lo:hi], dev)


def _split(x: torch.Tensor, r: int):
    """A shard's staged blocks → (the r replay blocks, its own blocks)."""
    if x.dim() == 2:
        return x[:r], x[r:]
    return x[:, :r], x[:, r:]


class _PerDevice:
    """A constant (taps, banks) made once on each device that asks for it."""

    def __init__(self, make):
        self._make = make
        self._made: dict = {}

    def get(self, dev):
        if dev not in self._made:
            self._made[dev] = self._make(dev)
        return self._made[dev]


def _banks(stages) -> _PerDevice:
    return _PerDevice(lambda dev: tuple(
        torch.from_numpy(st.bank).to(dev) for st in stages))


def _check_channels(mesh, C: int) -> None:
    n_chan = mesh.shape["channel"]
    if C % n_chan:
        raise ValueError(f"channels {C} must divide over mesh channel={n_chan}")


# -- the op-level step ------------------------------------------------------------

def make_sharded_step(mesh, *, intype: str = "i16", outtype: str = "i16",
                      resampler=None):
    """The op-level sharded chunk step over per-channel chunks.

    Returns ``step(data, plans)`` where ``data`` is ``(C, B, L)`` int32
    words or ``(2, C, B, L)`` float32 planes, one chunk per channel, and
    ``plans`` the ``(7, C, B)`` plan words; ``C`` shards over ``channel``
    and ``B`` over ``time``.  A shard mixes its channels' blocks in one
    mixer launch (the mixer is pure per block).

    Without a resampler the output has the input's layout in ``outtype``.
    With one, each channel is a stream from zero history: the output is
    ``(C, n_time, M_max)`` words or ``(2, C, n_time, M_max)`` planes,
    padded per shard (:func:`shard_valid_out_counts` gives the valid
    counts); shard k > 0 mixes its left neighbour's last ⌈(T−1)/L⌉ blocks
    for its T−1-sample halo, shard 0 reads zeros.  The result lies on the
    mesh's first device.
    """
    n_time = mesh.shape["time"]
    dev0 = mesh.device()

    def mix(x, p, c_loc, n_blocks, out):
        L = x.shape[-1]
        flat = (x.reshape(c_loc * n_blocks, L) if intype == "i16"
                else x.reshape(2, c_loc * n_blocks, L))
        return mixer.mix_blocks_fmt(flat, p.reshape(7, -1), intype=intype,
                                    outtype=out)

    def stage(data, plans, dev, cs, lo, hi):
        x = data[cs, lo:hi] if intype == "i16" else data[:, cs, lo:hi]
        return _to(x, dev), _plans(plans, lo, hi, dev, cs)

    if resampler is None:
        def step(data, plans):
            C, B = plans.shape[1], plans.shape[2]
            L = data.shape[-1]
            shape = (C, B, L) if outtype == "i16" else (2, C, B, L)
            result = torch.empty(shape, dtype=(
                torch.int32 if outtype == "i16" else torch.float32), device=dev0)
            for dev, cs, bs in shard_slices(mesh, C, B):
                c_loc = cs.stop - cs.start
                with _on(dev):
                    x, p = stage(data, plans, dev, cs, bs.start, bs.stop)
                    out = mix(x, p, c_loc, bs.stop - bs.start, outtype)
                if outtype == "i16":
                    result[cs, bs] = out.reshape(c_loc, -1, L).to(dev0)
                else:
                    result[:, cs, bs] = out.reshape(2, c_loc, -1, L).to(dev0)
            return result
        return step

    rs = resampler
    H = rs.T - 1
    bank_rev = _PerDevice(lambda dev: torch.from_numpy(
        rs.bank[:, ::-1].copy()).to(dev))

    def step(data, plans):
        C, B = plans.shape[1], plans.shape[2]
        L = data.shape[-1]
        n_loc = B * L // n_time
        if n_loc * rs.P >= (1 << 30):
            raise ValueError("shard too large for 32-bit phase arithmetic")
        M_max = n_loc * rs.P // rs.Q + 2
        rem, off, _ = shard_alignment(0, n_loc, n_time, rs.P, rs.Q)
        r_h = -(-H // L)
        shape = (C, n_time, M_max) if outtype == "i16" else (2, C, n_time, M_max)
        result = torch.empty(shape, dtype=(
            torch.int32 if outtype == "i16" else torch.float32), device=dev0)
        for dev, cs, bs in shard_slices(mesh, C, B):
            t = bs.start // (bs.stop - bs.start)
            r = 0 if t == 0 else r_h
            c_loc = cs.stop - cs.start
            with _on(dev):
                x, p = stage(data, plans, dev, cs, bs.start - r, bs.stop)
                planes = mix(x, p, c_loc, bs.stop - bs.start + r,
                             "f32").reshape(2, c_loc, -1)
                if r:
                    xi, xq = planes[0, :, r * L - H:], planes[1, :, r * L - H:]
                else:
                    zeros = torch.zeros((c_loc, H), dtype=torch.float32,
                                        device=dev)
                    xi = torch.cat([zeros, planes[0]], dim=-1)
                    xq = torch.cat([zeros, planes[1]], dim=-1)
                yi, yq = window_resample(xi, xq, bank_rev.get(dev),
                                         int(rem[t]), int(off[t]), P=rs.P,
                                         Q=rs.Q, T=rs.T, M=M_max)
                out = codec.encode(yi, yq, outtype)
            if outtype == "i16":
                result[cs, t] = out.to(dev0)
            else:
                result[:, cs, t] = out.to(dev0)
        return result
    return step


# -- the streaming steps the pipelines run (--mesh) -------------------------------

def make_wideband_mix_step(mesh, *, intype: str, outtype: str, C: int):
    """Sharded mix-only step over a shared wideband chunk.

    ``step(data, plans)``: ``data`` is the raw chunk, int32 ``(B, L)`` or
    float32 ``(2, B, L)``, time-sharded and read by every channel shard;
    ``plans`` are ``(7, B)`` for one stream (``C = 1``: the stream mixer)
    or ``(7, C, B)`` (the channel mixer on each shard's channels).  Returns
    one ``(channel slice, block slice, out)`` a shard, ``out`` on the
    shard's device in the mixer's ``outtype`` layout.
    """
    _check_channels(mesh, C)

    def step(data, plans):
        parts = []
        for dev, cs, bs in shard_slices(mesh, C, plans.shape[-1]):
            with _on(dev):
                x = _blocks(data, bs.start, bs.stop, dev)
                if plans.dim() == 2:
                    out = mixer.mix_blocks_fmt(
                        x, _plans(plans, bs.start, bs.stop, dev),
                        intype=intype, outtype=outtype)
                else:
                    out = mixer.mix_blocks_fmt_channels(
                        x, _plans(plans, bs.start, bs.stop, dev, cs),
                        intype=intype, outtype=outtype)
            parts.append((cs, bs, out))
        return parts
    return step


def make_wideband_stream_step(mesh, *, intype: str, outtype: str, C: int,
                              resampler):
    """Sharded streaming mix + resampler — the route of a single-stage
    resampler the chain gate refuses (and of every single-stage channel
    group under a mesh, and of ``impl='xla'``, as in the JAX package).

    ``step(data, plans, hist_i, hist_q, rem, off, counts)``:

    - ``data``           : the raw chunk, int32 ``(B, L)`` / float32
                           ``(2, B, L)``;
    - ``plans``          : ``(7, B)`` with ``C = 1``, else ``(7, C, B)``;
    - ``hist_i/hist_q``  : the ``(T−1,)`` — or ``(C, T−1)`` — mixed history
                           entering the chunk;
    - ``rem/off/counts`` : :func:`stream_step_alignment` of the chunk
                           (``start0``/``p0`` in place of ``rem``/``off``
                           for a ``'conv'`` resampler).

    Each shard mixes its blocks in one mixer launch (float32 planes), with
    the ⌈(T−1)/L⌉ blocks before them when it is not shard 0: their last
    T−1 mixed samples are its left halo, bitwise the unsharded run's
    because the mixer is pure per block.  Shard 0 takes the history.  The
    resample is the unsharded resampler's own function,
    ``ops.resample.window_resample`` or ``resample_conv_stream`` (a shard's
    buffer is the [T−1 history | n_loc inputs] of a streaming chunk).  Returns ``(parts, tail_i, tail_q)``: one ``(channel slice,
    block slice, out)`` a shard with ``out`` its ``counts[t]`` encoded
    outputs (int32 words or float32 planes ``(2, …)``), and the last
    shard's T−1 mixed samples — the next chunk's history — on the mesh's
    first device.
    """
    _check_channels(mesh, C)
    rs = resampler
    H = rs.T - 1
    dev0 = mesh.device()
    conv = rs.impl == "conv"
    if conv:
        taps_mat = _PerDevice(lambda dev: rs._taps_mat.to(dev))
    else:
        bank_rev = _PerDevice(lambda dev: torch.from_numpy(
            rs.bank[:, ::-1].copy()).to(dev))

    def step(data, plans, hist_i, hist_q, rem, off, counts):
        B, L = plans.shape[-1], data.shape[-1]
        n_time = len(counts)
        r_h = -(-H // L)
        channels = plans.dim() == 3
        parts, tails = [], []
        for dev, cs, bs in shard_slices(mesh, C, B):
            t = bs.start // (bs.stop - bs.start)
            r = 0 if t == 0 else r_h
            rows = cs if channels else slice(None)
            with _on(dev):
                x = _blocks(data, bs.start - r, bs.stop, dev)
                if channels:
                    mixed = mixer.mix_blocks_fmt_channels(
                        x, _plans(plans, bs.start - r, bs.stop, dev, cs),
                        intype=intype, outtype="f32")
                    planes = mixed.reshape(2, cs.stop - cs.start, -1)
                else:
                    mixed = mixer.mix_blocks_fmt(
                        x, _plans(plans, bs.start - r, bs.stop, dev),
                        intype=intype, outtype="f32")
                    planes = mixed.reshape(2, -1)
                if r:
                    xi = planes[0][..., r * L - H:]
                    xq = planes[1][..., r * L - H:]
                else:
                    xi = torch.cat([hist_i[rows].to(dev), planes[0]], dim=-1)
                    xq = torch.cat([hist_q[rows].to(dev), planes[1]], dim=-1)
                M = int(counts[t])
                if conv:
                    _, _, K, PADZ, TAIL = conv_stream_geometry(
                        0, 0, M, xi.shape[-1] - H, P=rs.P, Q=rs.Q, T=rs.T)
                    yi, yq = resample_conv_stream(
                        xi, xq, taps_mat.get(dev), int(rem[t]), int(off[t]),
                        P=rs.P, Q=rs.Q, T=rs.T, K=K, M=M, PADZ=PADZ, TAIL=TAIL)
                else:
                    yi, yq = window_resample(xi, xq, bank_rev.get(dev),
                                             int(rem[t]), int(off[t]), P=rs.P,
                                             Q=rs.Q, T=rs.T, M=M)
                parts.append((cs, bs, codec.encode(yi, yq, outtype)))
            if t == n_time - 1:
                n = planes.shape[-1]
                tails.append((planes[0][..., n - H:].to(dev0),
                              planes[1][..., n - H:].to(dev0)))
        tail_i, tail_q = (torch.cat(side, dim=0) if channels else side[0]
                          for side in zip(*tails))
        return parts, tail_i, tail_q
    return step


def make_chain_stream_step(mesh, *, resampler, intype: str = "i16",
                           outtype: str = "i16"):
    """Sharded fused-chain step (``csrc/chain.cu`` per shard).

    The chain's only sequential state is the T−1-sample mixed carry.  Shard
    k > 0 rebuilds the carry it enters with from its left neighbour's last
    raw block and that block's 7 plan words: a 1-block call of the same
    chain kernel from a zero carry, whose output is dropped and whose carry
    is the block's mixed tail — bitwise the unsharded run's carry there
    (the seek does the same, ``Pipeline.seek_to_block``).  Shard 0 takes
    the streamed carry.  One extra block a shard a chunk.  The dot is the
    exact one: mesh paths keep the exact formulation, as in JAX.

    ``step(data, plans, carry)``: the raw chunk (int32 ``(B, L)`` / float32
    ``(2, B, L)``), ``(7, B)`` plan words and the ``(2, T−1)`` carry
    entering the chunk.  Returns ``(outs, carry)``: each shard's
    ``(b_loc, L·P/Q)`` words or ``(2, b_loc, L·P/Q)`` planes in stream
    order, and the last shard's carry on the mesh's first device.
    """
    if mesh.shape["channel"] != 1:
        raise ValueError("the chain step runs one stream: mesh channel=1")
    rs = resampler
    banks = _banks([rs])
    dev0 = mesh.device()
    kw = dict(P=rs.P, Q=rs.Q, T=rs.T, intype=intype, outtype=outtype)

    def step(data, plans, carry):
        outs = []
        for dev, _, bs in shard_slices(mesh, 1, plans.shape[-1]):
            r = 0 if bs.start == 0 else 1
            with _on(dev):
                replay, own = _split(_blocks(data, bs.start - r, bs.stop, dev), r)
                p = _plans(plans, bs.start - r, bs.stop, dev)
                (bank,) = banks.get(dev)
                if r:
                    zero = torch.zeros((2, rs.T - 1), dtype=torch.float32,
                                       device=dev)
                    _, carry = chain.mix_resample_chain_stream(
                        replay, p[:, :r], bank, zero, **kw)
                else:
                    carry = carry.to(dev, non_blocking=True)
                out, carry = chain.mix_resample_chain_stream(
                    own, p[:, r:], bank, carry, **kw)
            outs.append(out)
        return outs, carry.to(dev0)
    return step


def make_cascade_stream_step(mesh, *, resampler, fused: int,
                             intype: str = "i16", outtype: str = "i16",
                             final_dense: bool = False):
    """Sharded fused-cascade step (``csrc/cascade.cu`` per shard) over the
    first ``fused`` stages of a ``MultiStageResampler``.

    The chain step's replay with per-stage carries: shard k > 0 replays the
    ``r_h`` raw blocks before it (:func:`cascade_shard_replay`: the
    zero-history corrupt head plus the deepest stage's carry cone, widened
    until the stages take that many blocks) through the same kernel from
    zero carries and keeps every stage's carry.  ``final_dense`` is the
    split cascade's ÷2^k front (float32 planes out); the caller runs the
    tail stages once, over the gathered planes.

    ``step(data, plans, carries)`` → ``(outs, carries)``: each shard's
    output in stream order, and the last shard's per-stage ``(2, T−1)``
    carries on the mesh's first device.
    """
    if mesh.shape["channel"] != 1:
        raise ValueError("the cascade step runs one stream: mesh channel=1")
    stages_f = resampler.stages[:fused]
    banks = _banks(stages_f)
    dev0 = mesh.device()
    kw = dict(stages=tuple((st.P, st.Q, st.T) for st in stages_f),
              intype=intype, outtype=outtype, final_dense=final_dense)

    def step(data, plans, carries):
        B, L = plans.shape[-1], data.shape[-1]
        r_h = cascade_shard_replay(resampler, fused, L, B // mesh.shape["time"])
        if r_h is None:
            raise ValueError(f"the cascade's {fused} fused stages cannot run "
                             f"shards of {B} blocks over {mesh.shape}")
        outs = []
        for dev, _, bs in shard_slices(mesh, 1, B):
            r = 0 if bs.start == 0 else r_h
            with _on(dev):
                replay, own = _split(_blocks(data, bs.start - r, bs.stop, dev), r)
                p = _plans(plans, bs.start - r, bs.stop, dev)
                bank = banks.get(dev)
                if r:
                    zeros = tuple(torch.zeros((2, st.T - 1), dtype=torch.float32,
                                              device=dev) for st in stages_f)
                    _, carries = cascade.mix_cascade_stream(
                        replay, p[:, :r], bank, zeros, **kw)
                else:
                    carries = tuple(c.to(dev, non_blocking=True) for c in carries)
                out, carries = cascade.mix_cascade_stream(
                    own, p[:, r:], bank, carries, **kw)
            outs.append(out)
        return outs, tuple(c.to(dev0) for c in carries)
    return step


def make_cascade_channels_step(mesh, *, resampler, fused: int, C: int,
                               intype: str = "i16", outtype: str = "i16",
                               final_dense: bool = False):
    """Sharded channel-batched fused-cascade step (``csrc/cascade.cu``'s
    channel axis per shard) — BASELINE config 5's topology: channels ×
    time × cascade.

    The raw chunk is time-sharded and read by every channel shard; plans
    ``(7, C, B)`` and per-stage carries ``(C, 2, T−1)`` shard over
    ``channel``.  Each time shard k > 0 rebuilds its channels' carries with
    :func:`make_cascade_stream_step`'s replay, through a channel-batched
    call of the same kernel.  ``step(data, plans, carries)`` →
    ``(parts, carries)``: one ``(channel slice, block slice, out)`` a
    shard, and the per-stage ``(C, 2, T−1)`` carries of the last time
    shard on the mesh's first device.
    """
    _check_channels(mesh, C)
    stages_f = resampler.stages[:fused]
    banks = _banks(stages_f)
    dev0 = mesh.device()
    n_time = mesh.shape["time"]
    kw = dict(stages=tuple((st.P, st.Q, st.T) for st in stages_f),
              intype=intype, outtype=outtype, final_dense=final_dense)

    def step(data, plans, carries):
        B, L = plans.shape[-1], data.shape[-1]
        r_h = cascade_shard_replay(resampler, fused, L, B // n_time)
        if r_h is None:
            raise ValueError(f"the cascade's {fused} fused stages cannot run "
                             f"shards of {B} blocks over {mesh.shape}")
        parts, last = [], []
        for dev, cs, bs in shard_slices(mesh, C, B):
            r = 0 if bs.start == 0 else r_h
            with _on(dev):
                replay, own = _split(_blocks(data, bs.start - r, bs.stop, dev), r)
                p = _plans(plans, bs.start - r, bs.stop, dev, cs)
                bank = banks.get(dev)
                if r:
                    zeros = tuple(torch.zeros((cs.stop - cs.start, 2, st.T - 1),
                                              dtype=torch.float32, device=dev)
                                  for st in stages_f)
                    _, c_in = cascade.mix_cascade_channels(
                        replay, p[..., :r], bank, zeros, **kw)
                else:
                    c_in = tuple(c[cs].to(dev, non_blocking=True) for c in carries)
                out, c_out = cascade.mix_cascade_channels(
                    own, p[..., r:], bank, c_in, **kw)
            parts.append((cs, bs, out))
            if bs.stop == B:
                last.append(tuple(c.to(dev0) for c in c_out))
        return parts, tuple(torch.cat(per_stage) for per_stage in zip(*last))
    return step
