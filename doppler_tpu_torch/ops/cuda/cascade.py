"""Fused cascade: decode → NCO mix → S FIR stages → encode, streaming.

:func:`mix_cascade_stream` launches ``csrc/cascade.cu`` on a CUDA tensor
(the port of ``doppler_tpu/ops/pallas/chain.py:960``
``mix_cascade_pallas_stream``) and runs :func:`mix_cascade_plain` on a CPU
tensor.  :func:`mix_cascade_channels` is the same kernel with a channel axis
(the port of ``chain.py:1078`` ``mix_cascade_pallas_channels``): C channels
over one shared chunk, each with its own plan words ``plans[:, c]`` and
per-stage carries ``carries[s][c]``, in one launch; channel c's result is
bitwise the stream call's.

``stages`` is the tuple of per-stage ``(P, Q, T)`` of the fused stages of a
``MultiStageResampler``; ``banks`` their ``(P, T)`` polyphase banks and
``carries`` their flat ``(2, T−1)`` float32 histories — exactly each
stage's ``_hist_i/_hist_q``, not the TPU's 128-lane carry rows.  Every
stage's chunk input count must be a multiple of its Q, so each stage's
chunk-local output grid is its absolute grid when the stream starts on it.
Channel layouts: plan words int32 ``(7, C, B)``, per-stage carries
``(C, 2, T−1)``, output int32 ``(C, B, M)`` or float32 ``(2, C, B, M)``.

``dot_precision`` of the stream call: ``"highest"`` (float32 dots, the
kernel above) or the two other functions of the same TPU kernel
(``chain.py:819-820``, every stage through ``_acc_slices``): ``"split3"``,
``x_h·t_h + x_h·t_l + x_l·t_h`` over bf16-exact halves, and ``"default"``,
``x_h·t_h`` alone, each stage's input being the float32 sum of the stage
before, split again.  A CUDA tensor launches ``csrc/cascade_fast.cu``, a
bf16 tensor-core kernel, counted in ``.launches_fast`` (the one-pass
launches also in ``.launches_default``); a CPU tensor runs the plain
version with ``window_dot(dot=dot_precision)``.  Both take a chunk only
where every stage's window count (chunk input count / Q) is a multiple of
16 (``geometry.check_cascade_fast_chunk``).  The kernel's stage s holds
D_s neighbouring windows a row of its dot (``geometry.
cascade_fast_columns``: the largest power of two with D_s·P_s ≤ 8 and
16·D_s·Q_s dividing the stage's input count a block, else 1; 8 and 2 at
config 3) and starts its tiles at multiples of 16·D_s windows; a block
then holds whole tiles wherever D_s > 1, so the rule of 16 windows a chunk
is all a chunk must meet.  Each stage's B fragments are laid out once per
bank (``chain.fast_taps``).  The stage-0 carry is the mixed history,
bitwise the exact path's; a later stage's carry holds that function's own
x_s.  The channel-batched cascade has no ``dot_precision``, as in JAX
(``chain.py:1078``).

:func:`split_point` is the JAX package's rule for how many leading stages
fuse; a split cascade runs the ÷2^k front here with ``final_dense=True``
(float32 planes out) and the remaining stages through their own
``RationalResampler.process``.
"""

from __future__ import annotations

import ctypes

import torch

from doppler_tpu_torch.ops import codec
from doppler_tpu_torch.ops.cuda import build, geometry
from doppler_tpu_torch.ops.cuda.chain import fast_taps
from doppler_tpu_torch.ops.cuda.mixer import (
    check_fmt,
    check_fmt_channels,
    mix_blocks_fmt_plain,
    stack_channels,
)
from doppler_tpu_torch.ops.precision import PASSES, check_precision
from doppler_tpu_torch.ops.resample import window_dot

__all__ = ["mix_cascade_stream", "mix_cascade_plain", "mix_cascade_channels",
           "mix_cascade_channels_plain", "split_point", "chunk_out_count"]

_MAX_STAGES = geometry.MAX_STAGES    # the kernel's per-stage argument slots


def split_point(stages) -> int:
    """How many leading stages fuse (``doppler_tpu/ops/pallas/chain.py:876``).

    ``len(stages)`` when every stage has ``128 % Q == 0``; else the count of
    leading stages with ``128 % Q == 0`` and integer decimation
    ``Q % P == 0``.  On the TPU 128 is the lane width; here it marks the
    stages whose chunk-local output grid stays aligned from chunk to chunk.
    """
    n = len(stages)
    if all(128 % st.Q == 0 for st in stages):
        return n
    k = 0
    while (k < n and 128 % stages[k].Q == 0
           and stages[k].Q % stages[k].P == 0):
        k += 1
    return k


def chunk_out_count(stages, B: int, L: int) -> int | None:
    """Output count of the fused ``stages`` (``(P, Q, T)`` each) for a
    ``(B, L)`` chunk, or None when the kernel does not take them: it takes 1
    to 4 stages, each stage's chunk input count a multiple of its Q, and an
    output that is a whole count per block."""
    if not 1 <= len(stages) <= _MAX_STAGES:
        return None
    n = B * L
    for P, Q, _ in stages:
        if n % Q:
            return None
        n = n // Q * P
    return n if n % B == 0 else None


def _check(data, plans, banks, carries, stages, intype, outtype, final_dense,
           channels: bool = False, dot_precision: str = "highest"):
    """Validate one call; returns (C, B, L, stages, n_out) with C = None for
    a single stream (``(7, B)`` plans, ``(2, T−1)`` carries)."""
    check_precision(dot_precision)
    if channels:
        C, B, L = check_fmt_channels(data, plans, intype, outtype)
        lead = (C,)
    else:
        B, L = check_fmt(data, plans, intype, outtype)
        C, lead = None, ()
    stages = tuple(tuple(int(v) for v in st) for st in stages)
    n_out = chunk_out_count(stages, B, L)
    if n_out is None:
        raise ValueError(
            f"cascade {stages} does not fit a chunk of {B}×{L} samples: the "
            f"kernel takes 1 to {_MAX_STAGES} stages, each stage's chunk "
            "input count a multiple of its Q, and a whole output count per "
            "block")
    if len(banks) != len(stages) or len(carries) != len(stages):
        raise ValueError("one bank and one carry per stage")
    if final_dense and (outtype != "f32"
                        or any(Q % P for P, Q, _ in stages)):
        raise ValueError("final_dense is the split front: integer-decimation "
                         "stages with float32 planes out")
    for (P, Q, T), bank, carry in zip(stages, banks, carries):
        if bank.dtype != torch.float32 or tuple(bank.shape) != (P, T):
            raise ValueError(f"bank must be float32 ({P}, {T}), got "
                             f"{bank.dtype} {tuple(bank.shape)}")
        if carry.dtype != torch.float32 or tuple(carry.shape) != lead + (2, T - 1):
            raise ValueError(f"carry must be float32 {lead + (2, T - 1)}, got "
                             f"{carry.dtype} {tuple(carry.shape)}")
        if bank.device != data.device or carry.device != data.device:
            raise ValueError("banks, carries and data must be on one device")
    if dot_precision in PASSES:
        geometry.check_cascade_fast_chunk(stages, B, L)
    return C, B, L, stages, n_out


def _encode(yi, yq, outtype, B):
    if outtype == "i16":
        return codec.iq_to_i16_words(yi, yq).reshape(B, -1)
    return torch.stack([yi, yq]).reshape(2, B, -1)


def mix_cascade_plain(data, plans, banks, carries, *, stages,
                      intype: str = "i16", outtype: str = "i16",
                      final_dense: bool = False,
                      dot_precision: str = "highest"):
    """Plain torch version: the mixer's plain version, then
    ``ops.resample.window_dot(dot=dot_precision)`` per stage over
    ``[carry_s | x_s]``, then encode.  Returns ``(out, carries_out)``.

    ``default`` is held to one bf16 pass of the split operands, ``x_h·t_h``
    with float32 sums, which is what a DEFAULT dot is on the TPU; the JAX
    function run on the CPU (interpret mode) computes a DEFAULT dot in
    float32 and is no reference for it."""
    _, B, L, stages, _ = _check(data, plans, banks, carries, stages, intype,
                                outtype, final_dense,
                                dot_precision=dot_precision)
    x = mix_blocks_fmt_plain(data, plans, intype=intype,
                             outtype="f32").reshape(2, B * L)
    carries_out = []
    for (P, Q, T), bank, carry in zip(stages, banks, carries):
        buf = torch.cat([carry, x], dim=1)
        carries_out.append(buf[:, buf.shape[1] - (T - 1):].clone())
        yi, yq = window_dot(buf[0], buf[1], bank.flip(-1), 0, 0, P=P, Q=Q,
                            T=T, M=x.shape[1] // Q * P, dot=dot_precision)
        x = torch.stack([yi, yq])
    return _encode(x[0], x[1], outtype, B), tuple(carries_out)


def mix_cascade_channels_plain(data, plans, banks, carries, *, stages,
                               intype: str = "i16", outtype: str = "i16",
                               final_dense: bool = False):
    """Plain torch version of the channel-batched cascade: the stream plain
    version once per channel with ``plans[:, c]`` and each stage's
    ``carries[s][c]``, stacked.  Returns ``(out, carries_out)``."""
    C, _, _, stages, _ = _check(data, plans, banks, carries, stages, intype,
                                outtype, final_dense, channels=True)
    outs, tails = zip(*(
        mix_cascade_plain(data, plans[:, c], banks, [cr[c] for cr in carries],
                          stages=stages, intype=intype, outtype=outtype,
                          final_dense=final_dense)
        for c in range(C)))
    return (stack_channels(outs, outtype),
            tuple(torch.stack(per_stage) for per_stage in zip(*tails)))


def plan_launch(dev: torch.device, stages, geom=None) -> geometry.Layout:
    """The launch's tile, threads, register tiles and shared-memory layout:
    :func:`geometry.pick_cascade` for the card, or ``geom`` =
    ``(tile, threads, (R per stage))`` as given (the card tests walk
    several)."""
    limit = build.shared_memory_limit(dev.index)
    if geom is None:
        return geometry.pick_cascade(tuple(stages), limit)
    tile, threads, regs = geom
    lay = geometry.layout(stages, tile, threads, regs)
    if lay.smem_bytes > limit:
        raise ValueError(
            f"cascade stages (P, Q, T) = {stages} with tile {tile} need "
            f"{lay.smem_bytes} bytes of shared memory per CTA; the card "
            f"allows {limit}")
    return lay


def _launch(data, plans, banks, carries, C, B, L, stages, n_out, intype,
            outtype, geom=None):
    """Launch the kernel over ``(7, C, B)`` plan words and per-stage
    ``(C, 2, T−1)`` carries; returns ``(C, B, M)`` words or ``(2, C, B, M)``
    planes and the per-stage ``(C, 2, T−1)`` carries.  ``geom`` as in
    :func:`plan_launch`."""
    dev = data.device
    S = len(stages)
    lay = plan_launch(dev, stages, geom)
    data, plans = data.contiguous(), plans.contiguous()
    banks = [b.contiguous() for b in banks]
    carries = [c.contiguous() for c in carries]
    if outtype == "i16":
        out = torch.empty((C, B, n_out // B), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((2, C, B, n_out // B), dtype=torch.float32, device=dev)
    carries_out = tuple(
        torch.empty((C, 2, T - 1), dtype=torch.float32, device=dev)
        for _, _, T in stages)
    ptrs = lambda ts: (ctypes.c_void_p * S)(*(t.data_ptr() for t in ts))  # noqa: E731
    rc = build.load().doppler_cascade(
        data.data_ptr(), out.data_ptr(), plans.data_ptr(), ptrs(banks),
        ptrs(carries), ptrs(carries_out),
        (ctypes.c_int * (7 * S))(*(v for row in lay.rows for v in row)), S, C,
        B, L, lay.tile, lay.threads, lay.smem_bytes, int(intype == "f32"),
        int(outtype == "f32"), torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "cascade")
    return out, carries_out


def plan_launch_fast(dev: torch.device, stages, L: int, passes: int,
                     geom=None, windows: int | None = None
                     ) -> geometry.CascadeFastLayout:
    """The fast kernel's windows a tile CTA, threads and shared-memory
    layout for ``passes`` bf16 passes over blocks of L samples:
    :func:`geometry.pick_cascade_fast` for the card (a chunk of ``windows``
    last-stage windows gets at most a third of them an SM a tile), or
    ``geom`` = ``(windows, threads)`` as given (the card tests and the
    sweep walk several; a third entry, the slab, optional)."""
    limit = build.shared_memory_limit(dev.index)
    if geom is None:
        cap = None if windows is None else windows // (3 * build.sm_count(dev.index))
        return geometry.pick_cascade_fast(tuple(stages), L, limit, passes, cap)
    lay = geometry.cascade_fast_layout(stages, L, *geom[:2], passes, *geom[2:])
    if lay.smem_bytes > limit:
        raise ValueError(
            f"fast cascade stages (P, Q, T) = {stages} with {geom[0]} windows "
            f"need {lay.smem_bytes} bytes of shared memory per CTA; the card "
            f"allows {limit}")
    return lay


def _fast_args(data, plans, banks, carries, B, L, stages, n_out, outtype,
               passes, geom):
    """What both fast entry points take: the layout, the inputs made
    contiguous, each stage's B fragments (laid out once per bank,
    :func:`chain.fast_taps`), the outputs, and the pointer arrays."""
    dev = data.device
    S = len(stages)
    lay = plan_launch_fast(dev, stages, L, passes, geom, n_out // stages[-1][0])
    data, plans = data.contiguous(), plans.contiguous()
    taps = [fast_taps(bank, P, Q, T, D, passes)
            for bank, (P, Q, T), D in zip(banks, stages, lay.columns)]
    carries = [c.contiguous() for c in carries]
    if outtype == "i16":
        out = torch.empty((n_out,), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((2, n_out), dtype=torch.float32, device=dev)
    carries_out = tuple(torch.empty((2, T - 1), dtype=torch.float32, device=dev)
                        for _, _, T in stages)
    ptrs = lambda ts: (ctypes.c_void_p * S)(*(t.data_ptr() for t in ts))  # noqa: E731
    args = (data.data_ptr(), out.data_ptr(), plans.data_ptr(), ptrs(taps),
            ptrs(carries), ptrs(carries_out),
            (ctypes.c_int * (7 * S))(*(v for row in lay.rows for v in row)), S, B,
            L, lay.windows, lay.slab, lay.threads, lay.smem_bytes)
    # the tensors stay referenced until the launch is enqueued
    return lay, args, out, carries_out, (data, plans, taps, carries)


def _launch_fast(data, plans, banks, carries, B, L, stages, n_out, intype,
                 outtype, passes, geom=None):
    """Launch ``csrc/cascade_fast.cu`` with ``passes`` bf16 passes (3:
    split3, 1: default) over ``(7, B)`` plan words and per-stage ``(2, T−1)``
    carries; returns ``(n_out,)`` words or ``(2, n_out)`` planes and the
    per-stage carries.  ``geom`` as in :func:`plan_launch_fast`."""
    dev = data.device
    _, args, out, carries_out, _keep = _fast_args(
        data, plans, banks, carries, B, L, stages, n_out, outtype, passes, geom)
    rc = build.load().doppler_cascade_fast(
        *args, int(intype == "f32"), int(outtype == "f32"), passes,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "fast cascade")
    return out, carries_out


def launch_fast_part(data, plans, banks, carries, *, stages, part: str,
                     outtype: str = "i16"):
    """One half of the split3 cascade alone, for timing (``chip_smoke.py``):
    ``part="mix"`` cuts the dots (each warp XORs x_0's span into a side
    word, which keeps the mix alive), ``part="dot"`` cuts the mix (x_0's
    span holds zeros).  i16 words ``(B, L)`` in, one stream; returns
    ``(out, side)``.  Not a function of the pipeline: no plain version, no
    launch count."""
    dev = data.device
    _, B, L, stages, n_out = _check(data, plans, banks, carries, stages, "i16",
                                    outtype, False, dot_precision="split3")
    lay, args, out, _, _keep = _fast_args(data, plans, banks, carries, B, L,
                                          stages, n_out, outtype, 3, None)
    n_ctas = len(geometry.fast_cta_units(stages, B * L, lay.windows))
    side = torch.zeros(n_ctas * lay.threads // 32, dtype=torch.int32, device=dev)
    rc = build.load().doppler_cascade_fast_part(
        *args, int(outtype == "f32"), {"mix": 1, "dot": 2}[part], side.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, f"fast cascade ({part} only)")
    return out, side


def mix_cascade_stream(data, plans, banks, carries, *, stages,
                       intype: str = "i16", outtype: str = "i16",
                       final_dense: bool = False,
                       dot_precision: str = "highest"):
    """Streaming fused mix + cascade, all four wire formats.

    ``data``: int32 words ``(B, L)`` or float32 planes ``(2, B, L)``;
    ``plans``: ``(7, B)`` plan words; ``banks``/``carries``: one ``(P, T)``
    bank and one ``(2, T−1)`` float32 carry per stage of ``stages``.
    Returns ``(out, carries_out)`` with ``out`` int32 ``(B, M)`` or float32
    ``(2, B, M)``, ``M = L·∏P/∏Q``.  ``final_dense=True`` marks the split
    cascade's ÷2^k front (float32 planes out).  ``dot_precision``:
    ``"highest"``, ``"split3"`` or ``"default"`` (the module docstring).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    of ``dot_precision`` (one channel) or raises.
    """
    if data.device.type == "cpu":
        return mix_cascade_plain(data, plans, banks, carries, stages=stages,
                                 intype=intype, outtype=outtype,
                                 final_dense=final_dense,
                                 dot_precision=dot_precision)
    if data.device.type != "cuda":
        raise ValueError(f"no cascade kernel for device {data.device}")
    _, B, L, stages, n_out = _check(data, plans, banks, carries, stages,
                                    intype, outtype, final_dense,
                                    dot_precision=dot_precision)
    M = n_out // B
    if dot_precision in PASSES:
        out, carries_out = _launch_fast(data, plans, banks, carries, B, L,
                                        stages, n_out, intype, outtype,
                                        PASSES[dot_precision])
        mix_cascade_stream.launches_fast += 1
        if dot_precision == "default":
            mix_cascade_stream.launches_default += 1
        return (out.reshape((B, M) if outtype == "i16" else (2, B, M)),
                carries_out)
    out, carries_out = _launch(data, plans, banks, carries, 1, B, L, stages,
                               n_out, intype, outtype)
    mix_cascade_stream.launches += 1
    return (out.reshape((B, M) if outtype == "i16" else (2, B, M)),
            tuple(c[0] for c in carries_out))


def mix_cascade_channels(data, plans, banks, carries, *, stages,
                         intype: str = "i16", outtype: str = "i16",
                         final_dense: bool = False):
    """Channel-batched fused mix + cascade: one launch for all channels.

    ``data``: the shared chunk, int32 words ``(B, L)`` or float32 planes
    ``(2, B, L)``; ``plans``: ``(7, C, B)`` plan words; ``banks``: one
    ``(P, T)`` bank per stage; ``carries``: one ``(C, 2, T−1)`` float32 per
    stage.  Returns ``(out, carries_out)`` with ``out`` int32 ``(C, B, M)``
    or float32 ``(2, C, B, M)``.  Channel c is bitwise
    :func:`mix_cascade_stream` with ``plans[:, c]`` and ``carries[s][c]``;
    ``final_dense`` as there.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if data.device.type == "cpu":
        return mix_cascade_channels_plain(
            data, plans, banks, carries, stages=stages, intype=intype,
            outtype=outtype, final_dense=final_dense)
    if data.device.type != "cuda":
        raise ValueError(f"no cascade kernel for device {data.device}")
    C, B, L, stages, n_out = _check(data, plans, banks, carries, stages,
                                    intype, outtype, final_dense, channels=True)
    out, carries_out = _launch(data, plans, banks, carries, C, B, L, stages,
                               n_out, intype, outtype)
    mix_cascade_channels.launches += 1
    return out, carries_out


# kernel launches (CUDA path only): csrc/cascade.cu, csrc/cascade_fast.cu
# (both pass counts), and of those the one-pass ('default') launches
mix_cascade_stream.launches = 0
mix_cascade_stream.launches_fast = 0
mix_cascade_stream.launches_default = 0
mix_cascade_channels.launches = 0
