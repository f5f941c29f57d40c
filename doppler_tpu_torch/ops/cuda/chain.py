"""Fused chain: decode → NCO mix → P/Q polyphase FIR → encode, streaming.

:func:`mix_resample_chain_stream` launches ``csrc/chain.cu`` on a CUDA
tensor (the port of ``doppler_tpu/ops/pallas/chain.py:404``
``mix_resample_chain_pallas_stream``) and runs
:func:`mix_resample_chain_plain` on a CPU tensor.
:func:`mix_resample_chain_channels` is the same kernel with a channel axis
(the port of ``chain.py:556`` ``mix_resample_chain_pallas_channels``): C
channels over one shared chunk, each with its own plan words
``plans[:, c]`` and carry ``carries[c]``, in one launch; channel c's result
is bitwise the stream call's.

``dot_precision="split3"`` (``--precision fast``) is the other function of
the same TPU kernel (``chain.py:191-221``, ``_acc_slices``): the FIR dot
over bf16-exact halves, ``x_h·t_h + x_h·t_l + x_l·t_h`` (``ops.precision``);
``dot_precision="default"`` its third (``chain.py:222-237``), the TPU's one
bf16 pass of a DEFAULT-precision dot, ``x_h·t_h`` alone.  A CUDA tensor
launches ``csrc/chain_fast.cu``, a bf16 tensor-core kernel (three passes or
one), and counts it in ``.launches_fast`` (the one-pass launches also in
``.launches_default``); a CPU tensor runs the plain version with
``window_dot(dot=dot_precision)``.  The carry is the mixed history either
way, bitwise the exact path's.  The kernel's D windows a row
(``geometry.fast_columns``) follow from the stage and the block length L,
so that every chunk of whole blocks holds a multiple of 16·D windows: its
tiles then fall on the stream's own grid, and its bytes do not depend on
the chunk cut.

The carry is the flat ``(2, T−1)`` float32 history — the last T−1 mixed
samples, exactly ``RationalResampler._hist_i/_hist_q`` — not the TPU's
128-lane row layout.  Output m of block b has chunk-local index
``b·L·P/Q + m``; with a chunk starting at an absolute input index that is a
multiple of Q, that is the resampler's absolute output grid.  Channel
layouts: plan words int32 ``(7, C, B)``, carries ``(C, 2, T−1)`` (the
batched resampler's ``_hist_i/_hist_q`` stacked), output int32 ``(C, B, M)``
or float32 ``(2, C, B, M)``.
"""

from __future__ import annotations

import torch

from doppler_tpu_torch.ops import codec
from doppler_tpu_torch.ops.cuda import build, geometry
from doppler_tpu_torch.ops.cuda.mixer import (
    check_fmt,
    check_fmt_channels,
    mix_blocks_fmt_plain,
    stack_channels,
)
from doppler_tpu_torch.ops.precision import PASSES, bank_halves, check_precision
from doppler_tpu_torch.ops.resample import window_dot

__all__ = ["mix_resample_chain_stream", "mix_resample_chain_plain",
           "mix_resample_chain_channels", "mix_resample_chain_channels_plain"]


def _check_rest(data, bank, carry, carry_shape, L, P, Q, T):
    if L % Q:
        raise ValueError(f"block length {L} must be a multiple of Q={Q}")
    if bank.dtype != torch.float32 or tuple(bank.shape) != (P, T):
        raise ValueError(f"bank must be float32 ({P}, {T}), got "
                         f"{bank.dtype} {tuple(bank.shape)}")
    if carry.dtype != torch.float32 or tuple(carry.shape) != carry_shape:
        raise ValueError(f"carry must be float32 {carry_shape}, got "
                         f"{carry.dtype} {tuple(carry.shape)}")
    if bank.device != data.device or carry.device != data.device:
        raise ValueError("bank, carry and data must be on one device")


def _check(data, plans, bank, carry, intype, outtype, P, Q, T):
    B, L = check_fmt(data, plans, intype, outtype)
    _check_rest(data, bank, carry, (2, T - 1), L, P, Q, T)
    return B, L


def _check_channels(data, plans, bank, carries, intype, outtype, P, Q, T):
    C, B, L = check_fmt_channels(data, plans, intype, outtype)
    _check_rest(data, bank, carries, (C, 2, T - 1), L, P, Q, T)
    return C, B, L


def mix_resample_chain_plain(data, plans, bank, carry, *, P: int, Q: int,
                             T: int, intype: str = "i16", outtype: str = "i16",
                             dot_precision: str = "highest"):
    """Plain torch version: the mixer's plain version, then the
    gather + fixed-tree dot of ``ops.resample.window_dot`` (``split3`` and
    ``default``: over the bf16-exact halves) over the ``[carry | mixed]``
    buffer, then encode.  Returns ``(out, carry_out)``.

    ``default`` is held to one bf16 pass of the split operands, ``x_h·t_h``
    with float32 sums, which is what a DEFAULT dot is on the TPU; the JAX
    function run on the CPU (interpret mode) computes a DEFAULT dot in
    float32 and is no reference for it.
    """
    check_precision(dot_precision)
    B, L = _check(data, plans, bank, carry, intype, outtype, P, Q, T)
    mixed = mix_blocks_fmt_plain(data, plans, intype=intype, outtype="f32")
    buf = torch.cat([carry, mixed.reshape(2, B * L)], dim=1)
    M = B * L // Q * P
    yi, yq = window_dot(buf[0], buf[1], bank.flip(-1), 0, 0,
                        P=P, Q=Q, T=T, M=M, dot=dot_precision)
    carry_out = buf[:, buf.shape[1] - (T - 1):].clone()
    if outtype == "i16":
        return codec.iq_to_i16_words(yi, yq).reshape(B, M // B), carry_out
    return torch.stack([yi, yq]).reshape(2, B, M // B), carry_out


def mix_resample_chain_channels_plain(data, plans, bank, carries, *, P: int,
                                      Q: int, T: int, intype: str = "i16",
                                      outtype: str = "i16",
                                      dot_precision: str = "highest"):
    """Plain torch version of the channel-batched chain: the stream plain
    version once per channel with ``plans[:, c]`` and ``carries[c]``,
    stacked.  Returns ``(out, carries_out)``."""
    C, _, _ = _check_channels(data, plans, bank, carries, intype, outtype,
                              P, Q, T)
    outs, tails = zip(*(
        mix_resample_chain_plain(data, plans[:, c], bank, carries[c], P=P,
                                 Q=Q, T=T, intype=intype, outtype=outtype,
                                 dot_precision=dot_precision)
        for c in range(C)))
    return stack_channels(outs, outtype), torch.stack(tails)


def plan_launch(dev: torch.device, P: int, Q: int, T: int,
                geom=None) -> geometry.Layout:
    """The launch's tile, threads, register tile and shared-memory layout:
    :func:`geometry.pick_chain` for the card, or ``geom`` =
    ``(tile, threads, R)`` as given (the card tests walk several)."""
    limit = build.shared_memory_limit(dev.index)
    if geom is None:
        return geometry.pick_chain(P, Q, T, limit)
    tile, threads, R = geom
    lay = geometry.layout(((P, Q, T),), tile, threads, (R,))
    if lay.smem_bytes > limit:
        raise ValueError(
            f"chain geometry P={P} Q={Q} T={T} with tile {tile} needs "
            f"{lay.smem_bytes} bytes of shared memory per CTA; the card "
            f"allows {limit}")
    return lay


def _outputs(dev, C, B, L, P, Q, T, outtype):
    M = L // Q * P
    if outtype == "i16":
        out = torch.empty((C, B, M), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((2, C, B, M), dtype=torch.float32, device=dev)
    return out, torch.empty((C, 2, T - 1), dtype=torch.float32, device=dev)


def _launch(data, plans, bank, carries, C, B, L, P, Q, T, intype, outtype,
            geom=None):
    """Launch the kernel over ``(7, C, B)`` plan words and ``(C, 2, T−1)``
    carries; returns ``(C, B, M)`` words or ``(2, C, B, M)`` planes and the
    ``(C, 2, T−1)`` carries.  ``geom`` as in :func:`plan_launch`."""
    dev = data.device
    data, plans = data.contiguous(), plans.contiguous()
    bank, carries = bank.contiguous(), carries.contiguous()
    out, carries_out = _outputs(dev, C, B, L, P, Q, T, outtype)
    lay = plan_launch(dev, P, Q, T, geom)
    _, _, _, R, stride, tap_off, buf_off = lay.rows[0]
    rc = build.load().doppler_chain(
        data.data_ptr(), out.data_ptr(), plans.data_ptr(), bank.data_ptr(),
        carries.data_ptr(), carries_out.data_ptr(), C, B, L, P, Q, T,
        lay.tile, lay.threads, R, stride, tap_off, buf_off, lay.smem_bytes,
        int(intype == "f32"), int(outtype == "f32"),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "chain")
    return out, carries_out


def plan_launch_fast(dev: torch.device, P: int, Q: int, T: int, L: int,
                     geom=None, passes: int = 3) -> geometry.FastLayout:
    """The fast kernel's windows a CTA, threads and shared-memory layout
    for ``passes`` bf16 passes over blocks of L samples:
    :func:`geometry.pick_chain_fast` for the card, or ``geom`` =
    ``(windows, threads)`` as given (the card tests and the sweep walk
    several)."""
    limit = build.shared_memory_limit(dev.index)
    if geom is None:
        return geometry.pick_chain_fast(P, Q, T, L, limit, passes)
    lay = geometry.fast_layout(P, Q, T, L, *geom, passes)
    if lay.smem_bytes > limit:
        raise ValueError(
            f"fast chain geometry P={P} Q={Q} T={T} with {geom[0]} windows "
            f"needs {lay.smem_bytes} bytes of shared memory per CTA; the card "
            f"allows {limit}")
    return lay


_TAPS = {}


def fast_taps(bank: torch.Tensor, P: int, Q: int, T: int, D: int,
              passes: int = 3) -> torch.Tensor:
    """The fast kernel's B fragments of ``bank`` at D windows a row
    (:func:`geometry.fast_taps_index`), int16 on the bank's device, laid out
    once per bank, D and pass count: the entry holds the bank, so its
    storage is not reused while cached, and an in-place change of the bank
    (its version) lays them out anew.  Each CTA copies them into its shared
    memory."""
    key = (bank.data_ptr(), bank._version, bank.device, P, Q, T, D, passes)
    hit = _TAPS.get(key)
    if hit is None or hit[0] is not bank:
        if len(_TAPS) >= 16:
            _TAPS.clear()
        t_h, t_l = bank_halves(bank)
        flat = torch.cat([t_h.reshape(-1).view(torch.int16),
                          t_l.reshape(-1).view(torch.int16),
                          torch.zeros(1, dtype=torch.int16, device=bank.device)])
        idx = torch.from_numpy(geometry.fast_taps_index(P, Q, T, D, passes))
        hit = _TAPS[key] = (bank, flat[idx.to(bank.device)].contiguous())
    return hit[1]


def _launch_fast(data, plans, bank, carries, C, B, L, P, Q, T, intype,
                 outtype, geom=None, passes=3):
    """:func:`_launch` for ``csrc/chain_fast.cu`` with ``passes`` bf16
    passes (3: split3, 1: default); ``geom`` as in :func:`plan_launch_fast`.
    Raises where Q is not a power of two (the chain route's gate admits only
    Q | 128)."""
    dev = data.device
    lay = plan_launch_fast(dev, P, Q, T, L, geom, passes)
    data, plans, carries = data.contiguous(), plans.contiguous(), carries.contiguous()
    taps = fast_taps(bank, P, Q, T, lay.D, passes)
    out, carries_out = _outputs(dev, C, B, L, P, Q, T, outtype)
    rc = build.load().doppler_chain_fast(
        data.data_ptr(), out.data_ptr(), plans.data_ptr(), taps.data_ptr(),
        carries.data_ptr(), carries_out.data_ptr(), C, B, L, P, Q, T, lay.D,
        lay.windows, lay.threads, lay.plane, lay.g_off, lay.x_off,
        lay.smem_bytes, int(intype == "f32"), int(outtype == "f32"), passes,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, "fast chain")
    return out, carries_out


def launch_fast_part(data, plans, bank, carry, *, P: int, Q: int, T: int,
                     part: str):
    """One half of the split3 kernel alone, for timing (``chip_smoke.py``):
    ``part="mix"`` cuts the dot (each warp XORs the span's words into a side
    word, which keeps the mix alive), ``part="dot"`` cuts the mix (the span
    holds zeros).  i16 words ``(B, L)`` in, one stream;
    returns ``(out, side)``.  Not a function of the pipeline: no plain
    version, no launch count."""
    dev = data.device
    B, L = _check(data, plans, bank, carry, "i16", "i16", P, Q, T)
    lay = plan_launch_fast(dev, P, Q, T, L)
    taps = fast_taps(bank, P, Q, T, lay.D)
    out, carries_out = _outputs(dev, 1, B, L, P, Q, T, "i16")
    n_ctas = B * L // Q // lay.windows + 2
    side = torch.zeros(n_ctas * lay.threads // 32, dtype=torch.int32, device=dev)
    rc = build.load().doppler_chain_fast_part(
        data.data_ptr(), out.data_ptr(), plans.data_ptr(), taps.data_ptr(),
        carry.data_ptr(), carries_out.data_ptr(), 1, B, L, P, Q, T, lay.D,
        lay.windows, lay.threads, lay.plane, lay.g_off, lay.x_off,
        lay.smem_bytes, {"mix": 1, "dot": 2}[part], side.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(rc, f"fast chain ({part} only)")
    return out, side


def mix_resample_chain_stream(data, plans, bank, carry, *, P: int, Q: int,
                              T: int, intype: str = "i16", outtype: str = "i16",
                              dot_precision: str = "highest"):
    """Streaming fused chain, all four wire formats.

    ``data``: int32 words ``(B, L)`` or float32 planes ``(2, B, L)``;
    ``plans``: ``(7, B)`` plan words; ``bank``: the ``(P, T)`` polyphase
    bank; ``carry``: ``(2, T−1)`` float32.  Returns ``(out, carry_out)``
    with ``out`` int32 ``(B, L·P/Q)`` or float32 ``(2, B, L·P/Q)``.
    ``dot_precision``: ``"highest"`` (float32 dots), ``"split3"`` or
    ``"default"`` (the fast kernel, see the module docstring).

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (one channel) or raises.
    """
    check_precision(dot_precision)
    if data.device.type == "cpu":
        return mix_resample_chain_plain(data, plans, bank, carry, P=P, Q=Q,
                                        T=T, intype=intype, outtype=outtype,
                                        dot_precision=dot_precision)
    if data.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {data.device}")
    B, L = _check(data, plans, bank, carry, intype, outtype, P, Q, T)
    if dot_precision in PASSES:
        out, carry_out = _launch_fast(data, plans, bank, carry[None], 1, B, L,
                                      P, Q, T, intype, outtype,
                                      passes=PASSES[dot_precision])
        mix_resample_chain_stream.launches_fast += 1
        if dot_precision == "default":
            mix_resample_chain_stream.launches_default += 1
    else:
        out, carry_out = _launch(data, plans, bank, carry, 1, B, L, P, Q, T,
                                 intype, outtype)
        mix_resample_chain_stream.launches += 1
    M = L // Q * P
    return out.reshape((B, M) if outtype == "i16" else (2, B, M)), carry_out[0]


def mix_resample_chain_channels(data, plans, bank, carries, *, P: int, Q: int,
                                T: int, intype: str = "i16",
                                outtype: str = "i16",
                                dot_precision: str = "highest"):
    """Channel-batched streaming chain: one launch for all channels.

    ``data``: the shared chunk, int32 words ``(B, L)`` or float32 planes
    ``(2, B, L)``; ``plans``: ``(7, C, B)`` plan words; ``bank``: the
    ``(P, T)`` bank; ``carries``: ``(C, 2, T−1)`` float32.  Returns
    ``(out, carries_out)`` with ``out`` int32 ``(C, B, L·P/Q)`` or float32
    ``(2, C, B, L·P/Q)``.  Channel c is bitwise
    :func:`mix_resample_chain_stream` with ``plans[:, c]`` and
    ``carries[c]``.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    of ``dot_precision`` or raises.
    """
    check_precision(dot_precision)
    if data.device.type == "cpu":
        return mix_resample_chain_channels_plain(
            data, plans, bank, carries, P=P, Q=Q, T=T, intype=intype,
            outtype=outtype, dot_precision=dot_precision)
    if data.device.type != "cuda":
        raise ValueError(f"no chain kernel for device {data.device}")
    C, B, L = _check_channels(data, plans, bank, carries, intype, outtype,
                              P, Q, T)
    if dot_precision in PASSES:
        out, carries_out = _launch_fast(data, plans, bank, carries, C, B, L,
                                        P, Q, T, intype, outtype,
                                        passes=PASSES[dot_precision])
        mix_resample_chain_channels.launches_fast += 1
        if dot_precision == "default":
            mix_resample_chain_channels.launches_default += 1
    else:
        out, carries_out = _launch(data, plans, bank, carries, C, B, L, P, Q,
                                   T, intype, outtype)
        mix_resample_chain_channels.launches += 1
    return out, carries_out


# kernel launches (CUDA path only): csrc/chain.cu, csrc/chain_fast.cu (both
# pass counts), and of those the one-pass ('default') launches
mix_resample_chain_stream.launches = 0
mix_resample_chain_stream.launches_fast = 0
mix_resample_chain_stream.launches_default = 0
mix_resample_chain_channels.launches = 0
mix_resample_chain_channels.launches_fast = 0
mix_resample_chain_channels.launches_default = 0
