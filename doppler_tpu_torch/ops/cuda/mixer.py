"""Mixer: decode → exact Q0.64 NCO phase → tone → rotate → encode.

:func:`mix_blocks_fmt` launches ``csrc/mixer.cu`` on a CUDA tensor (the
port of ``doppler_tpu/ops/pallas/mixer.py:227`` ``mix_blocks_pallas_fmt``)
and runs :func:`mix_blocks_fmt_plain` on a CPU tensor.
:func:`mix_blocks_fmt_channels` is the same kernel with a channel axis: C
channels mix one shared chunk, each with its own plan words (what
``doppler_tpu/runtime/channels.py:64`` ``_channels_mix_kernel`` computes).
One stream is bound by HBM bytes (8 B/sample i16→i16); many channels by
the mix's instructions as much as by their stores.  A CTA mixes G channels
(the kernel's ``mixer_group``) from one decode of its samples; see the
source for the design.  :func:`mix_blocks_q15` launches ``csrc/mixer_q15.cu`` (the port
of ``doppler_tpu/ops/pallas/mixer.py:357`` ``mix_blocks_pallas_q15``): the
same plan words and tone with the sample path in int32, timed beside the
mixer by ``tools/roofline.py``; :func:`mix_blocks_q15_plain` is its plain
version.

Wire formats: ``'i16'`` is int32 words ``(B, L)`` (one LE i16 IQ pair
each); ``'f32'`` is planar float32 ``(2, B, L)``, I plane first.  Channel
outputs are int32 ``(C, B, L)`` or float32 ``(2, C, B, L)``; channel plan
words are int32 ``(7, C, B)``.
"""

from __future__ import annotations

import torch

from doppler_tpu_torch.ops import codec, nco
from doppler_tpu_torch.ops.sincos import sincos_q24_neg
from doppler_tpu_torch.ops.cuda import build

__all__ = ["mix_blocks_fmt", "mix_blocks_fmt_plain", "mix_blocks_fmt_channels",
           "mix_blocks_fmt_channels_plain", "mix_blocks_q15",
           "mix_blocks_q15_plain", "check_fmt", "check_fmt_channels",
           "stack_channels"]

_FORMATS = ("i16", "f32")


def _chunk_shape(data: torch.Tensor, intype: str, outtype: str) -> tuple[int, int]:
    if intype not in _FORMATS or outtype not in _FORMATS:
        raise ValueError(f"bad format combo {intype!r} → {outtype!r}")
    if intype == "i16":
        if data.dtype != torch.int32 or data.dim() != 2:
            raise ValueError(f"i16 input must be int32 (B, L), got "
                             f"{data.dtype} {tuple(data.shape)}")
        B, L = data.shape
    else:
        if data.dtype != torch.float32 or data.dim() != 3 or data.shape[0] != 2:
            raise ValueError(f"f32 input must be float32 (2, B, L), got "
                             f"{data.dtype} {tuple(data.shape)}")
        _, B, L = data.shape
    return int(B), int(L)


def check_fmt(data: torch.Tensor, plans: torch.Tensor, intype: str,
              outtype: str) -> tuple[int, int]:
    """Validate a chunk and its ``(7, B)`` plan words; returns (B, L)."""
    B, L = _chunk_shape(data, intype, outtype)
    if plans.dtype != torch.int32 or tuple(plans.shape) != (7, B):
        raise ValueError(f"plans must be int32 (7, {B}), got "
                         f"{plans.dtype} {tuple(plans.shape)}")
    if plans.device != data.device:
        raise ValueError("plans and data must be on one device")
    return B, L


def check_fmt_channels(data: torch.Tensor, plans: torch.Tensor, intype: str,
                       outtype: str) -> tuple[int, int, int]:
    """Validate a shared chunk and its ``(7, C, B)`` plan words; returns
    (C, B, L)."""
    B, L = _chunk_shape(data, intype, outtype)
    if (plans.dtype != torch.int32 or plans.dim() != 3
            or plans.shape[0] != 7 or plans.shape[1] < 1 or plans.shape[2] != B):
        raise ValueError(f"plans must be int32 (7, C, {B}), got "
                         f"{plans.dtype} {tuple(plans.shape)}")
    if plans.device != data.device:
        raise ValueError("plans and data must be on one device")
    return int(plans.shape[1]), B, L


def stack_channels(outs, outtype: str) -> torch.Tensor:
    """Per-channel stream outputs → ``(C, …)`` words or ``(2, C, …)`` planes."""
    return torch.stack(list(outs), dim=0 if outtype == "i16" else 1)


def mix_blocks_fmt_plain(data: torch.Tensor, plans: torch.Tensor, *,
                         intype: str = "i16", outtype: str = "i16") -> torch.Tensor:
    """Plain torch version: decode → ``nco.mix_blocks`` → encode."""
    check_fmt(data, plans, intype, outtype)
    if intype == "i16":
        i, q = codec.i16_words_to_iq(data)
    else:
        i, q = data[0], data[1]
    i, q = nco.mix_blocks(i, q, plans)
    if outtype == "i16":
        return codec.iq_to_i16_words(i, q)
    return torch.stack([i, q])


def mix_blocks_fmt_channels_plain(data: torch.Tensor, plans: torch.Tensor, *,
                                  intype: str = "i16",
                                  outtype: str = "i16") -> torch.Tensor:
    """Plain torch version of the channel-batched mixer: the stream plain
    version once per channel with ``plans[:, c]``, stacked."""
    C, _, _ = check_fmt_channels(data, plans, intype, outtype)
    return stack_channels(
        (mix_blocks_fmt_plain(data, plans[:, c], intype=intype, outtype=outtype)
         for c in range(C)), outtype)


def _launch(data, plans, C: int, B: int, L: int, intype: str,
            outtype: str, G: int = 0) -> torch.Tensor:
    """Launch the kernel over ``(7, C, B)`` plan words; returns ``(C, B, L)``
    words or ``(2, C, B, L)`` planes.  ``G``: channels a CTA, 0 for the
    kernel's own pick (``chip_smoke.py`` times the others)."""
    data = data.contiguous()
    plans = plans.contiguous()
    if outtype == "i16":
        out = torch.empty((C, B, L), dtype=torch.int32, device=data.device)
    else:
        out = torch.empty((2, C, B, L), dtype=torch.float32, device=data.device)
    rc = build.load().doppler_mix_blocks(
        data.data_ptr(), out.data_ptr(), plans.data_ptr(), C, B, L,
        int(intype == "f32"), int(outtype == "f32"),
        G,
        torch.cuda.current_stream(data.device).cuda_stream)
    build.check(rc, "mixer")
    return out


def mix_blocks_fmt(data: torch.Tensor, plans: torch.Tensor, *,
                   intype: str = "i16", outtype: str = "i16") -> torch.Tensor:
    """Fused decode → mix → encode for any i16/f32 wire-format pair.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.  Returns the ``outtype`` layout of the same ``(B, L)``.
    """
    if data.device.type == "cpu":
        return mix_blocks_fmt_plain(data, plans, intype=intype, outtype=outtype)
    if data.device.type != "cuda":
        raise ValueError(f"no mixer for device {data.device}")
    B, L = check_fmt(data, plans, intype, outtype)
    out = _launch(data, plans, 1, B, L, intype, outtype)
    mix_blocks_fmt.launches += 1
    return out.reshape((B, L) if outtype == "i16" else (2, B, L))


def mix_blocks_fmt_channels(data: torch.Tensor, plans: torch.Tensor, *,
                            intype: str = "i16",
                            outtype: str = "i16") -> torch.Tensor:
    """C channels over one shared chunk in one launch.

    ``data``: int32 words ``(B, L)`` or float32 planes ``(2, B, L)``;
    ``plans``: ``(7, C, B)`` plan words.  Returns int32 ``(C, B, L)`` or
    float32 ``(2, C, B, L)``; channel c is bitwise :func:`mix_blocks_fmt`
    with ``plans[:, c]``.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if data.device.type == "cpu":
        return mix_blocks_fmt_channels_plain(data, plans, intype=intype,
                                             outtype=outtype)
    if data.device.type != "cuda":
        raise ValueError(f"no mixer for device {data.device}")
    C, B, L = check_fmt_channels(data, plans, intype, outtype)
    out = _launch(data, plans, C, B, L, intype, outtype)
    mix_blocks_fmt_channels.launches += 1
    return out


def mix_blocks_q15_plain(words: torch.Tensor, plans: torch.Tensor) -> torch.Tensor:
    """Plain torch version of the integer-domain mixer, int32 throughout.

    The tone is quantised to Q15 by ``(v·32767 ± 0.5)`` truncated (round
    half away from zero); ``re = i·c15 − q·s15`` and ``im = i·s15 + q·c15``
    stay inside int32 because the scale is 32767, not 32768; ``÷2¹⁵``
    truncates toward zero by adding 32767 to negatives before the
    arithmetic shift; then saturate and pack.
    """
    check_fmt(words, plans, "i16", "i16")
    iw, qw = codec.unpack_i16_words(words)
    c, s = sincos_q24_neg(nco.phase_q24(plans, words.shape[-1]))

    def q15(v):
        half = torch.where(v >= 0, 0.5, -0.5).to(torch.float32)
        return (v * 32767.0 + half).to(torch.int32)

    def down(v):
        v = torch.bitwise_right_shift(
            v + (torch.bitwise_right_shift(v, 31) & 32767), 15)
        return torch.clamp(v, -32768, 32767)

    c15, s15 = q15(c), q15(s)
    return codec.pack_i16_words(down(iw * c15 - qw * s15),
                                down(iw * s15 + qw * c15))


def mix_blocks_q15(words: torch.Tensor, plans: torch.Tensor) -> torch.Tensor:
    """Integer-domain i16→i16 mixer over int32 words ``(B, L)`` with
    ``(7, B)`` plan words.  Not byte-exact against the float32 mixer (the
    tone carries 15 bits): a few LSB apart.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if words.device.type == "cpu":
        return mix_blocks_q15_plain(words, plans)
    if words.device.type != "cuda":
        raise ValueError(f"no mixer for device {words.device}")
    B, L = check_fmt(words, plans, "i16", "i16")
    words, plans = words.contiguous(), plans.contiguous()
    out = torch.empty_like(words)
    rc = build.load().doppler_mix_blocks_q15(
        words.data_ptr(), out.data_ptr(), plans.data_ptr(), B, L,
        torch.cuda.current_stream(words.device).cuda_stream)
    build.check(rc, "q15 mixer")
    mix_blocks_q15.launches += 1
    return out


mix_blocks_fmt.launches = 0            # kernel launches (CUDA path only)
mix_blocks_fmt_channels.launches = 0
mix_blocks_q15.launches = 0
