"""Mixer: decode → exact Q0.64 NCO phase → tone → rotate → encode.

:func:`mix_blocks_fmt` launches ``csrc/mixer.cu`` on a CUDA tensor (the
port of ``doppler_tpu/ops/pallas/mixer.py:227`` ``mix_blocks_pallas_fmt``)
and runs :func:`mix_blocks_fmt_plain` on a CPU tensor.  The kernel is bound
by HBM bytes (8 B/sample i16→i16); see the source for its design.

Wire formats: ``'i16'`` is int32 words ``(B, L)`` (one LE i16 IQ pair
each); ``'f32'`` is planar float32 ``(2, B, L)``, I plane first.
"""

from __future__ import annotations

import torch

from doppler_tpu_torch.ops import codec, nco
from doppler_tpu_torch.ops.cuda import build

__all__ = ["mix_blocks_fmt", "mix_blocks_fmt_plain", "check_fmt"]

_FORMATS = ("i16", "f32")


def check_fmt(data: torch.Tensor, plans: torch.Tensor, intype: str,
              outtype: str) -> tuple[int, int]:
    """Validate a chunk and its ``(7, B)`` plan words; returns (B, L)."""
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
    if plans.dtype != torch.int32 or tuple(plans.shape) != (7, B):
        raise ValueError(f"plans must be int32 (7, {B}), got "
                         f"{plans.dtype} {tuple(plans.shape)}")
    if plans.device != data.device:
        raise ValueError("plans and data must be on one device")
    return int(B), int(L)


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
    data = data.contiguous()
    plans = plans.contiguous()
    if outtype == "i16":
        out = torch.empty((B, L), dtype=torch.int32, device=data.device)
    else:
        out = torch.empty((2, B, L), dtype=torch.float32, device=data.device)
    rc = build.load().doppler_mix_blocks(
        data.data_ptr(), out.data_ptr(), plans.data_ptr(), B, L,
        int(intype == "f32"), int(outtype == "f32"),
        torch.cuda.current_stream(data.device).cuda_stream)
    build.check(rc, "mixer")
    mix_blocks_fmt.launches += 1
    return out


mix_blocks_fmt.launches = 0   # kernel launches (CUDA path only)
