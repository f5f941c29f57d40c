"""The operand split of ``--precision fast`` (the ``split3`` dot).

The port of ``doppler_tpu/ops/pallas/chain.py:126-142``
(``_split_bf16_exact``, ``split3_taps``).  A float32 value is written as
``v ≈ h + l`` with both terms bf16-exact float32 values, each rounded to
nearest even as ``astype(bfloat16)`` rounds: ``|v − h − l| ≤ 2⁻¹⁸·|v|``.
The ``split3`` dot then sums ``x_h·t_h + x_h·t_l + x_l·t_h``: every product
of two bf16 values is exact in float32, and only the ``x_l·t_l`` term
(≈ 2⁻¹⁸ of a product) is dropped.
"""

from __future__ import annotations

import torch

__all__ = ["split_bf16_exact", "split3_bank"]


def split_bf16_exact(v: torch.Tensor):
    """``(h, l)``: ``h = bf16(v)``, ``l = bf16(v − h)``, both as float32."""
    h = v.to(torch.bfloat16).to(torch.float32)
    l = (v - h).to(torch.bfloat16).to(torch.float32)
    return h, l


def split3_bank(bank: torch.Tensor):
    """A ``(P, T)`` polyphase bank → its halves ``t_h, t_l``, ``(P, T)``
    float32 each (the TPU's widened 128-row layout is not needed)."""
    return split_bf16_exact(bank)
