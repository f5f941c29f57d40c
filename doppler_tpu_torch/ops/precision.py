"""The operand split of ``--precision fast`` (the ``split3`` dot) and of
the one-pass ``default`` dot.

The port of ``doppler_tpu/ops/pallas/chain.py:126-142``
(``_split_bf16_exact``, ``split3_taps``).  A float32 value is written as
``v ≈ h + l`` with both terms bf16-exact float32 values, each rounded to
nearest even as ``astype(bfloat16)`` rounds: ``|v − h − l| ≤ 2⁻¹⁸·|v|``.
The ``split3`` dot then sums ``x_h·t_h + x_h·t_l + x_l·t_h``: every product
of two bf16 values is exact in float32, and only the ``x_l·t_l`` term
(≈ 2⁻¹⁸ of a product) is dropped.  The ``default`` dot, the TPU's one
bf16 pass of a DEFAULT-precision dot, sums ``x_h·t_h`` alone.
"""

from __future__ import annotations

import torch

__all__ = ["DOT_PRECISIONS", "PASSES", "check_precision", "split_bf16_exact",
           "split3_bank", "bank_halves"]

DOT_PRECISIONS = ("highest", "split3", "default")
PASSES = {"split3": 3, "default": 1}     # bf16 passes of the fast kernels


def check_precision(dot_precision: str) -> None:
    if dot_precision not in DOT_PRECISIONS:
        raise ValueError(f"dot_precision must be one of {DOT_PRECISIONS}, "
                         f"got {dot_precision!r}")


def split_bf16_exact(v: torch.Tensor):
    """``(h, l)``: ``h = bf16(v)``, ``l = bf16(v − h)``, both as float32."""
    h = v.to(torch.bfloat16).to(torch.float32)
    l = (v - h).to(torch.bfloat16).to(torch.float32)
    return h, l


def split3_bank(bank: torch.Tensor):
    """A ``(P, T)`` polyphase bank → its halves ``t_h, t_l``, ``(P, T)``
    float32 each (the TPU's widened 128-row layout is not needed)."""
    return split_bf16_exact(bank)


_HALVES: dict = {}


def bank_halves(bank):
    """The bank's bf16 halves ``t_h, t_l`` (:func:`split3_bank`) as bf16
    tensors on its device, computed once per bank: the entry holds the bank,
    so its storage is not reused while cached, and an in-place change of the
    bank (its version) computes them anew."""
    key = (bank.data_ptr(), bank._version, bank.device)
    hit = _HALVES.get(key)
    if hit is None or hit[0] is not bank:
        if len(_HALVES) >= 16:
            _HALVES.clear()
        t_h, t_l = split3_bank(bank)
        hit = _HALVES[key] = (bank, t_h.to(torch.bfloat16).contiguous(),
                              t_l.to(torch.bfloat16).contiguous())
    return hit[1], hit[2]
