"""Quarter-wave polynomial sincos on a Q0.24 phase word — the NCO tone.

The torch statement of ``doppler_tpu/ops/sincos.py``: integer-exact
quadrant folding from the top 2 phase bits plus a shared-x² polynomial pair
on [0, π/2), with the same float32 constants and the same sign-bit-XOR fold.
``csrc/nco.cuh`` evaluates the identical chain on the card.

Contraction policy: every product and sum here is its own torch operation,
rounded to float32 on its own, and ``csrc/nco.cuh`` spells each one out with
``__fmul_rn``/``__fadd_rn``/``__fsub_rn`` (which nvcc never fuses into an
FMA).  So the plain version and the kernels agree bitwise on the card.
XLA may contract one product of :func:`mix_tone` into an FMA
(``doppler_tpu/ops/sincos.py:37-55``), so against the JAX package the tone
and the rotation agree to within an ulp, not bitwise.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sincos_q24_neg", "sincos_q24_neg_select", "mix_tone"]


def _f32(v: float) -> float:
    """A Python float that is exactly the float32 nearest ``v`` — so every
    ``tensor * const`` multiplies by the same float32 on any device."""
    return float(np.float32(v))


X_SCALE = _f32((np.pi / 2) * 2.0 ** -22)
# odd polynomial for sin x, coefficients of x, x³, …, x⁹
POLY_SIN = tuple(_f32(c) for c in (0.9999999660, -0.1666665247, 0.0083330520,
                                   -0.0001980742, 2.6019031e-06))
# even polynomial for cos x, coefficients of x², x⁴, …, x¹⁰ (constant 1)
POLY_COS = tuple(_f32(c) for c in (-0.4999999963, 0.0416666418, -0.0013888397,
                                   0.0000247609, -2.605e-07))

_SIGN = -(1 << 31)     # int32 with only the sign bit set


def mix_tone(fi, fq, c, s):
    """``(fi·c − fq·s, fi·s + fq·c)`` — the complex rotation."""
    return fi * c - fq * s, fi * s + fq * c


def _quarter_poly(q24: torch.Tensor):
    """The polynomial pair (sin x, cos x) on x = (q24 mod 2²²)·(π/2)·2⁻²²."""
    x = (q24 & 0x3FFFFF).to(torch.float32) * X_SCALE      # [0, π/2)
    x2 = x * x
    s1, s3, s5, s7, s9 = POLY_SIN
    c2, c4, c6, c8, c10 = POLY_COS
    s_p = x * (s1 + x2 * (s3 + x2 * (s5 + x2 * (s7 + x2 * s9))))
    c_p = 1.0 + x2 * (c2 + x2 * (c4 + x2 * (c6 + x2 * (c8 + x2 * c10))))
    return s_p, c_p


def sincos_q24_neg(q24: torch.Tensor):
    """(cos θ, sin θ) for θ = −2π·q24·2⁻²⁴, q24 an int32 phase in [0, 2²⁴).

    The negative angle matches the reference mixer's corrector
    ``exp(-i·2π·frac(r·n))`` (dsp.rs:121-122).
    """
    quad = q24 >> 22                                      # 0..3
    s_p, c_p = _quarter_poly(q24)
    # quadrant fold: one swap-select per output + sign-bit XOR (cos θ is
    # negative in quadrants 1-2; the returned −sin θ in quadrants 0-1)
    swap = (quad & 1) == 1
    pick_c = torch.where(swap, s_p, c_p)
    pick_s = torch.where(swap, c_p, s_p)
    zero = torch.zeros_like(quad)
    signc = torch.where(((quad + 1) & 2) != 0, zero + _SIGN, zero)
    signs = torch.where((quad & 2) == 0, zero + _SIGN, zero)
    c = (pick_c.view(torch.int32) ^ signc).view(torch.float32)
    s = (pick_s.view(torch.int32) ^ signs).view(torch.float32)
    return c, s


def sincos_q24_neg_select(q24: torch.Tensor):
    """:func:`sincos_q24_neg` with the quadrant fold written as a chain of
    selects over negated values (``tools/probe_chain_precision.py:108``
    ``sincos_select``).  A negation flips the sign bit as the XOR does, so
    the two give the same bits; only the tone probe
    (``ops.cuda.probes.mix_shape_run``) runs this one, to time one fold
    against the other."""
    quad = q24 >> 22
    s_p, c_p = _quarter_poly(q24)
    k0, k1, k2 = quad == 0, quad == 1, quad == 2
    cos_u = torch.where(k0, c_p, torch.where(k1, -s_p, torch.where(k2, -c_p, s_p)))
    sin_u = torch.where(k0, s_p, torch.where(k1, c_p, torch.where(k2, -s_p, -c_p)))
    return cos_u, -sin_u
