"""The least time the card could take for a fused launch: a frozen copy of
the port's ``chip_smoke.py`` ``_bound`` and its peaks, so that later changes
to the program do not move the yardstick.

The peaks are the published ones of one NVIDIA H100 SXM (data sheet, at its
700 W limit): 3.35 TB/s of HBM, 67 TFLOP/s of float32 FMA outside the tensor
cores (so 33.5 T float32 operations a second that are not an FMA), 989
TFLOP/s of dense bf16.  A share is stated against them with the card's
power limit beside it.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "F32_FLOP_PER_S", "F32_OPS_PER_S",
           "BF16_FLOP_PER_S", "MIX_FLOP", "bound_s"]

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12             # float32 FMA, two operations each
F32_OPS_PER_S = F32_FLOP_PER_S / 2  # float32 operations that are not an FMA
BF16_FLOP_PER_S = 989e12
MIX_FLOP = 29                      # decode 2, tone 21, rotate 6 a sample


def bound_s(C: int, B: int, L: int, stages, *, out_bytes: int = 4,
            passes: int = 0) -> tuple:
    """``(seconds, 'bytes' or 'operations')`` for C channels of a chunk of
    B blocks of L int32 words through ``stages`` (``(P, Q, T)`` each).

    Bytes: the shared chunk and the plan words (28 a block and channel) read
    once, each channel's output written once (``out_bytes`` a sample: 4 for
    i16 pairs, 8 for float32 planes), banks and carries once.  Operations
    in float32 outside the tensor cores: the mix (``MIX_FLOP`` a sample) for
    every channel and 2 a sample to encode i16, each one instruction; and
    4*T*P/Q per stage input sample (I and Q, an FMA counted as two).
    ``passes``: the dot as that many bf16 products a tap on the tensor
    cores instead (the bank read as its two bf16 halves).  One departure
    from the copied rule: a stage's outputs are ``n*P/Q`` and not
    ``n//Q*P``, so a rational tail whose chunk holds fewer than Q inputs
    (the 384/3125 tail gets 2048 a chunk) is counted, not taken as none."""
    n = B * L
    byts = 4 * n + 28 * C * B
    ops, fma, tensor = C * n * MIX_FLOP, 0, 0
    for P, Q, T in stages:
        dot = C * 4 * T * n * P / Q
        if passes:
            tensor += passes * dot
        else:
            fma += dot
        byts += 4 * P * T + 2 * C * 2 * 4 * (T - 1)
        n = n * P / Q
    byts += C * n * out_bytes
    if out_bytes == 4:
        ops += C * n * 2
    t_b = byts / HBM_BYTES_PER_S
    t_f = ops / F32_OPS_PER_S + fma / F32_FLOP_PER_S
    t_t = tensor / BF16_FLOP_PER_S
    return max(t_b, t_f, t_t), "bytes" if t_b >= max(t_f, t_t) else "operations"
