"""NCO frequency shifter — the plain torch version of the mixer's math.

Reference semantics (``src/dsp.rs:117-134`` + ``src/complex.c:33-39``): per
sample ``out = in · exp(i · (-2π · f32((shift/fs)·samplenum)))`` with the
reference's samplenum reset quirk.  As in ``doppler_tpu/ops/nco.py``, the
host planner (``ops.phase_plan``) folds that counter into per-block words
``(D, C1, C2, t)`` and the device computes the phase of local sample j as
``(j·D + (j < t ? C1 : C2)) mod 2^64`` exactly.

Plan words travel as one ``(7, B)`` int32 tensor holding the uint32 bits of
``(d_hi, d_lo, c1_hi, c1_lo, c2_hi, c2_lo, t)`` — the layout the kernels in
``ops.cuda`` read.  :func:`plan_tensor` builds it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from doppler_tpu_torch.ops.phase_plan import BlockPlan
from doppler_tpu_torch.ops.sincos import mix_tone, sincos_q24_neg

__all__ = ["PLAN_FIELDS", "plan_tensor", "phase_q24", "mix_blocks"]

PLAN_FIELDS = ("d_hi", "d_lo", "c1_hi", "c1_lo", "c2_hi", "c2_lo", "t")
_M32 = 0xFFFFFFFF


def plan_tensor(plan: BlockPlan | Sequence[np.ndarray], n_blocks: int | None = None,
                device="cpu") -> torch.Tensor:
    """Plan words → ``(7, B)`` int32 tensor of their uint32 bits.

    ``plan`` is a :class:`BlockPlan` or the seven per-block uint32 arrays in
    :data:`PLAN_FIELDS` order.  Blocks past ``len(plan)`` up to
    ``n_blocks`` are zero (padding blocks of a partial chunk).
    """
    if isinstance(plan, BlockPlan):
        plan = [getattr(plan, f) for f in PLAN_FIELDS]
    fields = np.stack([np.asarray(a, dtype=np.uint32) for a in plan])
    if n_blocks is not None and n_blocks > fields.shape[1]:
        fields = np.pad(fields, ((0, 0), (0, n_blocks - fields.shape[1])))
    return torch.from_numpy(fields.view(np.int32).copy()).to(device)


def phase_q24(plans: torch.Tensor, L: int) -> torch.Tensor:
    """Top 24 bits of ``(j·D + C) mod 2^64`` as int32 for local indices
    ``j = 0..L−1`` of every block, ``C = C1`` for ``j < t`` and ``C2``
    after.  ``plans``: ``(7, B)`` plan words.  Returns ``(B, L)``.

    Runs in int64 lanes with the 64-bit words split into u32 halves:
    ``j·d_lo`` and ``j·d_hi`` stay below 2^63 for ``j < 2^31``, and each
    partial is masked to 32 bits after every add, so nothing overflows and
    no uint32 tensor op is needed.
    """
    if L > (1 << 31):
        raise ValueError(f"block length {L} exceeds 2^31 samples")
    w = plans.to(torch.int64) & _M32                  # (7, B) as unsigned
    d_hi, d_lo, c1_hi, c1_lo, c2_hi, c2_lo, t = (x[:, None] for x in w)
    j = torch.arange(L, dtype=torch.int64, device=plans.device)[None, :]
    jd_lo_full = j * d_lo                             # < 2^63
    jd_lo = jd_lo_full & _M32
    jd_hi = ((jd_lo_full >> 32) + ((j * d_hi) & _M32)) & _M32
    seg1 = j < t
    c_lo = torch.where(seg1, c1_lo, c2_lo)
    c_hi = torch.where(seg1, c1_hi, c2_hi)
    lo = jd_lo + c_lo
    q32 = (jd_hi + c_hi + (lo >> 32)) & _M32
    return (q32 >> 8).to(torch.int32)


def mix_blocks(i: torch.Tensor, q: torch.Tensor, plans: torch.Tensor, *,
               tone=sincos_q24_neg):
    """Per-block planned mixer over ``(B, L)`` planar IQ.

    Mirrors main.rs:177: each reference block is mixed with its own
    scheduled shift and its own samplenum continuation.  ``tone`` maps the
    q24 phase to (cos, sin); the tone probe passes the select-chain form.
    """
    c, s = tone(phase_q24(plans, i.shape[-1]))
    return mix_tone(i, q, c, s)
