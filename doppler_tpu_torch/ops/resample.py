"""Polyphase rational resampler — streaming, the gather + fixed-tree form.

The torch statement of ``doppler_tpu/ops/resample.py``'s ``'window'``
formulation.  Every output is a pure function of its absolute output index m,

    y[m] = Σ_{l<T} bank[(m·Q) mod P, l] · x[⌊m·Q/P⌋ − l]

and the only sequential state is the T−1-sample input history and the next
output index.  The pipeline runs this on chunks the fused kernels do not
take (the partial EOF chunk), for the EOF drain, as each stage of a
``MultiStageResampler`` and as the tail of a split cascade; the chain's and
the cascade's plain versions (``ops.cuda``) reuse :func:`window_dot`, so on
the CPU every route gives the same bytes.

The banded-matmul ``'conv'`` formulation of the JAX package exists for the
TPU's matrix unit and is not carried over.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from doppler_tpu_torch.ops.filters import design_polyphase_bank
from doppler_tpu_torch.ops.precision import (
    check_precision,
    split3_bank,
    split_bf16_exact,
)

__all__ = ["RationalResampler", "window_dot", "tree_sum_last", "attach_resampler"]

# output rows gathered per pass of window_dot, over all channels: bounds
# the (C, m, 2^⌈log2 T⌉) gather to a few hundred MB whatever the chunk and
# the channel count (a pass takes _SLAB // C outputs of every channel);
# results do not depend on it
_SLAB = 1 << 16


def tree_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Fixed-order pairwise sum over the last axis.

    An explicit power-of-two pairwise tree is a chain of ordinary float32
    adds, so every caller rounds identically whatever the batch shape —
    the same tree as ``doppler_tpu/ops/resample.py::_tree_sum_last``.
    """
    n = x.shape[-1]
    p = 1 << (n - 1).bit_length()
    if p != n:
        x = torch.nn.functional.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., ::2] + x[..., 1::2]
    return x[..., 0]


def window_dot(xi, xq, bank_rev, rem0: int, off0: int, *, P: int, Q: int,
               T: int, M: int, dot: str = "highest"):
    """Resample M outputs from a padded input window.

    ``xi, xq``   : ``(H + N,)`` planar input — or ``(C, H + N)``, one row
                   per channel, all on the same output grid — where index 0
                   sits T−1 samples before the first output's
                   newest-needed sample.
    ``bank_rev`` : ``(P, T)`` bank with taps reversed (so the window dot is a
                   forward gather: y = Σ_l rev[p, l] · x[base + l]).
    ``rem0``     : (m0·Q) mod P for the first output index m0.
    ``off0``     : position of ⌊m0·Q/P⌋ − (T−1) within the input window.

    Gather indices past the window clip to its last sample, as
    ``jnp.take(mode='clip')`` does; such outputs lie beyond the valid count.
    Returns ``(M,)`` — or ``(C, M)`` — planes; row c of a batched call is
    bitwise the unbatched call on row c (the same products into the same
    tree).

    ``dot``: ``"highest"``, the float32 products; ``"split3"``, the
    ``--precision fast`` function (``ops.precision``): the inputs and the
    taps split into bf16-exact halves, each tap's term
    ``x_h·t_h + x_h·t_l + x_l·t_h`` (three exact products, two float32
    adds in that order) into the same tree; ``"default"``, the one bf16
    pass of the TPU's DEFAULT dot: ``x_h·t_h`` alone (an exact product)
    into the same tree.
    """
    dev = xi.device
    last = xi.shape[-1] - 1
    lead = tuple(xi.shape[:-1])
    slab = max(1, _SLAB // max(1, math.prod(lead)))
    taps_k = torch.arange(T, dtype=torch.int64, device=dev)
    yi = torch.empty(lead + (M,), dtype=torch.float32, device=dev)
    yq = torch.empty(lead + (M,), dtype=torch.float32, device=dev)
    check_precision(dot)
    if dot != "highest":
        rev_h, rev_l = split3_bank(bank_rev)
        planes = (split_bf16_exact(xi), split_bf16_exact(xq))
    for m_lo in range(0, M, slab):
        j = torch.arange(m_lo, min(M, m_lo + slab), dtype=torch.int64,
                         device=dev)
        u = j * Q + rem0                        # upsampled offsets
        base = off0 + u // P                    # window start per output
        idx = (base[:, None] + taps_k[None, :]).clamp_(0, last)
        out = slice(m_lo, m_lo + j.numel())
        if dot == "split3":
            t_h, t_l = rev_h[u % P], rev_l[u % P]
            for y, (x_h, x_l) in zip((yi, yq), planes):
                g_h = x_h[..., idx]
                y[..., out] = tree_sum_last(g_h * t_h + g_h * t_l
                                            + x_l[..., idx] * t_h)
            continue
        if dot == "default":
            t_h = rev_h[u % P]
            for y, (x_h, _) in zip((yi, yq), planes):
                y[..., out] = tree_sum_last(x_h[..., idx] * t_h)
            continue
        taps = bank_rev[u % P]                  # (m, T)
        yi[..., out] = tree_sum_last(xi[..., idx] * taps)
        yq[..., out] = tree_sum_last(xq[..., idx] * taps)
    return yi, yq


class RationalResampler:
    """Streaming P/Q resampler over planar IQ chunks on one device.

    ``in_rate``/``out_rate`` are reduced to lowest terms (a non-integer
    ``out_rate`` is rationalized to within ``1/max_denominator`` relative
    error, as in the JAX package); the polyphase bank
    (``ops.filters.design_polyphase_bank``, ``taps_per_phase`` taps a phase
    or auto-sized for ``atten_db``) has P phases.  ``device`` holds the FIR
    history and the taps.  ``channels=C`` batches C channels of one capture:
    ``(C, T−1)`` histories, ``process`` over ``(C, N)`` planes, one output
    grid for all (the input counts are the same for every channel); row c
    is bitwise an unbatched resampler fed row c.
    """

    def __init__(self, in_rate: int, out_rate: float, *,
                 taps_per_phase: int | None = None, atten_db: float = 70.0,
                 channels: int | None = None,
                 max_denominator: int = 1 << 16, device="cpu"):
        if in_rate <= 0 or out_rate <= 0:
            raise ValueError("rates must be positive")
        if float(out_rate).is_integer():
            g = math.gcd(int(in_rate), int(out_rate))
            self.P = int(out_rate) // g
            self.Q = int(in_rate) // g
        else:
            from fractions import Fraction

            frac = Fraction(float(out_rate) / float(in_rate)).limit_denominator(
                max_denominator
            )
            self.P = frac.numerator
            self.Q = frac.denominator
        self.in_rate = int(in_rate)
        self.out_rate = float(out_rate)
        self.device = torch.device(device)
        self.bank = design_polyphase_bank(self.P, self.Q, taps_per_phase,
                                          atten_db)
        self.T = self.bank.shape[1]
        self._bank_rev = torch.from_numpy(self.bank[:, ::-1].copy()).to(self.device)
        if channels is not None and channels < 1:
            raise ValueError(f"channels must be positive, got {channels}")
        self.channels = channels      # None = single stream; int C = batch

        # streaming state: next output index + T−1 input history samples
        # (m_next is shared by the channels: the output grid depends only
        # on input counts)
        self.m_next = 0
        self.in_consumed = 0          # absolute input samples seen
        hist_shape = ((self.T - 1,) if channels is None
                      else (channels, self.T - 1))
        self._hist_i = torch.zeros(hist_shape, dtype=torch.float32,
                                   device=self.device)
        self._hist_q = torch.zeros_like(self._hist_i)

    # -- plumbing -----------------------------------------------------------

    def out_count_for(self, n_new_inputs: int) -> int:
        """Outputs produced once ``n_new_inputs`` more samples arrive."""
        s1 = self.in_consumed + n_new_inputs
        m_hi = -(-s1 * self.P // self.Q) - 1   # last m with ⌊mQ/P⌋ ≤ s1−1
        return max(0, m_hi + 1 - self.m_next)

    def max_out_for(self, chunk_capacity: int) -> int:
        """Static bound on outputs per chunk (for fixed output shapes)."""
        return chunk_capacity * self.P // self.Q + 2

    def process(self, i: torch.Tensor, q: torch.Tensor, valid: int, M: int):
        """Resample one chunk.

        ``i, q`` : ``(N,)`` — or ``(C, N)`` with ``channels=C`` — planar
                   float32 tensors on ``device``; entries beyond ``valid``
                   are padding and never influence valid outputs.
        ``M``    : output capacity (≥ out_count_for(valid)).
        Returns (yi, yq, n_valid_outputs).
        """
        T, P, Q = self.T, self.P, self.Q
        n_out = self.out_count_for(valid)
        xi = torch.cat([self._hist_i, i.to(torch.float32)], dim=-1)
        xq = torch.cat([self._hist_q, q.to(torch.float32)], dim=-1)
        m0 = self.m_next
        rem0 = (m0 * Q) % P
        n_m0 = (m0 * Q) // P
        # xi[0] holds absolute input index in_consumed − (T−1)
        off0 = n_m0 - self.in_consumed
        yi, yq = window_dot(xi, xq, self._bank_rev, rem0, off0,
                            P=P, Q=Q, T=T, M=int(M))
        # advance streaming state; the new history is a slice of the
        # [hist | chunk] buffer (no host sync)
        self.m_next = m0 + n_out
        self.in_consumed += int(valid)
        if valid and T > 1:
            self._hist_i = xi[..., valid:valid + T - 1]
            self._hist_q = xq[..., valid:valid + T - 1]
        return yi, yq, n_out

    # -- checkpointing ------------------------------------------------------

    def state_dict(self) -> dict:
        return {
            "m_next": self.m_next,
            "in_consumed": self.in_consumed,
            "hist_i": self._hist_i.detach().cpu().numpy().copy(),
            "hist_q": self._hist_q.detach().cpu().numpy().copy(),
        }

    def load_state(self, state: dict) -> None:
        self.m_next = int(state["m_next"])
        self.in_consumed = int(state["in_consumed"])
        shape = tuple(self._hist_i.shape)     # (T−1,) or (C, T−1)
        for key in ("hist_i", "hist_q"):
            h = np.asarray(state[key], dtype=np.float32)
            if self.channels is None:
                h = h.reshape(-1)
            if h.shape != shape:
                raise ValueError(
                    f"{key} has shape {h.shape}; this resampler keeps "
                    f"{shape} (channels × T−1 samples)")
            setattr(self, f"_{key}", torch.from_numpy(h.copy()).to(self.device))


def attach_resampler(pipe, out_rate: float, *, stages: str = "single",
                     **kwargs) -> None:
    """CLI glue: give a Pipeline a post-mix resampler on its device.

    ``stages``: 'single' (the default here, as in the JAX package), 'auto'
    (the halfband cascade for ≥4× decimation) or 'multi' (force the
    cascade) — see ``ops.multistage.make_resampler``.
    """
    from doppler_tpu_torch.ops.multistage import make_resampler

    pipe.set_resampler(make_resampler(pipe.samplerate, out_rate,
                                      stages=stages, device=pipe.device,
                                      **kwargs))
