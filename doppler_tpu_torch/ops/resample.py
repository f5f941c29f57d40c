"""Polyphase rational resampler — streaming, in two formulations.

The torch statement of ``doppler_tpu/ops/resample.py``.  Every output is a
pure function of its absolute output index m,

    y[m] = Σ_{l<T} bank[(m·Q) mod P, l] · x[⌊m·Q/P⌋ − l]

and the only sequential state is the T−1-sample input history and the next
output index.  The pipeline runs this on chunks the fused kernels do not
take (the partial EOF chunk, every chunk under ``impl='xla'``), for the EOF
drain, as each stage of a ``MultiStageResampler`` and as the tail of a
split cascade.

Two formulations, chosen by ``RationalResampler(impl=)``:

- ``'window'``: :func:`window_resample`.  On the CPU it is the gather +
  fixed-tree :func:`window_dot`, which the chain's and the cascade's plain
  versions (``ops.cuda``) reuse; on the card it is ``csrc/window.cu``,
  which sums each output as the chain and cascade kernels' FIR does.  So on
  either device a chunk gives the same bytes whether a fused kernel or the
  mixer and this step compute it, and the bytes do not depend on the chunk
  width.
- ``'conv'``: the banded windows-matmul form (:func:`resample_conv_stream`,
  ``csrc/conv.cu`` on the card): the same taps summed in another order, so
  within 1 LSB of ``'window'``, not its bytes.

``'auto'`` means ``'window'`` here.  (The JAX package's ``'auto'`` picks
``'conv'`` when R = ⌈(Q−1+T)/Q⌉ ≤ 8, which takes in config 3's single
stage; here the fused kernels compute the ``'window'`` bytes, and the EOF
chunk of the same stream takes the resampler, so an ``'auto'`` that picked
``'conv'`` would put two forms' bytes in one stream and make them depend on
the chunk width.)  ``'conv'`` runs only when asked for.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from doppler_tpu_torch.ops.cuda import build, geometry
from doppler_tpu_torch.ops.cuda.conv import (
    conv_bands,
    resample_conv_stream,
    row_layout,
)
from doppler_tpu_torch.ops.filters import design_polyphase_bank
from doppler_tpu_torch.ops.precision import (
    check_precision,
    split3_bank,
    split_bf16_exact,
)

__all__ = ["RationalResampler", "window_dot", "window_resample",
           "tree_sum_last", "attach_resampler",
           "make_taps_matrix", "conv_stream_geometry", "resample_conv_stream",
           "resample_conv_block"]

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


def make_taps_matrix(bank: np.ndarray, P: int, Q: int) -> np.ndarray:
    """Host: fold the polyphase bank into the windows-matmul taps matrix.

    ``taps_mat[j, p] = bank_rev[(pQ) mod P, j − ⌊pQ/P⌋]`` (zero outside the
    tap range): output m = i·P + p is then ``Σ_j x[iQ + j] · taps_mat[j, p]``
    over the strided window row.  The JAX package's function, as is.
    """
    T = bank.shape[1]
    bank_rev = bank[:, ::-1]
    w_len = (Q - 1) + T
    taps = np.zeros((w_len, P), dtype=np.float32)
    for p in range(P):
        fp = (p * Q) // P
        taps[fp : fp + T, p] = bank_rev[(p * Q) % P]
    return taps


def conv_stream_geometry(m0: int, in_consumed: int, M: int, N: int,
                         *, P: int, Q: int, T: int):
    """Host: exact alignment ints for :func:`resample_conv_stream`.

    Returns ``(start0, p0, K, PADZ, TAIL)`` for a chunk whose buffer is
    [T−1 history | N inputs] with buffer index 0 at absolute input
    ``in_consumed − (T−1)``: the window row of cycle ⌊m0/P⌋ begins at
    buffer index ``start0`` (< 0 reads the zero padding), and the first
    kept output is its ``p0``-th.  ``K`` cycles (at least 64, as the JAX
    package floors it, so a small EOF chunk's library product has the
    shape class of a full one's) and the ``PADZ``/``TAIL`` zeros depend
    only on (N, M, P, Q, T).  The JAX package's function, as is: exact
    Python ints for any stream position.
    """
    i0, p0 = divmod(m0, P)
    start0 = i0 * Q - in_consumed           # may be < 0 → covered by PADZ
    K = max(64, -(-(P - 1 + M) // P))       # static over p0 < P
    _, R = conv_bands(Q, T)
    # over the life of the stream −2Q − 1 ≤ start0 ≤ Q
    PADZ = 2 * Q + T
    TAIL = max(0, Q + (K + R) * Q - (T - 1 + N))
    if not (-PADZ <= start0 <= Q):
        raise AssertionError(
            f"conv alignment out of bounds: start0={start0} H={T - 1} Q={Q}"
        )
    return start0, p0, K, PADZ, TAIL


def resample_conv_block(xi, xq, taps_mat, *, P: int, Q: int, T: int):
    """The banded-matmul form at window alignment 0 (the JAX package's
    ``resample_conv_block``): ``xi/xq`` are ``(..., H + N)`` with H = T−1
    history samples first and N a multiple of Q; returns the N·P/Q outputs
    whose absolute index 0 sits at logical input 0.  One call of
    :func:`resample_conv_stream` with K = N/Q cycles and no front padding.
    """
    H = T - 1
    N = xi.shape[-1] - H
    if N % Q:
        raise ValueError(f"fast path needs N % Q == 0 (N={N}, Q={Q})")
    K = N // Q
    _, R = conv_bands(Q, T)
    return resample_conv_stream(xi, xq, taps_mat, 0, 0, P=P, Q=Q, T=T, K=K,
                                M=K * P, PADZ=0,
                                TAIL=max(0, (K + R) * Q - (H + N)))


def window_resample(xi, xq, bank_rev, rem0: int, off0: int, *, P: int, Q: int,
                    T: int, M: int):
    """The ``'window'`` resampler step: :func:`window_dot`'s function.

    A CPU tensor runs :func:`window_dot`, its plain version; a CUDA tensor
    launches ``csrc/window.cu`` or raises.  The kernel sums each output as
    the chain and cascade kernels' FIR does (one FMA chain over the taps in
    order), so on the card the mixer and this step give the fused kernels'
    bytes; it is within 1 LSB of the plain version's tree.  ``xi/xq`` are
    ``(H + N,)`` or ``(C, H + N)``; returns ``(M,)`` or ``(C, M)`` planes.
    """
    if xi.device.type == "cpu":
        return window_dot(xi, xq, bank_rev, rem0, off0, P=P, Q=Q, T=T, M=M)
    return _window_launch(xi, xq, bank_rev, rem0, off0, P=P, Q=Q, T=T, M=M)


def _window_launch(xi, xq, bank_rev, rem0: int, off0: int, *, P: int, Q: int,
                   T: int, M: int, layout=None):
    """:func:`window_resample` on the card.  ``layout`` (a
    ``geometry.WindowLayout``) overrides the picked path and sizes (the card
    tests and the sweep walk several: the bytes do not depend on it)."""
    if xi.device.type != "cuda":
        raise ValueError(f"no window resampler for device {xi.device}")
    xi_r, xq_r, stride = row_layout(xi, xq)
    if (bank_rev.dtype != torch.float32 or tuple(bank_rev.shape) != (P, T)
            or bank_rev.device != xi.device):
        raise ValueError(f"bank_rev must be float32 ({P}, {T}) on {xi.device}")
    if not 0 <= rem0 < P:
        raise ValueError(f"rem0 must lie in [0, {P}), got {rem0}")
    lead = tuple(xi.shape[:-1])
    yi = torch.empty(lead + (M,), dtype=torch.float32, device=xi.device)
    yq = torch.empty_like(yi)
    if M <= 0:
        return yi, yq
    bank = bank_rev.contiguous()
    C = math.prod(lead)
    lay = layout or geometry.pick_window(
        P, Q, T, C, M, build.shared_memory_limit(xi.device.index),
        build.sm_count(xi.device.index))
    rc = build.load().doppler_window(
        xi_r.data_ptr(), xq_r.data_ptr(), bank.data_ptr(), yi.data_ptr(),
        yq.data_ptr(), C, xi.shape[-1], stride, M, rem0, off0, P, Q, T,
        (ctypes.c_int * 9)(*lay.args), lay.threads, lay.smem_bytes,
        torch.cuda.current_stream(xi.device).cuda_stream)
    build.check(rc, "window")
    window_resample.launches += 1
    return yi, yq


window_resample.launches = 0           # kernel launches (CUDA path only)


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

    ``impl``: ``'window'`` (and ``'auto'``, which means it here) or
    ``'conv'``, the banded windows-matmul form (:func:`resample_conv_stream`;
    the same alignment and taps, another summation order).  ``'conv'``
    raises if float32 matrix products may use TF32.  A NaN input reaches
    every ``'conv'`` output whose row of R·Q samples (the Q−1+T of its
    window row and the zero taps' rows after it, not T) holds it, so
    NaN-carrying streams keep ``'window'``.
    """

    def __init__(self, in_rate: int, out_rate: float, *,
                 taps_per_phase: int | None = None, atten_db: float = 70.0,
                 channels: int | None = None,
                 max_denominator: int = 1 << 16, device="cpu",
                 impl: str = "auto"):
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
        if impl not in ("auto", "conv", "window"):
            raise ValueError(
                f"impl must be 'auto', 'conv' or 'window', got {impl!r}")
        self.impl = "conv" if impl == "conv" else "window"
        self._taps_mat = (
            torch.from_numpy(make_taps_matrix(self.bank, self.P, self.Q)).to(
                self.device)
            if self.impl == "conv" else None)
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
        if self.impl == "conv":
            if int(valid) * P >= (1 << 31) // 2:
                raise ValueError("chunk too large for 32-bit phase arithmetic")
            start0, p0, K, PADZ, TAIL = conv_stream_geometry(
                m0, self.in_consumed, int(M), int(i.shape[-1]), P=P, Q=Q, T=T)
            yi, yq = resample_conv_stream(
                xi, xq, self._taps_mat, start0, p0, P=P, Q=Q, T=T, K=K,
                M=int(M), PADZ=PADZ, TAIL=TAIL)
        else:
            rem0 = (m0 * Q) % P
            n_m0 = (m0 * Q) // P
            # xi[0] holds absolute input index in_consumed − (T−1)
            off0 = n_m0 - self.in_consumed
            yi, yq = window_resample(xi, xq, self._bank_rev, rem0, off0,
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
