"""Reference outputs of a mix-and-resample stream, one region at a time.

Every output is a pure function of its absolute index: stage s gives

    y_s[m] = sum_l bank_s[(m*Q_s) % P_s, l] * y_(s-1)[(m*Q_s) // P_s - l]

over the mixed input ``y_(-1)[k] = x[k] * exp(-2*pi*i * frac(r*n_k))``,
with zeros before the stream's first sample.  So a region of final outputs
needs only the span of input that its windows reach, and a region is
worked out from the capture directly: decode, mix by the counter of
:mod:`.nco`, each stage in turn, encode.

``dtype`` float64 is the reference; bfloat16 is the control (every product
and sum rounded to bfloat16, the precision below the float32 the binary
states).  PyTorch only; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.nco import counter_values, phase_cycles

__all__ = ["due_count", "region", "encode_i16"]

_ROWS = 1 << 14          # outputs gathered in one pass


def due_count(n_in: int, stages) -> int:
    """Outputs that exist once ``n_in`` inputs have arrived: stage by stage,
    every m whose newest input ``(m*Q) // P`` exists."""
    n = int(n_in)
    for st in stages:
        n = -(-n * st.P // st.Q)
    return n


def _mixed(capture: torch.Tensor, segments, lo: int, hi: int,
           dtype) -> tuple:
    """Mixed input samples ``[lo, hi)`` (zeros before 0) as planes."""
    dev = capture.device
    n_cap = capture.shape[0]
    k = torch.arange(max(lo, 0), hi, dtype=torch.int64, device=dev)
    raw = capture[torch.remainder(k, n_cap)].to(torch.float64) / 32768.0
    phase = torch.empty(k.shape, dtype=torch.float64, device=dev)
    starts = np.array([s.start for s in segments], dtype=np.int64)
    first = max(0, int(np.searchsorted(starts, max(lo, 0), "right")) - 1)
    for seg in segments[first:]:
        if seg.start >= hi:
            break
        sel = (k >= seg.start) & (k < seg.start + seg.length)
        if bool(sel.any()):
            phase[sel] = phase_cycles(seg.r32, counter_values(seg, k[sel]))
    ang = 2.0 * np.pi * phase
    c, s = torch.cos(ang), torch.sin(ang)
    xi, xq = raw[:, 0], raw[:, 1]
    if dtype == torch.float64:
        yi, yq = xi * c + xq * s, xq * c - xi * s
    else:
        xi, xq, c, s = (t.to(dtype) for t in (xi, xq, c, s))
        yi, yq = xi * c + xq * s, xq * c - xi * s
    pad = max(0, -lo)
    if pad:
        z = torch.zeros(pad, dtype=yi.dtype, device=dev)
        yi, yq = torch.cat([z, yi]), torch.cat([z, yq])
    return yi, yq


def _stage(xi, xq, a: int, st, m_lo: int, m_hi: int, dtype) -> tuple:
    """Stage outputs ``[m_lo, m_hi)`` from planes covering input ``[a, ..)``."""
    dev = xi.device
    bank = torch.from_numpy(st.bank.astype(np.float64)).to(dev).to(dtype)
    taps = torch.arange(st.T, dtype=torch.int64, device=dev)
    out_i, out_q = [], []
    for lo in range(m_lo, m_hi, _ROWS):
        m = torch.arange(lo, min(m_hi, lo + _ROWS), dtype=torch.int64,
                         device=dev)
        n, p = m * st.Q // st.P, torch.remainder(m * st.Q, st.P)
        idx = (n - a)[:, None] - taps[None, :]
        w = bank[p]
        out_i.append((xi[idx] * w).sum(dim=1))
        out_q.append((xq[idx] * w).sum(dim=1))
    return torch.cat(out_i), torch.cat(out_q)


def region(capture: torch.Tensor, segments, stages, m_lo: int, m_hi: int,
           dtype=torch.float64) -> tuple:
    """Final outputs ``[m_lo, m_hi)`` as planes of ``dtype``.  ``capture``
    is the ``(N, 2)`` int16 capture (I, Q), replayed cyclically;
    ``segments`` the channel's :func:`.nco.counter_segments`."""
    # the output range each stage needs, from the last stage down
    need = [(m_lo, m_hi)]
    for st in reversed(stages):
        lo, hi = need[0]
        need.insert(0, (lo * st.Q // st.P - (st.T - 1),
                        (hi - 1) * st.Q // st.P + 1))
    a, b = need[0]
    xi, xq = _mixed(capture, segments, a, b, dtype)
    for s, st in enumerate(stages):
        lo, hi = need[s + 1]
        clo = max(lo, 0)
        yi, yq = _stage(xi, xq, a, st, clo, hi, dtype)
        if clo > lo:         # a stage's outputs before its first are zeros
            z = torch.zeros(clo - lo, dtype=yi.dtype, device=yi.device)
            yi, yq = torch.cat([z, yi]), torch.cat([z, yq])
        xi, xq, a = yi, yq, lo
    return xi, xq


def encode_i16(yi: torch.Tensor, yq: torch.Tensor) -> np.ndarray:
    """The binary's i16 encode, ``(x * 32767.0) as i16`` on float32 values
    (truncation toward zero, saturation, NaN -> 0): ``(n, 2)`` int64."""
    out = []
    for y in (yi, yq):
        v = torch.trunc(y.to(torch.float32) * 32767.0)
        v = torch.nan_to_num(v, nan=0.0).clamp(-32768.0, 32767.0)
        out.append(v.to(torch.int64).cpu().numpy())
    return np.stack(out, axis=1)
