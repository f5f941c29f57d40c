"""What several metric readers share: per-piece times of an open-loop run,
the chunk geometry the CLI launched, and the chosen trace stretch."""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from benchmark.check import stages_of
from benchmark.drive import FUSED
from benchmark.trace import union_s

__all__ = ["piece_times", "p95_ms", "chunk_geometry", "busy_s",
           "kernel_events"]


def piece_times(run):
    """``(due, taken, written)`` host times of every piece of an open-loop
    run: when its last sample fell due, when the read that took its last
    byte returned, and when the output that covers that sample was
    written.  By the rate ratio, output m covers the input up to index
    ``ceil((m + 1) * fs_in / fs_out) - 1``, so the piece ending at sample
    e - 1 is covered by output ``floor((e - 1) * fs_out / fs_in)``.  None
    for a closed loop; NaN for a piece whose output was not written."""
    src = getattr(run, "source", None)
    if src is None or not hasattr(src, "due"):
        return None
    k = np.arange(src.n_pieces)
    piece_samples = src.bytes_per_piece // 4
    last = (k + 1) * piece_samples - 1
    due, taken = src.due(k), src.taken
    writes = np.asarray(run.sink.writes, dtype=np.float64).reshape(-1, 2)
    ratio = Fraction(1)
    for st in stages_of(run.cell.config):
        ratio *= Fraction(st.P, st.Q)
    n_out = int(writes[-1, 1]) if len(writes) else 0
    first_m = last * ratio.numerator // ratio.denominator
    ok = (first_m < n_out) & np.isfinite(taken)
    # the write after which more than first_m outputs had been written
    w = np.searchsorted(writes[:, 1], first_m[ok], side="right")
    written = np.full(len(k), np.nan)
    written[np.flatnonzero(ok)] = writes[w, 0]
    return due, taken, written


def p95_ms(values) -> float | None:
    v = np.asarray(values, dtype=np.float64)
    v = v[np.isfinite(v)]
    return float(np.percentile(v, 95) * 1e3) if v.size else None


def chunk_geometry(run) -> tuple | None:
    """``(C, B, L)`` of the launches a traced stretch counted: channels,
    blocks a chunk and samples a block.  The stretch holds whole chunks
    (:meth:`.trace.Tracer.poll`), so the samples a launch are the input
    read over it over the fused launches it counted; ``L`` is the block
    the configuration passes to the CLI (``--block-bytes``).  None without
    a whole stretch."""
    st = run.stretch
    fused = sum(st.launches.get(k, 0) for k in FUSED) if st else 0
    if not fused or not st.bytes_in:
        return None
    L = int(run.cell.config["block_bytes"]) // 4
    return len(run.outputs), st.bytes_in // 4 // fused // L, L


def busy_s(stretch) -> float:
    return union_s(stretch.events, stretch.t_start, stretch.t_end)


def kernel_events(stretch, *names) -> list:
    """Device events of the stretch whose name holds one of ``names``."""
    return [e for e in stretch.events if any(n in e[0] for n in names)]
