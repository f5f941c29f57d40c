"""Launch geometry of the chain and cascade kernels, in Python (and, at the
end, of the kernels of the bf16 dots, ``csrc/chain_fast.cu`` and
``csrc/cascade_fast.cu``).

The kernels (``csrc/chain.cu``, ``csrc/cascade.cu``, ``csrc/fir.cuh``) take
their tile, their thread count, each stage's register tile ``R`` and the
layout of their shared memory from here, so the CPU tests reach all of it:
what a CTA holds, that it fits the card, that the CTAs cover every output
and every carry entry once.  Nothing here touches a device.

Terms (``csrc/fir.cuh``): output ``j = P·i + p`` of a stage is phase ``p``
of window ``i`` and reads ``x[Q·i + off_p − l]``, ``off_p = ⌊p·Q/P⌋``.  A
thread owns ``NP`` phases (3 where ``P = 3``, else 1) of ``R`` neighbouring
windows.  A span of ``x`` is float2 at ``pad(k) = k + ⌊k/S⌋``, ``S = Q·R``,
with ``k = 0`` at ``x[Q·i_lo − (T−1) − SLACK]``.
"""

from __future__ import annotations

import dataclasses
import functools

__all__ = ["SLACK", "MAX_THREADS", "r_choices", "tap_stride", "span_words",
           "span_back", "Layout", "layout", "cta_units", "cta_spans",
           "ctas_per_sm", "pick_cascade", "pick_chain", "FastLayout",
           "fast_columns", "fast_layout", "pick_chain_fast", "fast_taps_index",
           "CascadeFastLayout", "cascade_fast_columns", "cascade_fast_slab",
           "cascade_fast_spans", "cascade_fast_layout", "pick_cascade_fast",
           "check_cascade_fast_chunk", "fast_cta_units", "fast_cta_spans",
           "cascade_fast_nan_reach"]

SLACK = 3             # csrc/fir.cuh kSlack
MAX_THREADS = 512     # the kernels' __launch_bounds__
MAX_STAGES = 4
SM_SHARED_BYTES = 233472    # shared memory of one H100 SM (228 KB)
CTA_RESERVED_BYTES = 1024   # what the system keeps of it for each CTA
TILES = (1024, 768, 512, 384, 256, 192, 128, 96, 64, 48, 32, 16, 8)


def r_choices(P: int) -> tuple:
    """Register tiles ``csrc/fir.cuh fir_run`` is compiled for."""
    return (1, 2)


def n_phases(P: int) -> int:
    return 3 if P == 3 else 1


def tap_stride(T: int) -> int:
    """Floats a tap row takes: 4 in front, a lead of up to 3, its T taps and
    3 behind (a group of four taps may start 3 early and end 3 late)."""
    return (T + 10 + 3) // 4 * 4


def span_back(c: int, P: int, Q: int, T: int) -> int:
    """Entries of x a run of ``c`` outputs reads, at most."""
    return ((c - 1) * Q + P - 1) // P + T


def span_words(c: int, P: int, Q: int, T: int, R: int) -> int:
    """float2 entries of the padded span under a run of ``c`` outputs that
    may start at any phase: whole groups of R windows, the slack below."""
    windows = (c + P - 2) // P + 1
    groups = -(-windows // R)
    top = Q * (groups * R - 1) + ((P - 1) * Q) // P + (T - 1) + SLACK
    return top + top // (Q * R) + 1


@dataclasses.dataclass(frozen=True)
class Layout:
    """One launch: ``rows`` is 7 ints a stage, ``P, Q, T, R, tap_stride,
    tap_off, buf_off`` (float offsets into the CTA's dynamic shared memory),
    as the C entry points take them."""
    tile: int
    threads: int
    regs: tuple
    rows: tuple
    words: tuple          # float2 entries of each stage's span
    smem_bytes: int


def layout(stages, tile: int, threads: int, regs) -> Layout:
    """Shared-memory layout for final tiles of ``tile`` outputs over
    ``stages`` = ``(P, Q, T)`` each, with ``regs[s]`` windows a thread."""
    return _layout(tuple(tuple(int(v) for v in st) for st in stages),
                   int(tile), int(threads), tuple(int(r) for r in regs))


@functools.lru_cache(maxsize=None)
def _layout(stages, tile, threads, regs) -> Layout:
    S = len(stages)
    if not 1 <= S <= MAX_STAGES or len(regs) != S:
        raise ValueError(f"1 to {MAX_STAGES} stages with one R each")
    if tile < 1 or threads % 32 or not 32 <= threads <= MAX_THREADS:
        raise ValueError(f"tile {tile} / threads {threads}: threads must be a "
                         f"multiple of 32 up to {MAX_THREADS}")
    for (P, _, _), R in zip(stages, regs):
        if R not in r_choices(P):
            raise ValueError(f"R={R} is not one of {r_choices(P)} for P={P}")
    # the largest span of x_s any CTA holds: the output tile's, or that of a
    # carry CTA (up to `tile` entries of x_t at the end of the chunk)
    words = [0] * S
    for t in range(1, S + 1):
        c = tile if t == S else min(tile, stages[t][2] - 1)
        for s in range(t - 1, -1, -1):
            if c <= 0:
                break
            P, Q, T = stages[s]
            words[s] = max(words[s], span_words(c, P, Q, T, regs[s]))
            c = span_back(c, P, Q, T)
    rows, off = [], 0
    for P, _, T in stages:
        rows.append([tap_stride(T), off])
        off += P * tap_stride(T)
    for s, w in enumerate(words):
        rows[s].append(off)
        off += (2 * w + 3) // 4 * 4
    return Layout(tile, threads, regs,
                  tuple((P, Q, T, R, *row)
                        for (P, Q, T), R, row in zip(stages, regs, rows)),
                  tuple(words), 4 * off)


def cta_units(stages, n0: int, tile: int):
    """The CTAs of one channel as ``(t, a, c)``: entries ``a .. a+c−1`` of
    x_t (``t = len(stages)``: the output), the tiles first, then each stage's
    carry CTAs — ``csrc/cascade.cu cascade_phase``'s own walk."""
    n_in = [n0]
    for P, Q, _ in stages:
        n_in.append(n_in[-1] // Q * P)
    S = len(stages)
    units = [(S, a, min(tile, n_in[S] - a)) for a in range(0, n_in[S], tile)]
    for t, (_, _, T) in enumerate(stages):
        H = T - 1
        units += [(t, n_in[t] - H + k, min(tile, H - k))
                  for k in range(0, H, tile)]
    return units


def cta_spans(stages, regs, t: int, a: int, c: int):
    """What the CTA with target ``(t, a, c)`` holds of each x_s, ``s < t``:
    ``(j0, n_j, lo, cnt, origin, top)`` — it computes outputs
    ``j0 .. j0+n_j−1`` of stage s from ``x_s[lo .. lo+cnt−1]``, its span
    starts at x index ``origin`` and its highest padded index is ``top``."""
    spans = {}
    for s in range(t - 1, -1, -1):
        P, Q, T = stages[s]
        R = regs[s]
        j0 = max(a, 0)
        n_j = max(a + c - j0, 0)
        if n_j == 0:
            spans[s] = (j0, 0, 0, 0, 0, -1)
            a, c = 0, 0
            continue
        i_lo = j0 // P
        origin = i_lo * Q - (T - 1) - SLACK
        lo = j0 * Q // P - (T - 1)
        cnt = (j0 + n_j - 1) * Q // P - lo + 1
        groups = -(-((j0 + n_j - 1) // P - i_lo + 1) // R)
        k = Q * (groups * R - 1) + ((P - 1) * Q) // P + (T - 1) + SLACK
        spans[s] = (j0, n_j, lo, cnt, origin, k + k // (Q * R))
        a, c = lo, cnt
    return spans


REGISTERS_PER_SM = 65536
REGISTERS_PER_THREAD = 64   # the kernels' __launch_bounds__(512, 2)


def ctas_per_sm(smem_bytes: int, threads: int) -> int:
    """CTAs of this size one SM holds: by shared memory, by its 2048 threads
    and by its registers."""
    return min(SM_SHARED_BYTES // (smem_bytes + CTA_RESERVED_BYTES),
               2048 // threads,
               REGISTERS_PER_SM // (REGISTERS_PER_THREAD * threads))


def _regs_for(stages, tile: int, threads: int) -> tuple:
    """Each stage's R: 2 where that still gives every thread of the CTA an
    item of the stage's work under an output tile (x is then loaded once for
    two windows), else 1."""
    counts, c = [], tile
    for P, Q, T in reversed(stages):
        counts.append(c)
        c = span_back(c, P, Q, T)
    regs = []
    for (P, _, _), c in zip(stages, reversed(counts)):
        windows = -(-c // P)
        fits = [R for R in r_choices(P)
                if -(-windows // R) * (P // n_phases(P)) >= threads]
        regs.append(max(fits, default=1))
    return tuple(regs)


@functools.lru_cache(maxsize=None)
def pick_cascade(stages, limit: int) -> Layout:
    """Tile, threads and register tiles for ``stages`` on a card whose CTA
    may take ``limit`` bytes of shared memory.

    The mix is bound by its ≈ 60 instructions a sample and the dot by its
    shared-memory loads (``csrc/chain.cu``), so the pick is about keeping an
    SM's warps many while the halo a tile re-mixes stays small: a single stage runs 256 threads a CTA
    and takes the largest tile of :data:`TILES` that leaves three CTAs on an
    SM; a cascade, whose first phase mixes many samples for few outputs, runs
    512 threads and takes the largest tile that leaves two.  Where no tile
    leaves that many, the largest that fits at all.  (``tools/kernel_sweep.py``
    times the alternatives on a card.)"""
    threads, want = (256, 3) if len(stages) == 1 else (512, 2)
    fallback = None
    for tile in TILES:
        lay = layout(stages, tile, threads, _regs_for(stages, tile, threads))
        if lay.smem_bytes > limit:
            continue
        if ctas_per_sm(lay.smem_bytes, threads) >= want:
            return lay
        fallback = fallback or lay
    if fallback is None:
        raise ValueError(
            f"stages (P, Q, T) = {stages} need more than {limit} bytes of "
            f"shared memory a CTA even for a tile of {TILES[-1]} outputs")
    return fallback


def pick_chain(P: int, Q: int, T: int, limit: int) -> Layout:
    """:func:`pick_cascade` for the one-stage chain."""
    return pick_cascade(((P, Q, T),), limit)


# -- the kernel of --precision fast (csrc/chain_fast.cu) ----------------------

FAST_WINDOWS = (128, 96, 64, 48, 32, 16)
FAST_MAX_THREADS = 256      # csrc/chain_fast.cu's __launch_bounds__(256, 3)


def fast_columns(P: int, Q: int, L: int) -> int:
    """D, the neighbouring windows a row of the chain's dot holds
    (``csrc/fast_dot.cuh``): the largest power of two with D·P ≤ 8, so that
    D·P of the mma's 8 columns hold outputs, and 16·D·Q dividing the block
    length L, so that every chunk of whole blocks holds a multiple of 16·D
    windows and the kernel's tiles fall on the stream's own grid of 16·D
    windows whatever the chunk cut; 1 where P > 4.  A function of the stage
    and the stream's block length, never of the chunk."""
    D = 1
    while 2 * D * P <= 8 and L % (32 * D * Q) == 0:
        D *= 2
    return D


@dataclasses.dataclass(frozen=True)
class FastLayout:
    """One launch of ``csrc/chain_fast.cu``: ``windows`` a CTA (a multiple of
    16·D), ``threads``, D windows a row of A, the k-steps ``ks`` and N-tiles
    ``nt``, the words ``bw`` a lane's B fragments take a k-step (4, or 2 for
    one pass), the bf16 entries of each of its ``planes`` span planes (4, or
    2 for one pass), and the word offsets of the B fragments and of the
    planes in its ``smem_bytes`` of shared memory."""
    windows: int
    threads: int
    D: int
    ks: int
    nt: int
    bw: int
    planes: int
    plane: int
    g_off: int
    x_off: int
    smem_bytes: int


def fast_pad(S: int) -> int:
    """bf16 entries after every S entries of a plane (S: a row's step, D·Q):
    8 (four words) where S ≥ 16, so that the row stride is 4 mod 8 words and
    the 8 rows of a fragment load meet 8 different 16-byte bank groups; else
    none."""
    return 8 if S >= 16 else 0


def fast_lead(T: int) -> int:
    """Band columns below the taps, ``(1 − T) mod 4``: they put span entry 0
    at an input index that is a multiple of 4, so the mix stores its groups
    of four as one 8-byte store a plane."""
    return (1 - T) % 4


def fast_dims(P: int, Q: int, T: int, D: int = 1) -> tuple:
    """A stage's k-steps ``ks`` (K = 16·ks band columns) and N-tiles ``nt``
    at D windows a row (``csrc/fast_dot.cuh fast_derive``); Q must be a
    power of two."""
    if Q & (Q - 1) or Q < 1:
        raise ValueError(f"the fast kernels need Q a power of two (Q={Q})")
    width = T + fast_lead(T) + (P - 1) * Q // P + Q * (D - 1)
    return -(-width // 16), -(-D * P // 8)


def fast_plane(span: int, S: int) -> int:
    """bf16 entries of a plane that holds a span of ``span`` entries with the
    pads of a row step S: a multiple of 8."""
    last = span - 1
    return -(-(last + fast_pad(S) * (last // S) + 1) // 8) * 8


def fast_layout(P: int, Q: int, T: int, L: int, windows: int, threads: int,
                passes: int = 3) -> FastLayout:
    """Shared-memory layout of a CTA of ``windows`` windows over blocks of L
    samples: the B fragments (``ks·nt·32`` lanes of 4·bw bytes) first, then
    the planes (I_h, I_l, Q_h, Q_l; with one pass I_h, Q_h alone), each
    holding ``Q·(windows − D) + 16·ks`` span entries with their pads."""
    D = fast_columns(P, Q, L)
    ks, nt = fast_dims(P, Q, T, D)
    if windows < 16 * D or windows % (16 * D):
        raise ValueError(f"windows {windows} must be a positive multiple of "
                         f"16·D = {16 * D}")
    if threads % 32 or not 32 <= threads <= FAST_MAX_THREADS:
        raise ValueError(f"threads {threads} must be a multiple of 32 up to "
                         f"{FAST_MAX_THREADS}")
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    bw, planes = (4, 4) if passes == 3 else (2, 2)
    plane = fast_plane(Q * (windows - D) + 16 * ks, D * Q)
    g_words = 32 * bw * ks * nt
    return FastLayout(windows, threads, D, ks, nt, bw, planes, plane, 0, g_words,
                      4 * (g_words + planes * plane // 2))


@functools.lru_cache(maxsize=None)
def pick_chain_fast(P: int, Q: int, T: int, L: int, limit: int,
                    passes: int = 3) -> FastLayout:
    """256 threads for three passes and 192 for one (the mix wants many
    warps an SM; the CTA of one pass is half the size), and the most windows
    of :data:`FAST_WINDOWS` that leave three CTAs on an SM (the exact
    chain's rule, :func:`pick_cascade`); where none does, the most that fit.
    ``tools/kernel_sweep.py --kernels fast,fast-default`` times the others."""
    D = fast_columns(P, Q, L)
    threads = FAST_MAX_THREADS if passes == 3 else 192
    fallback = None
    for windows in FAST_WINDOWS:
        if windows % (16 * D):
            continue
        lay = fast_layout(P, Q, T, L, windows, threads, passes)
        if lay.smem_bytes > limit:
            continue
        if ctas_per_sm(lay.smem_bytes, threads) >= 3:
            return lay
        fallback = fallback or lay
    if fallback is None:
        raise ValueError(f"the fast chain at P/Q/T = {P}/{Q}/{T} needs more "
                         f"than {limit} bytes of shared memory a CTA")
    return fallback


@functools.lru_cache(maxsize=None)
def fast_taps_index(P: int, Q: int, T: int, D: int, passes: int = 3):
    """Where each bf16 entry of the chain's B fragments at D windows a row
    comes from: an int64 index of ``ks·nt·32·bw·2`` entries into
    ``[t_h.flat, t_l.flat, 0]`` (the ``(P, T)`` bank's bf16 halves, then one
    zero).  Lane ``(g, q) = (lane/4, lane%4)`` of k-step s and N-tile n
    holds, as bw words of two entries each (the lower k in the low half),
    ``t_h(k0, k0+1), t_h(k0+8, k0+9)`` and, for three passes, ``t_l(k0,
    k0+1), t_l(k0+8, k0+9)``, k0 = 16s + 2q, of column c = 8n + g: phase
    p = c mod P of the window d = ⌊c/P⌋ after the row's first, G[k, (d, p)] =
    t[(p·Q) mod P, T−1 + lead + ⌊p·Q/P⌋ + Q·d − k] where that tap exists
    (``csrc/fast_dot.cuh``)."""
    import numpy as np

    ks, nt = fast_dims(P, Q, T, D)
    bw = 4 if passes == 3 else 2
    s, n, lane, w, h = np.meshgrid(np.arange(ks), np.arange(nt), np.arange(32),
                                   np.arange(bw), np.arange(2), indexing="ij")
    k = 16 * s + 2 * (lane % 4) + 8 * (w % 2) + h
    col = 8 * n + lane // 4
    d, p = col // P, col % P
    tap = T - 1 + fast_lead(T) + p * Q // P + Q * d - k
    ok = (col < D * P) & (tap >= 0) & (tap < T)
    idx = (w // 2) * P * T + (p * Q % P) * T + np.clip(tap, 0, T - 1)
    return np.where(ok, idx, 2 * P * T).reshape(-1)


# -- the cascade kernel of the bf16 dots (csrc/cascade_fast.cu) ---------------

CASCADE_FAST_WINDOWS = (512, 384, 256, 192, 160, 128, 112, 96, 80, 64, 48, 32, 16)


def cascade_fast_columns(stages, L: int) -> tuple:
    """D_s of each stage of the fast cascade (``csrc/cascade_fast.cu``):
    :func:`fast_columns` at the stage's input count a block, ``L·∏P/∏Q`` of
    the stages before it, where that is a whole number; else 1.  So D_s > 1
    only where every block holds a multiple of 16·D_s windows of the stage,
    and every chunk of whole blocks starts on the stream's own grid of
    16·D_s windows whatever its cut; a function of the stages and the block
    length, never of the chunk.  Config 3 at L = 2048: (8, 2); its f32
    blocks (L = 1024): (8, 1); the 100 Msps front: (8, 1)."""
    Ds, num, den = [], int(L), 1
    for P, Q, _ in stages:
        Ds.append(fast_columns(P, Q, num // den) if num % den == 0 else 1)
        num, den = num * P, den * Q
    return tuple(Ds)


# x_0 samples a slab holds by default, by bf16 passes: 32 KB of planes at 8
# bytes a sample (split3) or 4 (one pass, compact)
CASCADE_FAST_SLAB_SAMPLES = {3: 4096, 1: 8192}


def cascade_fast_slab(stages, L: int, passes: int = 3) -> int:
    """The stage-0 windows of a slab by default: the most whole M-tiles of
    16·D_0 windows whose inputs are at most
    :data:`CASCADE_FAST_SLAB_SAMPLES` (at least one M-tile).  512 windows at
    config 3 (1024 for one pass), 256 at the 100 Msps front."""
    (_, Q, _), m = stages[0], 16 * cascade_fast_columns(stages, L)[0]
    return max(m, CASCADE_FAST_SLAB_SAMPLES[passes] // Q // m * m)


@dataclasses.dataclass(frozen=True)
class CascadeFastLayout:
    """One launch of ``csrc/cascade_fast.cu``: ``windows`` of the last stage
    a tile CTA (a multiple of 16·D of that stage), ``threads``, ``passes``
    (3: split3, four planes; 1: default, the compact two), ``slab`` the
    stage-0 windows a CTA mixes and filters at a time (a multiple of 16·D_0),
    and per stage ``rows`` of 7 ints as the C entry point takes them, ``P,
    Q, T, D, plane, g_off, x_off`` (D windows a row of A, the bf16 entries
    of each of its span planes, the word offsets of its B fragments and of
    its planes), ``spans`` the most entries of x_s a CTA's planes hold (of
    x_0: a slab's), in ``smem_bytes`` of shared memory."""
    windows: int
    threads: int
    passes: int
    slab: int
    rows: tuple
    spans: tuple
    smem_bytes: int

    @property
    def columns(self) -> tuple:
        return tuple(row[3] for row in self.rows)


def cascade_fast_spans(stages, Ds, windows: int, slab: int) -> tuple:
    """The most entries of each x_s any CTA's planes hold
    (``csrc/cascade_fast.cu fast_span_bound``) at D_s windows a row: a tile
    CTA's last stage is ``windows`` windows; below it, and below a carry
    CTA's up to ``windows`` entries of x_t, a run of c needed outputs lies
    in ⌈(c−1)/P⌉ + 1 windows, 16·D − 1 more where its first rounds down to a
    multiple of 16·D, in whole M-tiles of 16·D; their span is Q·(rows − D) +
    16·ks entries.  x_0's planes hold a slab of at most ``slab`` windows."""
    S = len(stages)
    need = [0] * S
    for t in range(1, S + 1):
        c = windows * stages[t - 1][0] if t == S else min(windows, stages[t][2] - 1)
        if c <= 0:
            continue
        for s in range(t - 1, -1, -1):
            (P, Q, T), D = stages[s], Ds[s]
            m = 16 * D
            w = -(-(c - 1) // P) + 1
            rows = windows if (t == S and s == t - 1) else (w + 2 * m - 2) // m * m
            c = Q * (rows - D) + 16 * fast_dims(P, Q, T, D)[0]
            need[s] = max(need[s], c)
    (P, Q, T), D = stages[0], Ds[0]
    need[0] = min(need[0], Q * (slab - D) + 16 * fast_dims(P, Q, T, D)[0])
    return tuple(need)


def cascade_fast_layout(stages, L: int, windows: int, threads: int,
                        passes: int = 3, slab: int | None = None) -> CascadeFastLayout:
    """Shared-memory layout for tiles of ``windows`` last-stage windows over
    ``stages`` = ``(P, Q, T)`` each and blocks of L samples, stage 0 in
    slabs of ``slab`` windows (default :func:`cascade_fast_slab`): per stage
    its B fragments (``ks·nt·32`` lanes of 16 bytes, 8 for one pass), then
    its planes (four, two for one pass)."""
    stages = tuple(tuple(int(v) for v in st) for st in stages)
    if slab is None:
        slab = cascade_fast_slab(stages, L, passes)
    return _cascade_fast_layout(stages, int(L), int(windows), int(threads),
                                int(passes), int(slab))


@functools.lru_cache(maxsize=None)
def _cascade_fast_layout(stages, L, windows, threads, passes, slab) -> CascadeFastLayout:
    if not 1 <= len(stages) <= MAX_STAGES:
        raise ValueError(f"1 to {MAX_STAGES} stages")
    Ds = cascade_fast_columns(stages, L)
    if windows < 16 * Ds[-1] or windows % (16 * Ds[-1]):
        raise ValueError(f"windows {windows} must be a positive multiple of "
                         f"16·D = {16 * Ds[-1]}")
    if slab < 16 * Ds[0] or slab % (16 * Ds[0]):
        raise ValueError(f"slab {slab} must be a positive multiple of 16·D_0 = "
                         f"{16 * Ds[0]}")
    if threads % 32 or not 32 <= threads <= FAST_MAX_THREADS:
        raise ValueError(f"threads {threads} must be a multiple of 32 up to "
                         f"{FAST_MAX_THREADS}")
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    bw, planes = (4, 4) if passes == 3 else (2, 2)
    spans = cascade_fast_spans(stages, Ds, windows, slab)
    rows, off = [], 0
    for (P, Q, T), D, span in zip(stages, Ds, spans):
        ks, nt = fast_dims(P, Q, T, D)
        plane = fast_plane(span, D * Q)
        g_words = 32 * bw * ks * nt
        rows.append((P, Q, T, D, plane, off, off + g_words))
        off += g_words + planes * plane // 2
    return CascadeFastLayout(windows, threads, passes, slab, tuple(rows), spans,
                             4 * off)


@functools.lru_cache(maxsize=None)
def pick_cascade_fast(stages, L: int, limit: int, passes: int = 3,
                      max_windows: int | None = None) -> CascadeFastLayout:
    """256 threads, the default slab (:func:`cascade_fast_slab`), and the
    most windows of :data:`CASCADE_FAST_WINDOWS` (those that are multiples
    of 16·D of the last stage, and at most ``max_windows`` where that is
    given, but at least the smallest) that leave three CTAs on an SM by
    their shared memory, else two, else the most that fit: 256 windows at
    config 3, 512 for one pass, on a large chunk.  The wrapper caps the
    tile so that a chunk gives the card three tiles an SM (a chunk of 256
    blocks at config 3: 32 windows).  ``tools/kernel_sweep.py --kernels
    cascade-fast,cascade-fast-default`` times the others."""
    D = cascade_fast_columns(stages, L)[-1]
    sizes = [w for w in CASCADE_FAST_WINDOWS if w % (16 * D) == 0]
    if max_windows is not None:
        sizes = [w for w in sizes if w <= max_windows] or sizes[-1:]
    lays = [cascade_fast_layout(stages, L, w, FAST_MAX_THREADS, passes)
            for w in sizes]
    for want in (3, 2, 1):
        for lay in lays:
            if (lay.smem_bytes <= limit
                    and ctas_per_sm(lay.smem_bytes, FAST_MAX_THREADS) >= want):
                return lay
    raise ValueError(f"the fast cascade {stages} needs more than {limit} bytes "
                     "of shared memory a CTA")


def check_cascade_fast_chunk(stages, B: int, L: int) -> None:
    """Raise unless every stage's window count in a ``(B, L)`` chunk (its
    chunk input count / Q) is a multiple of 16: the fast cascade's M-tiles
    start at multiples of 16·D_s windows of each stage's chunk-local grid,
    which is then the stream's absolute grid mod 16·D_s in any cut of the
    stream into such chunks, so an output sits in the same row and column of
    its mma whatever the cut (``csrc/cascade_fast.cu``, "Bytes").  Where
    D_s > 1 (:func:`cascade_fast_columns`) every block already holds a
    multiple of 16·D_s windows; where D_s = 1 this is the whole rule, the
    one the kernel had before D_s, so no chunk it took is refused."""
    n = B * L
    for s, (P, Q, _) in enumerate(stages):
        if n % (16 * Q):
            raise ValueError(
                f"the fast cascade needs every stage's chunk input count to be "
                f"a multiple of 16·Q; stage {s} (Q={Q}) gets {n} samples from a "
                f"chunk of {B}×{L}")
        n = n // Q * P


def fast_cta_units(stages, n0: int, windows: int):
    """The CTAs of ``csrc/cascade_fast.cu`` as ``(t, a, c)``: entries
    ``a .. a+c−1`` of x_t (``t = len(stages)``: the output), the tiles of
    ``windows`` last-stage windows first, then each stage's carry CTAs of up
    to ``windows`` entries — ``fast_cascade_plan``'s own walk."""
    n_in = [n0]
    for P, Q, _ in stages:
        n_in.append(n_in[-1] // Q * P)
    S, P = len(stages), stages[-1][0]
    units = [(S, a, min(windows * P, n_in[S] - a))
             for a in range(0, n_in[S], windows * P)]
    for t, (_, _, T) in enumerate(stages):
        H = T - 1
        units += [(t, n_in[t] - H + k, min(windows, H - k))
                  for k in range(0, H, windows)]
    return units


def fast_cta_spans(stages, Ds, n0: int, t: int, a: int, c: int):
    """What the CTA with target ``(t, a, c)`` computes of each stage
    ``s < t`` at D_s windows a row (``fast_cascade_plan``): ``(ja, jb, w0,
    rows, org, len)`` — it keeps outputs ``ja .. jb`` of stage s, computes
    ``rows`` windows from ``w0`` (both multiples of 16·D_s) and reads ``len``
    entries of x_s from index ``org``."""
    n_in = [n0]
    for P, Q, _ in stages:
        n_in.append(n_in[-1] // Q * P)
    spans = {}
    ja, jb = max(a, 0), a + c - 1
    for s in range(t - 1, -1, -1):
        (P, Q, T), D = stages[s], Ds[s]
        if jb < ja:
            spans[s] = (ja, jb, 0, 0, 0, 0)
            continue
        m = 16 * D
        w0 = ja // P // m * m
        rows = (jb // P - w0 + m) // m * m
        org = w0 * Q - (T - 1) - fast_lead(T)
        length = Q * (rows - D) + 16 * fast_dims(P, Q, T, D)[0]
        spans[s] = (ja, jb, w0, rows, org, length)
        ja, jb = max(org, 0), min(org + length, n_in[s]) - 1
    return spans


def cascade_fast_nan_reach(stages, Ds, n0: int, nan_at) -> set:
    """The outputs of the fast cascade that a NaN at chunk input indices
    ``nan_at`` may reach, by ``csrc/cascade_fast.cu``'s statement ("NaN"):
    at every stage, all D·P outputs of each row whose band of K entries,
    x[Q·D·r − (T−1) − lead + k], holds one.  The indices of the last
    stage's outputs (of ``n0`` inputs), as a set."""
    import numpy as np

    bad = np.zeros(n0, dtype=bool)
    bad[list(nan_at)] = True
    for (P, Q, T), D in zip(stages, Ds):
        K = 16 * fast_dims(P, Q, T, D)[0]
        lo = T - 1 + fast_lead(T)
        rows = np.zeros(len(bad) // (Q * D), dtype=bool)
        for n in np.flatnonzero(bad):
            # rows r with Q·D·r − lo ≤ n ≤ Q·D·r − lo + K − 1
            rows[max(0, -(-(n + lo - K + 1) // (Q * D))):(n + lo) // (Q * D) + 1] = True
        bad = np.repeat(rows, D * P)
    return set(np.flatnonzero(bad).tolist())
