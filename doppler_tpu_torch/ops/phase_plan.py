"""Host-side NCO phase planning: samplenum emulation → per-block (D, C, t).

The reference's mutable NCO state is a single counter with a reset quirk
(``src/dsp.rs:125-130``; see ``ops.nco`` for the taxonomy of resets).  This
module runs that counter **on the host, exactly**, and compiles its effect
into the per-block constants the stateless device kernel consumes:

    phase(local j) = (j·D_b + C_b(j)) / 2^64 cycles,
    C_b(j) = C1_b  for j <  t_b   (samplenum continuing from prior blocks)
           = C2_b  for j >= t_b   (samplenum restarted at the block's first
                                    reset; t_b = reset position + 1)

Only the *first* reset per block gets an offset switch: subsequent resets
within a block are necessarily exact-periodic (the rounding kind needs
samplenum ≳ 2·10^4, far beyond one block after a restart) and exact resets
are phase-preserving to < 2^-40 cycles under the Q0.64 representation, so a
single segment switch reproduces the reference's emitted phase to well below
its own f32 noise floor.

Reset detection mirrors the reference bit-for-bit — ``f32(f32(ratio) ·
f32(n)) fract == 0`` — but is *predicted analytically* in O(polylog) per
block (:func:`_first_reset_analytic`): the f32 ratio is a dyadic rational
P/2^s, so "the product rounds to an integer" is an integer residue-window
condition solved with a Euclid-style recursion, valid for any counter value
(no 2^24 cliff, no O(count) mask scan).  ``reset_quirk=False`` skips the
quirk entirely and uses pure absolute-index phase (cleaner output).

The counter is u32 in the reference and wraps in release builds; the state
tracks it mod 2^32.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Sequence

import numpy as np

from doppler_tpu_torch.ops import fixedpoint as fxp

_log = logging.getLogger("doppler_tpu_torch.plan")
_multi_reset_warned: set = set()


def _warn_multi_reset(r32: np.float32, block_len: int) -> None:
    """Once-per-ratio operator notice that a block spans more than one
    offset-changing reset (see the multi-reset policy note): the tail
    phase degrades by a ulp-class bound per missed restart."""
    key = float(r32)
    if key in _multi_reset_warned:
        return
    _multi_reset_warned.add(key)
    _log.warning(
        "block length %d spans more than one samplenum rounding reset at "
        "ratio %.9g: in-block phase past the first reset degrades by "
        "~ulp(r*n)/2 cycles per missed restart (exact counter re-anchors "
        "each block) — reduce --block-bytes for full reset fidelity",
        block_len, key)

__all__ = ["NCOState", "BlockPlan", "plan_blocks", "plan_fields_uniform",
           "plan_fields_periodic", "rate_constants", "const_lane"]

_M64 = (1 << 64) - 1


@dataclass
class NCOState:
    """The reference's entire mutable DSP state (SURVEY §5 checkpointing):
    the samplenum counter plus the absolute stream offset.

    ``hunt`` is a derived, non-checkpointed reset-hunt cache
    ``(r32_key, lo, hi, first_reset_value_or_None)``: the smallest counter
    value in ``[lo, hi)`` whose f32 product test fires, for the cached ratio.
    Because the reset condition depends only on the counter *value*, the cache
    survives resets, checkpoint restores recompute it, and steady-state chunks
    plan with zero analytic hunts (VERDICT r2 #6)."""

    samplenum: int = 0
    abs_offset: int = 0
    hunt: tuple | None = field(default=None, repr=False, compare=False)


@dataclass
class BlockPlan:
    """Device-ready plan arrays for one chunk of B blocks (all uint32)."""

    d_hi: np.ndarray
    d_lo: np.ndarray
    c1_hi: np.ndarray
    c1_lo: np.ndarray
    c2_hi: np.ndarray
    c2_lo: np.ndarray
    t: np.ndarray

    @classmethod
    def zeros(cls, n: int) -> "BlockPlan":
        z = lambda: np.zeros(n, dtype=np.uint32)  # noqa: E731
        return cls(z(), z(), z(), z(), z(), z(), z())

    @classmethod
    def from_rows(cls, rows: list) -> "BlockPlan":
        """rows: [(d, c1, c2, t), ...] python ints → bulk uint32 arrays."""
        m = 0xFFFFFFFF
        arr = np.array(
            [(d >> 32, d & m, c1 >> 32, c1 & m, c2 >> 32, c2 & m, t)
             for d, c1, c2, t in rows],
            dtype=np.uint64,
        ).astype(np.uint32).reshape(-1, 7)
        return cls(*(arr[:, i].copy() for i in range(7)))

    def set(self, k: int, d: int, c1: int, c2: int, t: int) -> None:
        self.d_hi[k], self.d_lo[k] = fxp.split_u64(d)
        self.c1_hi[k], self.c1_lo[k] = fxp.split_u64(c1)
        self.c2_hi[k], self.c2_lo[k] = fxp.split_u64(c2)
        self.t[k] = t


def _ratio_f32(shift_hz: float, samplerate: int) -> np.float32:
    return np.float32(np.float32(shift_hz) / np.float32(samplerate))


def _first_reset_scan(r32: np.float32, m0: int, count: int) -> int | None:
    """O(count) vectorized mirror of dsp.rs:125-130 — the fuzz oracle.

    Reset fires at local j when ``fract(f32(r32 · f32(m0 + j))) == 0``.
    """
    if count == 0:
        return None
    n = np.arange(m0, m0 + count, dtype=np.float64).astype(np.float32)
    prod = np.float32(r32) * n           # f32 elementwise product
    frac = prod - np.trunc(prod)         # Rust fract(): toward-zero remainder
    hits = np.nonzero(frac == np.float32(0.0))[0]
    return int(hits[0]) if hits.size else None


def _is_reset(r32: np.float32, n: int) -> bool:
    """Scalar f32 ground truth for one counter value (verifies candidates)."""
    prod = np.float32(r32) * np.float64(n).astype(np.float32)
    return bool(prod - np.trunc(prod) == np.float32(0.0))


def _min_affine(a: int, b: int, m: int, R: int) -> int | None:
    """Minimal k ≥ 0 with ``(a·k + b) mod m ≤ R`` — Euclid-style O(log m).

    The workhorse of the analytic reset predictor: "when does the phase
    residue next land inside the half-ulp window".  Each level reduces the
    modulus like the Euclidean algorithm (m, a) → (a, (−m) mod a), so the
    depth is O(log m) even for m = 2⁵³.
    """
    a %= m
    b %= m
    if b <= R:
        return 0
    if a == 0:
        return None
    if 2 * a > m:
        # reflect: (a·k + b) mod m ≤ R ⟺ ((m−a)·k + (R−b)) mod m ≤ R,
        # so the multiplier always halves and the recursion depth is O(log m)
        return _min_affine(m - a, (R - b) % m, m, R)
    # need c ≥ 1 wraps: a·k ∈ [c·m − b, c·m − b + R] for minimal c, i.e.
    # ((b − m) − (c−1)·m) mod a ≤ R — the same problem one level down
    c1 = _min_affine((-m) % a, (b - m) % a, a, R)
    if c1 is None:
        return None
    c = 1 + c1
    return -((-(c * m - b)) // a)        # ceil((c·m − b)/a)


def _first_reset_analytic(r32: np.float32, m0: int, count: int) -> int | None:
    """O(polylog) twin of :func:`_first_reset_scan` — exact, any counter size.

    Write |r32| = P·2⁻ˢ with P odd (every finite f32 is a dyadic rational)
    and n' = f32(n) = M·2ᵍ on the binade's mantissa grid.  The product the
    reference tests is then exactly x = P·M·2^{g−s}, and ``fract(f32(x))==0``
    iff x lies within half an ulp of an integer — an integer condition
    ``(P·2ᵍ·M mod 2ˢ) ∈ [−H, H]`` with H = 2^{E−24+s} fixed per binade
    E = ⌊log₂ x⌋.  Per (n-binade × x-binade) segment that minimal M is one
    :func:`_min_affine` call; candidates sitting exactly on the half-ulp
    boundary (ties, round-to-nearest-even) are verified against the scalar
    f32 expression and skipped if they round away.  Replaces the O(count)
    mask scan in the ≥2²⁴-counter regime (VERDICT r1 "kill the O(samples)
    plan scan"); fuzzed against the scan and the native sequential loop in
    tests/test_phase_plan_analytic.py.
    """
    if count <= 0:
        return None
    if m0 == 0:
        return 0                          # fract(±0·r) == 0 always fires
    r = float(np.float32(r32))
    if r == 0.0 or not np.isfinite(r):
        return 0                          # prod ≡ ±0 (or NaN never equals 0)
    fr, e = np.frexp(abs(r))              # |r| = fr·2^e, fr ∈ [0.5, 1)
    P = int(fr * (1 << 53))               # exact: f32 → ≤24 significant bits
    tz = (P & -P).bit_length() - 1
    P >>= tz
    s = 53 - int(e) - tz                  # |r| = P / 2^s, P odd
    n_end = m0 + count                    # exclusive

    n = m0
    while n < n_end:
        # n-binade [2^k, 2^{k+1}): f32(n) lives on the grid 2^g
        k = n.bit_length() - 1
        g = max(0, k - 23)
        bin_end = min(1 << (k + 1), n_end)
        # M range for this binade (M = f32(n)/2^g, round-half-even)
        M_lo = (n + (1 << g) // 2) >> g if g else n
        if g and ((n + (1 << g) // 2) % (1 << g) == 0) and (M_lo & 1):
            M_lo -= 1                     # n is a tie rounding down to even
        M_hi = (bin_end - 1 + (1 << g) // 2) >> g if g else bin_end - 1
        M = M_lo
        while M <= M_hi:
            # x-binade split: E = ⌊log₂(P·M·2^{g−s})⌋ is constant until P·M
            # crosses a power of two
            pm_bits = (P * M).bit_length()
            E = pm_bits - 1 + g - s
            M_seg_hi = min(M_hi, ((1 << pm_bits) - 1) // P)
            if E >= 23:
                # ulp ≥ 1: every f32 at this magnitude is an integer
                cand_M = M
            else:
                Hnum = E - 24 + s - g     # window: |P·M mod± 2^{s−g}| ≤ 2^Hnum
                mod = 1 << max(0, s - g)
                if mod == 1:
                    cand_M = M            # x always a true integer
                elif Hnum < 0:
                    # window < 1: only exact multiples hit; P odd ⇒ 2^{s−g}|M
                    step = mod
                    cand_M = ((M + step - 1) // step) * step
                    if cand_M > M_seg_hi:
                        M = M_seg_hi + 1
                        continue
                else:
                    H = 1 << Hnum
                    A = P % mod
                    kk = _min_affine(A, (A * M + H) % mod, mod, 2 * H)
                    if kk is None or M + kk > M_seg_hi:
                        M = M_seg_hi + 1
                        continue
                    cand_M = M + kk
            # smallest n ≥ current position whose f32 is cand_M·2^g
            if g:
                half = 1 << (g - 1)
                lo_n = cand_M * (1 << g) - half
                if (cand_M & 1):          # odd target: tie rounds away
                    lo_n += 1
                cand_n = max(n, lo_n)
            else:
                cand_n = cand_M
            if cand_n >= n_end:
                return None
            if _is_reset(r32, cand_n):
                return cand_n - m0
            # tie rounded away — resume just past the candidate
            M = cand_M + 1
        n = bin_end
    return None


def _exact_period(r32: np.float32) -> int | None:
    """Denominator q of the (dyadic) f32 ratio: r·n is a true integer iff
    q | n.  Returns None for q too large to matter within a block run."""
    fr = Fraction(float(r32)).limit_denominator(1 << 62)
    q = fr.denominator
    return q if q <= (1 << 31) else None


def _state_after_run(r32: np.float32, v: int, count: int) -> int:
    """samplenum after processing ``count`` samples starting at value ``v``.

    Trajectory: n increments from v; resets to 1 at each j where
    fract(r·n)==0.  Uses the exact-period closed form when the ratio's dyadic
    period q fits in the remaining run (avoiding O(count/q) scans); otherwise
    re-scans from the restarted counter — rounding resets are rare, so the
    loop runs at most a couple of iterations.
    """
    remaining = count
    while remaining > 0:
        j = _first_reset_analytic(r32, v, remaining)
        if j is None:
            return (v + remaining) % (1 << 32)
        remaining -= j + 1        # samples left after the reset fires
        v = 1
        q = _exact_period(r32)
        if (q is not None and q <= remaining
                and abs(float(r32)) * q < _exact_only_bound(r32, q)):
            # periodic from here: counter cycles 1..q → (rem mod q) + 1.
            # Valid ONLY in the exact-only regime (counters stay ≤ q, so
            # |r·n| never reaches the rounding-reset threshold) — round-5
            # review find: without the bound, a ROUNDING firing below q
            # from the restarted counter broke the periodicity and the
            # shortcut silently carried a wrong samplenum (repro:
            # fs=1024000, shift≈327843.76, L=65536 → 32768 vs the
            # reference loop's 1518).  Outside the regime the loop
            # continues — firings are sparse there, so it stays O(events).
            return remaining % q + 1
    return v % (1 << 32)


def _exact_only_bound(r32: np.float32, q: int) -> float:
    """Largest |r·n| below which only *exact* resets can fire.

    With r = p/q exactly (f32 values are dyadic rationals), non-multiples of
    q sit ≥ 1/q from the integers, so a rounding reset needs
    ulp(r·n)/2 ≥ 1/q ⟺ |r·n| ≳ 2^23/q.  Stay a factor 2 under.
    """
    return (1 << 22) / q


def _state_after_run_exact(m0: int, count: int, q: int) -> int:
    """Closed-form counter evolution when every reset is exact-periodic."""
    j0 = (-m0) % q          # first local index whose counter is ≡ 0 (mod q)
    if j0 >= count:
        return (m0 + count) % (1 << 32)
    rem = count - 1 - j0
    return rem % q + 1


# Multi-reset blocks — the representation policy (round-5 review find).
#
# The per-block device constants carry ONE offset-changing segment switch
# (C1 → C2 at t).  A block can contain a SECOND rounding reset — common at
# large --block-bytes (the steady-state reset spacing is ~sqrt(2²⁵/r)
# samples, so 64Ki-sample blocks span several), and possible even at the
# reference's own 2048-sample framing.  The policy:
#
# - the COUNTER state is always evolved exactly (``_state_after_run`` walks
#   every firing), so the next block re-anchors to the true samplenum and
#   track-mode shift changes stay faithful (the erratum's divergence mode
#   cannot occur);
# - within the multi-reset block's tail, each un-encoded restart shifts the
#   emitted phase by |frac_true(r·n_fire)| ≤ ulp(r·n_fire)/2 CYCLES — by
#   the firing condition itself, the same magnitude class as the
#   reference's OWN f32 product noise at that counter (SURVEY §3.4).  The
#   offsets ACCUMULATE across missed restarts, so fidelity degrades
#   gracefully with block length: at the reference's own ≤2048-sample
#   framing a block rarely spans even two restarts; a 64Ki-sample block
#   can span ~10 (measured ≈46-50 dB on an adversarial ratio — pinned with
#   the derived k·ulp/2 bound by tests/test_phase_plan_analytic.py::
#   test_multi_reset_block_phase_bound).  Operators pushing --block-bytes
#   far past the reference framing trade phase fidelity on
#   rounding-reset-heavy ratios for DMA efficiency.
#
# ``_offset_changing_within`` locates such restarts for tests/diagnostics.


def _offset_changing_within(r32: np.float32, q: int | None,
                            after: int) -> int | None:
    """First ROUNDING (offset-changing) reset within ``after`` samples of a
    freshly restarted (v=1) counter, or None.

    Exact-periodic firings (counter ≡ 0 mod q) preserve the emitted affine
    phase — ``frac(r·(n+q)) = frac(r·n)`` when ``r·q`` is a true integer —
    so they need no extra segment; a ROUNDING firing restarts the phase
    reference with a ≤ ulp/2-cycle offset the single in-block switch cannot
    encode (see the policy note above).  Returns the local index of the
    firing when one exists.
    """
    if after <= 0:
        return None
    if (q is not None
            and abs(float(r32)) * min(q, after) < _exact_only_bound(r32, q)):
        return None               # exact-only regime: no rounding firing
    rem = after
    off = 0
    while rem > 0:
        j = _first_reset_analytic(r32, 1, rem)
        if j is None:
            return None
        if q is None or (j + 1) % q != 0:
            return off + j        # rounding firing: offset-changing
        off += j + 1              # exact firing: phase-preserving, continue
        rem -= j + 1
    return None


def _plan_blocks_sequential(
    shifts_hz: Sequence[float],
    counts: Sequence[int],
    samplerate: int,
    state: NCOState,
    block_len: int,
    *,
    quantize_f32: bool = True,
    reset_quirk: bool = True,
    fast_path: bool = True,
) -> BlockPlan:
    """Per-block reference planner — the fuzz oracle for :func:`plan_blocks`.

    O(B) Python iterations with up to two analytic hunts per block; the
    vectorized :func:`plan_blocks` must reproduce its rows and state evolution
    exactly (tests/test_phase_plan_analytic.py fuzzes the pair).
    """
    rows: list = []
    period_cache: dict[float, int | None] = {}
    rate_cache: dict[float, tuple[int, np.float32]] = {}
    for s_hz, count in zip(shifts_hz, counts):
        skey = float(s_hz)
        if skey not in rate_cache:
            rate_cache[skey] = (
                fxp.rate_to_q64(s_hz, samplerate, quantize_f32=quantize_f32),
                _ratio_f32(s_hz, samplerate),
            )
        d, r32_cached = rate_cache[skey]
        if not reset_quirk:
            c1 = (state.abs_offset * d) % (1 << 64)
            rows.append((d, c1, c1, block_len))
            state.abs_offset += count
            state.samplenum = state.abs_offset
            continue

        r32 = r32_cached
        m0 = state.samplenum

        if fast_path:
            key = float(r32)
            if key not in period_cache:
                period_cache[key] = _exact_period(r32)
            q = period_cache[key]
            n_hi = m0 + count
            if (
                q is not None
                and q <= (1 << 20)
                and n_hi <= (1 << 24)
                and abs(float(r32)) * n_hi < _exact_only_bound(r32, q)
            ):
                # exact-only regime: resets are phase-preserving, so the
                # absolute counter phase is faithful with no segment switch
                c1 = (m0 * d) % (1 << 64)
                rows.append((d, c1, c1, block_len))
                state.samplenum = _state_after_run_exact(m0, count, q)
                state.abs_offset += count
                continue

        c1 = (m0 * d) % (1 << 64)
        j0 = _first_reset_analytic(r32, m0, count)
        if j0 is None:
            rows.append((d, c1, c1, block_len))
        else:
            # segment 2: samplenum restarts at 1 for local index j0+1,
            # i.e. n_eff(j) = j - j0  →  C2 = (−j0 · D) mod 2^64.  A
            # further rounding restart inside this block is NOT encoded
            # (single switch) — see the multi-reset policy note above:
            # ≤ ulp/2-cycle phase offset in the tail, exact state below.
            c2 = (-j0 * d) % (1 << 64)
            rows.append((d, c1, c2, j0 + 1))
        state.samplenum = _state_after_run(r32, m0, count)
        state.abs_offset += count
    return BlockPlan.from_rows(rows)


_U32 = 1 << 32

_steady_period_cache: dict[float, int | None] = {}


def _steady_period(r32: np.float32, block_len: int) -> int | None:
    """Smallest firing counter value ≥ 1 (or None if none below 2³²+L).

    After any reset the counter restarts at 1, so the trajectory is exactly
    periodic: it climbs 1..r₁, fires at value r₁, restarts — one hunt makes
    every subsequent reset position closed-form.  Keyed by the f32 ratio
    (a pure counter-value property), shared across channels and chunks.
    """
    key = float(r32)
    if key not in _steady_period_cache:
        j = _first_reset_analytic(r32, 1, _U32 + block_len - 1)
        _steady_period_cache[key] = None if j is None else 1 + j
    return _steady_period_cache[key]


def _cached_first_reset(r32: np.float32, m0: int, span: int,
                        state: NCOState, block_len: int) -> int | None:
    """First reset offset in ``[m0, m0+span)`` via the state's hunt cache.

    The cache stores the smallest firing counter *value* over a long horizon
    ``[lo, hi)`` for one ratio, so repeated chunks of the same stream re-plan
    with an O(1) range check instead of an analytic hunt; a miss hunts once to
    beyond the u32 wrap (the hunt cost is polylog in span) and refills it.
    """
    key = float(r32)
    hi_goal = _U32 + block_len          # covers the last block's overshoot
    # no-hunt shortcut: r₁ is the smallest firing value ≥ 1, so any counter
    # on the post-reset trajectory (1 ≤ m0 ≤ r₁) meets its first firing at
    # exactly r₁ — closed form, no analytic work (the steady state for every
    # huge-q ratio; VERDICT r2 #6)
    r1 = _steady_period(r32, block_len)
    if r1 is not None and 1 <= m0 <= r1:
        j = r1 - m0
        return j if j < span else None
    c = state.hunt
    if c is not None and c[0] == key and c[1] <= m0 and m0 + span <= c[2]:
        hit = c[3]
        if hit is None or hit >= m0 + span:
            return None
        if hit >= m0:
            return hit - m0
        # cache's smallest hit is behind m0 — fall through and rehunt
    j = _first_reset_analytic(r32, m0, hi_goal - m0)
    state.hunt = (key, m0, hi_goal, None if j is None else m0 + j)
    if j is None or j >= span:
        return None
    return j


def plan_blocks(
    shifts_hz: Sequence[float],
    counts: Sequence[int],
    samplerate: int,
    state: NCOState,
    block_len: int,
    *,
    quantize_f32: bool = True,
    reset_quirk: bool = True,
    fast_path: bool = True,
) -> BlockPlan:
    """Compile per-block shifts + the running samplenum into kernel constants.

    ``counts[k]`` is the true sample count of block k (≤ block_len; only the
    final block may be short).  Advances ``state`` in place.

    Vectorized over *runs* of consecutive equal shifts (VERDICT r2 #6 — the
    config-5 host planner must scale to C=256 × B=2048): per run the planner
    emits whole reset-free stretches with NumPy u64 arithmetic and touches
    Python-level math only at reset *events*, which the counter-value hunt
    cache on ``state`` makes amortized-free across chunks.  Row-for-row and
    state-for-state identical to :func:`_plan_blocks_sequential`:

    - exact-periodic regime (small dyadic period q, counter ≤ 2²⁴, inside the
      rounding-free bound): closed-form counters
      ``m(c) = m0+c  (c ≤ j0)  |  ((c−j0−1) mod q)+1  (c > j0)`` over the
      longest prefix where the regime condition holds per block;
    - otherwise: one hunt per stretch instead of per block — the first reset
      over the remaining run locates the single block that needs a segment
      switch; everything before it is plain ``C = m_k·D``.

    u32 counter wrap is honored at block boundaries exactly like the
    sequential planner (stretches never start a block at an unwrapped
    counter ≥ 2³²; in-block overshoot past 2³² stays unwrapped).
    """
    nblk = len(counts)
    if nblk == 0:
        return BlockPlan.zeros(0)
    counts_a = np.asarray(counts, dtype=np.int64)
    shifts_a = np.asarray(shifts_hz, dtype=np.float64)
    total = int(counts_a.sum())

    uniq, inv = np.unique(shifts_a, return_inverse=True)
    d_u = [fxp.rate_to_q64(float(s), samplerate, quantize_f32=quantize_f32)
           for s in uniq]
    r_u = [_ratio_f32(float(s), samplerate) for s in uniq]

    D = np.zeros(nblk, np.uint64)
    C1 = np.zeros(nblk, np.uint64)
    C2 = np.zeros(nblk, np.uint64)
    T = np.full(nblk, block_len, np.uint32)

    if not reset_quirk:
        d_per = np.asarray(d_u, np.uint64)[inv]
        offs = state.abs_offset + np.concatenate(
            [[0], np.cumsum(counts_a)[:-1]])
        D[:] = d_per
        with np.errstate(over="ignore"):
            C1[:] = offs.astype(np.uint64) * d_per
        C2[:] = C1
        state.abs_offset += total
        state.samplenum = state.abs_offset
        return _plan_from_u64(D, C1, C2, T)

    # run boundaries: consecutive blocks sharing one shift value
    change = np.flatnonzero(np.diff(inv)) + 1
    bounds = np.concatenate([[0], change, [nblk]])
    period_cache: dict[float, int | None] = {}

    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        u = int(inv[b0])
        d = d_u[u]
        r32 = r_u[u]
        key = float(r32)
        if key not in period_cache:
            period_cache[key] = _exact_period(r32)
        q = period_cache[key]
        d64 = np.uint64(d)
        rc = counts_a[b0:b1]
        cum = np.concatenate([[0], np.cumsum(rc)])
        n = b1 - b0
        k = 0
        while k < n:
            m0 = state.samplenum
            starts = cum[k:n] - cum[k]
            ends = cum[k + 1:n + 1] - cum[k]

            if fast_path and q is not None and q <= (1 << 20):
                j0 = (-m0) % q
                m_k = np.where(starts <= j0, m0 + starts,
                               (starts - j0 - 1) % q + 1)
                n_hi = m_k + rc[k:]
                ok = (n_hi <= (1 << 24)) & (
                    abs(float(r32)) * n_hi < _exact_only_bound(r32, q))
                v = int(np.argmin(ok)) if not ok.all() else n - k
                if v == 0 and not bool(ok[0]):
                    pass                     # first block out of regime
                elif v > 0:
                    sl = slice(b0 + k, b0 + k + v)
                    with np.errstate(over="ignore"):
                        c1v = m_k[:v].astype(np.uint64) * d64
                    D[sl] = d64
                    C1[sl] = c1v
                    C2[sl] = c1v
                    c_end = int(ends[v - 1])
                    state.samplenum = (
                        m0 + c_end if c_end <= j0
                        else (c_end - j0 - 1) % q + 1
                    )
                    k += v
                    continue

            # event-driven stretch: all blocks whose (unwrapped) start
            # counter stays below the u32 boundary
            nb = int(np.searchsorted(starts, _U32 - m0, side="left"))
            nb = max(1, min(nb, n - k))
            span = int(ends[nb - 1])
            j = _cached_first_reset(r32, m0, span, state, block_len)
            if j is None:
                sl = slice(b0 + k, b0 + k + nb)
                with np.errstate(over="ignore"):
                    c1v = (m0 + starts[:nb]).astype(np.uint64) * d64
                D[sl] = d64
                C1[sl] = c1v
                C2[sl] = c1v
                state.samplenum = (m0 + span) % _U32
                k += nb
            else:
                kb = int(np.searchsorted(ends[:nb], j, side="right"))
                if kb > 0:
                    sl = slice(b0 + k, b0 + k + kb)
                    with np.errstate(over="ignore"):
                        c1v = (m0 + starts[:kb]).astype(np.uint64) * d64
                    D[sl] = d64
                    C1[sl] = c1v
                    C2[sl] = c1v
                m_kb = m0 + int(starts[kb])
                jb = j - int(starts[kb])
                i = b0 + k + kb
                D[i] = d64
                C1[i] = np.uint64((m_kb * d) % (1 << 64))
                C2[i] = np.uint64((-jb * d) % (1 << 64))
                T[i] = jb + 1
                if q is None or q > max(1 << 20, block_len):
                    # post-reset the trajectory is exactly periodic with
                    # period r₁: when q is huge the sequential planner's
                    # per-block fast path can't engage (q > 2²⁰) and
                    # ``_state_after_run``'s exact-period fast-forward can't
                    # trigger (q > any in-block remaining), so its state
                    # evolution IS the pure trajectory — finish the whole
                    # stretch closed-form: counters, reset blocks, and
                    # segment switches all vectorize (config-5 rates fire
                    # rounding resets every ~10⁵ samples; per-event Python
                    # would be O(B) hunts per chunk)
                    r1 = _steady_period(r32, block_len)
                    p0 = j                     # stretch-local reset position
                    s2 = starts[kb + 1:nb]
                    e2 = ends[kb + 1:nb]
                    if r1 is not None and (
                            int(rc[k + kb]) - jb - 1 >= r1):
                        _warn_multi_reset(r32, block_len)
                    if r1 is None:
                        m_k2 = s2 - p0         # counter climbs unbounded
                        with np.errstate(over="ignore"):
                            c1v = m_k2.astype(np.uint64) * d64
                        sl = slice(b0 + k + kb + 1, b0 + k + nb)
                        D[sl] = d64
                        C1[sl] = c1v
                        C2[sl] = c1v
                        state.samplenum = (span - p0) % _U32
                    else:
                        m_k2 = (s2 - p0 - 1) % r1 + 1
                        j0_k = r1 - m_k2
                        hit = j0_k < (e2 - s2)
                        # second+ restarts per block stay un-encoded (the
                        # multi-reset policy note); counters remain exact
                        # via the r1-periodic closed form
                        if bool(np.any(j0_k + np.int64(r1) < (e2 - s2))):
                            _warn_multi_reset(r32, block_len)
                        with np.errstate(over="ignore"):
                            c1v = m_k2.astype(np.uint64) * d64
                            c2v = np.where(
                                hit,
                                (np.uint64(0) - j0_k.astype(np.uint64)) * d64,
                                c1v,
                            )
                        sl = slice(b0 + k + kb + 1, b0 + k + nb)
                        D[sl] = d64
                        C1[sl] = c1v
                        C2[sl] = c2v
                        T[sl] = np.where(hit, j0_k + 1,
                                         block_len).astype(np.uint32)
                        state.samplenum = (span - p0 - 1) % r1 + 1
                    k += nb
                else:
                    if (block_len > 8192
                            and float(r32) not in _multi_reset_warned
                            and _offset_changing_within(
                                r32, q, int(rc[k + kb]) - jb - 1)
                            is not None):
                        _warn_multi_reset(r32, block_len)
                    state.samplenum = _state_after_run(
                        r32, m_kb, int(rc[k + kb]))
                    k += kb + 1

    state.abs_offset += total
    return _plan_from_u64(D, C1, C2, T)


def plan_fields_uniform(
    shifts_c: Sequence[float],
    counts: Sequence[int],
    samplerate: int,
    states: Sequence[NCOState],
    block_len: int,
    *,
    quantize_f32: bool = True,
    reset_quirk: bool = True,
) -> tuple[np.ndarray, list[int]]:
    """Batched planner for C channels sharing one chunk's block structure.

    ``shifts_c[c]`` is channel c's (constant within the chunk) shift;
    returns the stacked ``(7, C, B)`` uint32 plan fields in
    ``(d_hi, d_lo, c1_hi, c1_lo, c2_hi, c2_lo, t)`` order and the indices
    of the channels it refuses.  It advances every other state; a refused
    channel's words are zero and its state is not touched, and the caller
    runs :func:`plan_blocks` for it (bit-identical either way;
    tests/test_torch_plan_lanes.py).  It refuses the genesis state
    (``m0 = 0``), a u32 wrap inside the chunk, and a short exact period
    q ≤ 2²⁰ that meets :func:`plan_blocks`' exact-periodic regime in any
    block (there the fast path plans an exact reset with no switch).

    This is the config-5 host path (C=256 × B=2048 at 100 Msps): one
    vectorized pass over ``(C, B)`` instead of 256 Python planning loops.
    After a channel's first firing at stream position p0 its counter
    restarts at 1 and fires again at r₁, the smallest firing value, so the
    counter at any position is closed-form ``m(c) = m0+c (c ≤ p0) |
    ((c−p0−1) mod r₁)+1`` and the per-block first reset is ``j0 = p0 − c``
    before it and ``r₁ − m`` after (VERDICT r2 #6).  On the post-reset
    trajectory (``m0 ≤ r₁``) p0 is ``r₁ − m0``; a state above r₁ (a track
    channel just after its shift stepped) hunts p0 as :func:`plan_blocks`
    does, through the state's hunt cache.
    """
    C = len(shifts_c)
    B = len(counts)
    counts_a = np.asarray(counts, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts_a)[:-1]])
    total = int(counts_a.sum())
    consts = [rate_constants(s, samplerate, quantize_f32) for s in shifts_c]
    d_c = np.array([k[0] for k in consts], np.uint64)

    if not reset_quirk:
        offs = np.array([st.abs_offset % (1 << 64) for st in states],
                        np.uint64)
        with np.errstate(over="ignore"):
            M = offs[:, None] + starts[None, :].astype(np.uint64)
            C1 = M * d_c[:, None]
        fields = np.empty((7, C, B), np.uint32)
        _split_into(fields, d_c[:, None], C1, C1)
        fields[6] = np.uint32(block_len)
        for st in states:
            st.abs_offset += total
            st.samplenum = st.abs_offset
        return fields, []

    never = 1 << 62                      # a firing no chunk reaches
    r1_c = np.full(C, never, np.int64)
    m0_c = np.ones(C, np.int64)
    p0_c = np.full(C, never, np.int64)
    refused: set[int] = set()
    hunts: dict[int, tuple | None] = {}  # hunt caches to restore on refusal
    for c, ((_, r32, _, _), st) in enumerate(zip(consts, states)):
        m0 = st.samplenum
        if m0 == 0 or m0 + total >= _U32:
            refused.add(c)               # genesis, or a u32 wrap inside
            continue
        r1 = _steady_period(r32, block_len)
        if r1 is not None and m0 > r1:
            hunts[c] = st.hunt           # off the post-reset trajectory
            j = _cached_first_reset(r32, m0, total, st, block_len)
            p0_c[c] = never if j is None else j
        elif r1 is not None:
            p0_c[c] = r1 - m0
        m0_c[c] = m0
        r1_c[c] = never if r1 is None else r1

    # counter value at each block start, and each block's first reset
    p0 = p0_c[:, None]
    s0 = starts[None, :]
    pre = s0 <= p0
    M = np.where(pre, m0_c[:, None] + s0,
                 (s0 - p0 - 1) % r1_c[:, None] + 1)
    j0 = np.where(pre, p0 - s0, r1_c[:, None] - M)
    hit = j0 < counts_a[None, :]
    short = [c for c, k in enumerate(consts)
             if k[2] is not None and k[2] <= _PERIODIC_Q]
    if short:
        n_hi = M[short] + counts_a[None, :]
        absr = np.array([abs(float(consts[c][1])) for c in short])[:, None]
        bound = np.array([consts[c][3] for c in short])[:, None]
        fast = ((n_hi <= (1 << 24)) & (absr * n_hi < bound)).any(axis=1)
        refused.update(c for c, f in zip(short, fast) if f)
    with np.errstate(over="ignore"):
        Mu = M.astype(np.uint64)
        du = d_c[:, None]
        C1 = Mu * du
        C2 = np.where(hit, (np.uint64(0) - j0.astype(np.uint64)) * du, C1)
    fields = np.empty((7, C, B), np.uint32)
    _split_into(fields, du, C1, C2)
    fields[6] = np.uint32(block_len)
    fields[6][hit] = (j0[hit] + 1).astype(np.uint32)
    refused = sorted(refused)
    fields[:, refused] = 0

    end = np.where(total <= p0_c, m0_c + total,
                   (total - p0_c - 1) % r1_c + 1)
    take = np.ones(C, bool)
    take[refused] = False
    for c, st in enumerate(states):
        if take[c]:
            st.samplenum = int(end[c])
            st.abs_offset += total
        elif c in hunts:
            st.hunt = hunts[c]
    return fields, refused


_PERIODIC_Q = 1 << 20      # plan_blocks' exact-periodic regime: q ≤ 2²⁰

_RATE_CACHE_MAX = 4096
_rate_cache: dict[tuple, tuple] = {}


def rate_constants(shift_hz: float, samplerate: int,
                   quantize_f32: bool = True) -> tuple:
    """``(D, r32, q, bound)`` of one constant shift: the Q0.64 increment,
    the f32 ratio, its exact period (None when huge) and the exact-only
    bound (None without q).  Cached by ``(shift, samplerate,
    quantize_f32)``, so a chunk of constant channels builds no
    ``Fraction``."""
    key = (float(shift_hz), int(samplerate), bool(quantize_f32))
    got = _rate_cache.get(key)
    if got is None:
        if len(_rate_cache) >= _RATE_CACHE_MAX:
            _rate_cache.clear()      # a track channel adds a value a step
        r32 = _ratio_f32(key[0], key[1])
        q = _exact_period(r32)
        got = (fxp.rate_to_q64(key[0], key[1], quantize_f32=key[2]), r32, q,
               None if q is None else _exact_only_bound(r32, q))
        _rate_cache[key] = got
    return got


def const_lane(shift_hz: float, samplerate: int, *, block_len: int,
               quantize_f32: bool = True, reset_quirk: bool = True) -> str:
    """The batched planner for a channel whose shift is constant over a
    chunk, from its f32 ratio alone: ``'periodic'``
    (:func:`plan_fields_periodic`) for an exact period q ≤ 2²⁰ under the
    reset quirk whose exact-only bound a full block from counter 1 meets,
    else ``'uniform'`` (:func:`plan_fields_uniform`, which without the
    quirk takes any ratio).  A short period with ``|r|·(L+1) ≥ 2²²/q`` is
    never in :func:`plan_blocks`' exact-periodic regime at a full block,
    so :func:`plan_blocks` plans it by its firings, as the uniform lane
    does.  Each lane's planner tests its own regime on the states
    (genesis, a seeked state, a wrap) and refuses the channels that leave
    it to :func:`plan_blocks`."""
    _, r32, q, bound = rate_constants(shift_hz, samplerate, quantize_f32)
    if (reset_quirk and q is not None and q <= _PERIODIC_Q
            and abs(float(r32)) * (block_len + 1) < bound):
        return "periodic"
    return "uniform"


def plan_fields_periodic(
    shifts_c: Sequence[float],
    counts: Sequence[int],
    samplerate: int,
    states: Sequence[NCOState],
    block_len: int,
    *,
    quantize_f32: bool = True,
) -> tuple[np.ndarray, list[int]]:
    """Batched planner for C channels whose f32 ratio has a short exact
    period q ≤ 2²⁰, under the reset quirk — :func:`plan_fields_uniform`'s
    twin for the other regime, with its contract (without the quirk
    :func:`plan_fields_uniform` takes every ratio).

    ``shifts_c[c]`` is channel c's (constant within the chunk) shift;
    returns the ``(7, C, B)`` uint32 plan fields and the indices of the
    channels it refuses, and advances every other state.  It refuses a
    channel whose ratio has no such q or that leaves :func:`plan_blocks`'
    exact-periodic regime in any block (a counter past 2²⁴, or |r|·n at
    the exact-only bound); a refused channel's words are zero and its state
    is not touched, and the caller runs :func:`plan_blocks` for it.

    In the regime every reset is exact and keeps the phase, so a block's
    words are closed-form: ``m_k = m0 + s_k (s_k ≤ j0) | ((s_k − j0 − 1)
    mod q) + 1`` with ``j0 = (−m0) mod q``, ``C1 = C2 = m_k·D``, ``T = L``
    — :func:`plan_blocks`' fast path over the whole ``(C, B)`` grid at once
    (bit-identical; tests/test_torch_plan_lanes.py).
    """
    C = len(shifts_c)
    B = len(counts)
    counts_a = np.asarray(counts, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts_a)[:-1]])
    total = int(counts_a.sum())
    consts = [rate_constants(s, samplerate, quantize_f32) for s in shifts_c]
    # a ratio with no short period is refused: q = 1 and a zero bound
    # stand in for its constants
    short = np.array([k[2] is not None and k[2] <= _PERIODIC_Q
                      for k in consts])
    d_c = np.array([k[0] for k in consts], np.uint64)[:, None]
    q_c = np.array([k[2] if ok else 1 for k, ok in zip(consts, short)],
                   np.int64)
    absr = np.array([abs(float(k[1])) for k in consts])
    bound = np.array([k[3] if ok else 0.0 for k, ok in zip(consts, short)])
    m0_c = np.array([st.samplenum for st in states], np.int64)
    j0 = (-m0_c) % q_c
    # counters at the block starts, in place over one (C, B) array (a chunk
    # of 256 channels is ~0.5 MB a temporary: fewer passes, fewer pages)
    M = starts[None, :] - (j0 + 1)[:, None]
    M %= q_c[:, None]
    M += 1
    k = int(np.searchsorted(starts, j0.max(), side="right"))
    if k:                                # blocks before the first reset
        head = starts[:k]
        M[:, :k] = np.where(head <= j0[:, None], m0_c[:, None] + head,
                            M[:, :k])
    # both regime tests grow with the counter, so each channel's largest
    # block-end counter decides every block (in place, as above)
    M += counts_a
    n_top = M.max(axis=1)
    M -= counts_a
    ok = short & (n_top <= (1 << 24)) & (absr * n_top < bound)
    C1 = M.view(np.uint64)
    with np.errstate(over="ignore"):
        C1 *= d_c
    fields = np.empty((7, C, B), np.uint32)
    fields[6] = np.uint32(block_len)
    _split_into(fields, d_c, C1, C1)
    refused = np.flatnonzero(~ok).tolist()
    fields[:, refused] = 0

    end = np.where(total <= j0, m0_c + total, (total - j0 - 1) % q_c + 1)
    for c in np.flatnonzero(ok):
        states[c].samplenum = int(end[c])
        states[c].abs_offset += total
    return fields, refused


def _split_into(fields: np.ndarray, D, C1, C2) -> None:
    """Write u64 (D, C1, C2) hi/lo splits into ``fields[0:6]`` in place."""
    m = np.uint64(0xFFFFFFFF)
    s32 = np.uint64(32)
    fields[0] = D >> s32
    fields[1] = D & m
    fields[2] = C1 >> s32
    fields[3] = C1 & m
    fields[4] = C2 >> s32
    fields[5] = C2 & m


def _plan_from_u64(D, C1, C2, T) -> BlockPlan:
    m = np.uint64(0xFFFFFFFF)
    u32 = lambda a: a.astype(np.uint32)  # noqa: E731
    return BlockPlan(
        u32(D >> np.uint64(32)), u32(D & m),
        u32(C1 >> np.uint64(32)), u32(C1 & m),
        u32(C2 >> np.uint64(32)), u32(C2 & m),
        T.copy(),
    )
