// The polyphase FIR of the chain and cascade kernels: a register tile of
// outputs a thread over a span of x held in shared memory.
//
// One stage computes, for output j ≥ 0,
//     y[j] = Σ_{l<T} bank[(j·Q) mod P, l] · x[⌊j·Q/P⌋ − l]
// as one __fmaf_rn chain over l = 0..T−1 in that order (I and Q each).
//
// Windows and phases.  Write j = P·i + p (window i, phase p < P).  Then
// ⌊j·Q/P⌋ = Q·i + off_p with off_p = ⌊p·Q/P⌋, and the bank row is
// (p·Q) mod P: every output of phase p uses the same row, and the P outputs
// of a window read almost the same x (their offsets differ by off_p < Q).
//
// The register tile.  A thread owns NP phases × R neighbouring windows
// (NP = 3 where P = 3, all phases of a window; else NP = 1) and walks the x
// positions of their union window once, downwards from the top output's
// x[n_top].  At position n_top − t the output (r, p) is at its tap
// l = t − Δ, Δ = Q·(R−1−r) + off_top − off_p: l rises by one a step for
// every output at once, so each output still sums its own taps in ascending
// order, and one value loaded from shared memory feeds up to 2·NP·R FMAs.
// l depends on the step and on (r, p) only, not on the lane: the tap is one
// address for the whole warp (a broadcast load), and whether an output has a
// tap at this step is a uniform branch.  Steps go four at a time; the four
// taps of an output come as one 16-byte load where 4 | Q (the rows sit in
// shared memory with a lead of (off_top − off_p) mod 4 floats, so that the
// load is aligned for every (r, p)).  The groups in which every output has
// all four taps, most of them, run without a test, their loads at fixed
// offsets from a running pointer.  In the others an output with fewer than
// four taps loads four floats all the same (a row has room before and after
// its taps) and multiplies only the taps that exist: there is no zero
// padding, so a NaN in x reaches only the outputs whose window holds it.
//
// The span.  x sits as float2 (I, Q) at index pad(k) = k + ⌊k/S⌋ with
// S = Q·R, the distance in x between two lanes' windows: lanes then read
// S + 1 apart, which is odd for even Q, so the 16 lanes of a half warp meet
// 16 different 8-byte bank pairs.  k = 0 is x[Q·i_lo − (T−1) − kSlack] for
// the first window i_lo of the CTA's outputs; the walk keeps a running
// padded index (no division in the loop).  Entries that no wanted output
// reads stay unwritten: ragged groups read them into accumulators that are
// never stored.
#pragma once

#include <cstdint>

#include "host_shim.cuh"

namespace doppler {

constexpr int kSlack = 3;    // a group of four steps may read 3 below a window
constexpr int kTapFront = 4; // floats before a tap row: a group may start 3 early

// One stage as the kernels see it (the wrapper computes the offsets).
struct FirStage {
    int P, Q, T;
    int R;              // windows a thread: 1 or 2
    int S;              // Q·R
    unsigned magic;     // ⌈2^32 / S⌉: k / S without a division (span_div)
    int vec;            // taps 16 bytes at a time
    int tap_stride;     // floats a tap row: ≥ T + 10, a multiple of 4
    int tap_off;        // float offset of the rows in shared memory
    int buf_off;        // float offset of the span of this stage's input
};

__host__ __device__ __forceinline__ long long max64(long long a, long long b) {
    return a > b ? a : b;
}

__host__ __device__ __forceinline__ long long min64(long long a, long long b) {
    return a < b ? a : b;
}

// a / b for a ≥ 0, b > 0: in 32 bits where a fits (a 64-bit division is a
// long subroutine, and the thread that plans a CTA runs them back to back,
// the other threads waiting); the stages' P is 1 or 3 nearly always, which
// takes no division at all.
__host__ __device__ __forceinline__ long long div_nonneg(long long a, int b) {
    if (b == 1) return a;
    if ((a >> 32) == 0)
        return (long long)(b == 3 ? (unsigned)a / 3u : (unsigned)a / (unsigned)b);
    return a / b;
}

// ⌊k / S⌋ for 0 ≤ k with k·S < 2^32 (a span is a few 10^4 entries): the high
// word of k·⌈2^32/S⌉, one multiply and no branch.  S = 1 has no such word.
__host__ __device__ __forceinline__ int span_div(int k, int S, unsigned magic) {
    return S == 1 ? k : (int)(((unsigned long long)(unsigned)k * magic) >> 32);
}

__host__ __device__ __forceinline__ int span_pad(int k, int S, unsigned magic) {
    return k + span_div(k, S, magic);
}

// Writes one sample into a span: the store of the fill loops.
struct SpanStore {
    float2* xs;
    int S;
    unsigned magic;
    long long origin;       // x index of k = 0
    __device__ __forceinline__ void operator()(long long n, float vi,
                                               float vq) const {
        xs[span_pad((int)(n - origin), S, magic)] = make_float2(vi, vq);
    }
};

// Four bytes from global to shared memory with no register between
// (cp.async): a thread's copies all fly at once, so a fill that runs few
// threads is not one load latency a sample; smem_copy_wait() waits for the
// thread's own copies (a barrier after it shows them to the CTA).
__device__ __forceinline__ void smem_copy(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    *dst = *src;
#endif
}

__device__ __forceinline__ void smem_copy_wait() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// x[b] for b = b_lo .. b_lo+n−1 of one channel's two rows (I and Q) into
// *dst(i), i = b − b_lo, a float2 (I, Q), where x[b] outside [0, len) is the
// edge sample (kZero false: the index clamps) or +0 (kZero).  Consecutive
// threads take consecutive samples (the copies of a warp coalesce).
template <bool kZero, class Dst>
__device__ __forceinline__ void span_fill(const float* __restrict__ xi,
                                          const float* __restrict__ xq,
                                          long long len, long long b_lo, int n,
                                          int tid, int nthreads, const Dst& dst) {
    // unrolled: a CTA of few warps is bound by each sample's index chain
#pragma unroll 4
    for (int i = tid; i < n; i += nthreads) {
        const long long b = b_lo + i;
        float2* d = dst(i);
        if (kZero && (b < 0 || b >= len)) {
            *d = make_float2(0.0f, 0.0f);
            continue;
        }
        const long long c = b < 0 ? 0 : (b >= len ? len - 1 : b);
        smem_copy(&d->x, xi + c);
        smem_copy(&d->y, xq + c);
    }
}

__host__ __device__ __forceinline__ int fir_np(int P) { return P == 3 ? 3 : 1; }

__host__ __device__ __forceinline__ void fir_derive(FirStage& st) {
    st.S = st.Q * st.R;
    st.magic = st.S > 1
        ? (unsigned)((0x100000000ULL + (unsigned)st.S - 1) / (unsigned)st.S) : 0u;
    st.vec = (st.Q % 4 == 0 || st.R == 1) ? 1 : 0;
}

// x index of the span's k = 0 for outputs whose first window is i_lo.
__host__ __device__ __forceinline__ long long span_origin(const FirStage& st,
                                                          long long i_lo) {
    return i_lo * st.Q - (st.T - 1) - kSlack;
}

// The stage's rows into shared memory: row p (the outputs' phase, not the
// bank's row) at p·tap_stride + kTapFront + lead_p; the floats around the
// taps stay unwritten and are read but never used.  kRev: `bank` holds each
// row reversed (bank_rev[p, k] = bank[p, T−1−k], the window form's).  The
// copies are smem_copy's: smem_copy_wait() before the barrier.
template <bool kRev = false>
__device__ __forceinline__ void fir_load_taps(float* __restrict__ smem,
                                              const FirStage& st,
                                              const float* __restrict__ bank,
                                              int tid, int nthreads) {
    const int off_top = ((st.P - 1) * st.Q) / st.P;
    for (int p = 0; p < st.P; ++p) {
        const int lead = fir_np(st.P) == st.P
            ? ((off_top - (p * st.Q) / st.P) & 3) : 0;
        const float* row = bank + ((p * st.Q) % st.P) * st.T;
        float* dst = smem + st.tap_off + p * st.tap_stride + kTapFront + lead;
#pragma unroll 4
        for (int l = tid; l < st.T; l += nthreads)
            smem_copy(dst + l, row + (kRev ? st.T - 1 - l : l));
    }
}

// x[n − u], u = 0..3, for the walk's position n at padded index idx with
// e = k mod S, and the walk moved on by four.  At most one pad word lies
// among four neighbours (S ≥ 4): after the entry with k ≡ 0 (mod S).
__device__ __forceinline__ void fir_load_x(const float2* __restrict__ xs, int& idx,
                                           int& e, int S, float2* v) {
    if (S >= 4) {
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = xs[idx - u - (u > e ? 1 : 0)];
        idx -= e < 4 ? 5 : 4;
        e = e < 4 ? e - 4 + S : e - 4;
    } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            v[u] = xs[idx];
            idx -= e == 0 ? 2 : 1;
            e = e == 0 ? S - 1 : e - 1;
        }
    }
}

// One group of four steps of fir_tile: feeds every output (r, p) its taps
// l4 .. l4+3, l4 = t4 − Δ, from v[u] = x[n_top − t4 − u].  kFull: every
// output has all four (no test, no branch) and the taps come as one aligned
// 16-byte load.  Else each output tests its group and its taps.
template <int NP, int R, bool kFull>
__device__ __forceinline__ void fir_fma(const float2* v, const float* const* row,
                                        const int* off, int off_top, int Q, int T,
                                        int vec, int t4, float (*ai)[R],
                                        float (*aq)[R]) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int l4 = t4 - (Q * (R - 1 - r) + off_top - off[p]);
            if (kFull || (vec && l4 >= 0 && l4 + 3 < T)) {
                const float4 w = *reinterpret_cast<const float4*>(row[p] + l4);
                ai[p][r] = __fmaf_rn(w.x, v[0].x, ai[p][r]);
                aq[p][r] = __fmaf_rn(w.x, v[0].y, aq[p][r]);
                ai[p][r] = __fmaf_rn(w.y, v[1].x, ai[p][r]);
                aq[p][r] = __fmaf_rn(w.y, v[1].y, aq[p][r]);
                ai[p][r] = __fmaf_rn(w.z, v[2].x, ai[p][r]);
                aq[p][r] = __fmaf_rn(w.z, v[2].y, aq[p][r]);
                ai[p][r] = __fmaf_rn(w.w, v[3].x, ai[p][r]);
                aq[p][r] = __fmaf_rn(w.w, v[3].y, aq[p][r]);
            } else if (l4 > -4 && l4 < T) {
                // the row has room before and after its taps: the loads
                // need no test and start together; what lies outside the
                // taps is never multiplied
                float w[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) w[u] = row[p][l4 + u];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    if ((unsigned)(l4 + u) < (unsigned)T) {
                        ai[p][r] = __fmaf_rn(w[u], v[u].x, ai[p][r]);
                        aq[p][r] = __fmaf_rn(w[u], v[u].y, aq[p][r]);
                    }
                }
            }
        }
    }
}

// A run of outputs j0 .. j0+cnt−1 (j0 ≥ 0, cnt ≥ 1) of a stage, with its
// first window and its window count: one thread of the CTA divides, all
// threads read the result.
struct FirRun {
    long long j0;
    int cnt;
    long long i_lo;     // ⌊j0 / P⌋
    int windows;        // ⌊(j0+cnt−1) / P⌋ − i_lo + 1
};

__host__ __device__ __forceinline__ FirRun fir_make_run(const FirStage& st,
                                                        long long j0, int cnt) {
    FirRun run;
    run.j0 = j0;
    run.cnt = cnt;
    run.i_lo = div_nonneg(j0, st.P);
    run.windows = (int)(div_nonneg(j0 + cnt - 1, st.P) - run.i_lo) + 1;
    return run;
}

// The outputs of `run` from the stage's span `xs` (origin
// span_origin(st, run.j0)) and its rows `taps`, shared out over the CTA's
// threads; sink.put(j, i, q) once for each.
template <int NP, int R, class Sink>
__device__ __forceinline__ void fir_tile(const float2* __restrict__ xs,
                                         const float* __restrict__ taps,
                                         const FirStage& st, const FirRun& run,
                                         int tid, int nthreads, Sink& sink) {
    const int P = st.P, Q = st.Q, T = st.T, S = st.S;
    const long long i_lo = run.i_lo, j0 = run.j0;
    const int cnt = run.cnt;
    const int G = (run.windows + R - 1) / R;
    const int n_items = NP == 1 ? G * P : G;
    for (int item = tid; item < n_items; item += nthreads) {
        const int p0 = NP == 1 && P > 1 ? item / G : 0;
        const int grp = item - p0 * G;
        int off[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) off[p] = P > 1 ? ((p0 + p) * Q) / P : 0;
        const int off_top = off[NP - 1];
        const float* row[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p)
            row[p] = taps + (p0 + p) * st.tap_stride + kTapFront
                + ((off_top - off[p]) & 3);

        // the top output's x[n_top], then downwards
        const int k = Q * (grp * R + R - 1) + off_top + (T - 1) + kSlack;
        const int kq = span_div(k, S, st.magic);
        int e = k - kq * S;
        int idx = k + kq;
        float ai[NP][R], aq[NP][R];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
#pragma unroll
            for (int r = 0; r < R; ++r) ai[p][r] = aq[p][r] = 0.0f;
        }
        const int n_steps = T + Q * (R - 1) + off_top - off[0];
        // the groups in which every output has all four taps: from the
        // bottom output's first tap to the top output's last full group
        const int full_lo = (n_steps - T + 3) & ~3;
        const int full_hi = S >= 4 ? (T - 4) & ~3 : -4;
        int t4 = 0;
        float2 v[4];
        for (; t4 < n_steps && t4 < full_lo; t4 += 4) {
            fir_load_x(xs, idx, e, S, v);
            fir_fma<NP, R, false>(v, row, off, off_top, Q, T, st.vec, t4, ai, aq);
        }
        if (st.vec) {
            while (t4 <= full_hi) {
                // the groups before the next pad word: four neighbours are
                // contiguous while e ≥ 3, so the loads take fixed offsets
                int n_fast = e >= 3 ? (e + 1) >> 2 : 0;
                const int left = ((full_hi - t4) >> 2) + 1;
                if (n_fast > left) n_fast = left;
                const float2* xp = xs + idx;
#pragma unroll 2
                for (int gi = 0; gi < n_fast; ++gi) {
                    v[0] = xp[0];
                    v[1] = xp[-1];
                    v[2] = xp[-2];
                    v[3] = xp[-3];
                    fir_fma<NP, R, true>(v, row, off, off_top, Q, T, 1, t4, ai, aq);
                    xp -= 4;
                    t4 += 4;
                }
                idx -= 4 * n_fast;
                e -= 4 * n_fast;
                if (e < 0) {
                    e += S;
                    idx -= 1;
                }
                if (t4 <= full_hi && e < 3) {
                    fir_load_x(xs, idx, e, S, v);
                    fir_fma<NP, R, true>(v, row, off, off_top, Q, T, 1, t4, ai, aq);
                    t4 += 4;
                }
            }
        }
        for (; t4 < n_steps; t4 += 4) {
            fir_load_x(xs, idx, e, S, v);
            fir_fma<NP, R, false>(v, row, off, off_top, Q, T, st.vec, t4, ai, aq);
        }
#pragma unroll
        for (int p = 0; p < NP; ++p) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const long long j = (i_lo + grp * R + r) * P + p0 + p;
                if (j >= j0 && j < j0 + cnt) sink.put(j, ai[p][r], aq[p][r]);
            }
        }
    }
}

// fir_tile for the stage's (NP, R).
template <class Sink>
__device__ __forceinline__ void fir_run(const float2* __restrict__ xs,
                                        const float* __restrict__ taps,
                                        const FirStage& st, const FirRun& run,
                                        int tid, int nthreads, Sink& sink) {
    if (st.P == 3) {
        if (st.R == 1) {
            fir_tile<3, 1>(xs, taps, st, run, tid, nthreads, sink);
        } else {
            fir_tile<3, 2>(xs, taps, st, run, tid, nthreads, sink);
        }
    } else if (st.R == 1) {
        fir_tile<1, 1>(xs, taps, st, run, tid, nthreads, sink);
    } else {
        fir_tile<1, 2>(xs, taps, st, run, tid, nthreads, sink);
    }
}

// Whether the wrapper's R is one fir_run has.
inline bool fir_r_ok(int R) { return R == 1 || R == 2; }

}  // namespace doppler
