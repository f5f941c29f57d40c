// The polyphase resampler's window form on the card: M outputs of a
// streaming chunk from its [T−1 history | inputs] buffer.
//
// Replaces the XLA gather + fixed-tree function doppler_tpu/ops/resample.py:61
// window_dot (no Pallas kernel: the JAX package leaves it to XLA), which
// the stream runs wherever the fused kernels do not take a chunk: the EOF
// chunk and the drain, every chunk under --impl xla, a split cascade's tail
// stages, the mixer + resampler route of an ineligible geometry, and the
// window step of --mesh.  Its plain version (ops/resample.py window_dot)
// sums a fixed power-of-two tree; this kernel sums each output as the chain
// and cascade kernels' FIR does (fir.cuh): one __fmaf_rn chain over the taps
// l = 0..T−1 of bank[p] from +0, newest input first.  So on the card a
// chunk gives the same bits whether the fused kernel or the mixer and this
// kernel compute it, and the bytes do not depend on the chunk width.
//
// Function.  Output j (0 ≤ j < M) of channel c: u = j·Q + rem0,
// p = u mod P, base = off0 + ⌊u/P⌋;
//     y[j] = Σ_{l<T} bank[p, l] · x[base + T − 1 − l]
// (bank_rev[p, k] = bank[p, T−1−k] is what the caller holds).  Indices
// clamp to [0, len), as window_dot's gather clips: only outputs past the
// valid count reach the edges.
//
// Bound on this card.  Bytes: each input read once and each output written
// once, 8·C·(len + M) bytes at 3.35 TB/s.  Operations: T FMAs an
// output-plane, 2·T·2·C·M float32 operations at 67 TFLOP/s.  At config 3's
// single stage (P/Q = 3/64, T = 370) an output costs 370 FMAs and reads
// 64/3 input samples: bound by bytes.
//
// Design (ops/cuda/geometry.py pick_window chooses the path and its sizes).
// A CTA owns a tile of consecutive outputs, both planes, and stages once in
// shared memory the span of x they read — the clamp applied while it fills
// the span, by repeating the edge samples, so the dot has no test — and the
// taps they use.  Two paths:
//
// - fir (P ≤ 16): the chain kernel's dot, fir.cuh's fir_tile, on one
//   channel: all P rows of taps in shared memory, a thread owns NP phases ×
//   R windows and one x load feeds up to 2·NP·R FMAs.  fir.cuh counts
//   outputs J ≥ 0 from a phase-0 origin: J = j + js with js·Q ≡ rem0
//   (mod P) (P/Q is in lowest terms, so js exists), and fir.cuh's x index n
//   is buffer index n + d, d = off0 + T − 1 − (js·Q − rem0)/P.
// - rows (larger P, e.g. the 100 Msps split tail's 384/3125): a tile holds
//   only the rows its own outputs use (consecutive outputs step the phase by
//   Q mod P) for a group of channels, channel the fast index of a thread, so
//   the threads of a warp read one tap row (a broadcast) and their own
//   channel's span; a thread owns one output of its channel (two or four,
//   with fewer threads, measured slower: PERF.md §6).
#include "fir.cuh"
#include "nco.cuh"

namespace doppler {

struct WindowArgs {
    FirStage f;             // the fir path's stage (P, Q, T, R, offsets)
    long long len;          // samples of each input row
    long long x_stride;     // elements between channel rows of the input
    long long M;            // outputs a row
    long long off0;         // buffer index of ⌊m0·Q/P⌋ − (T−1)
    long long d;            // fir path: buffer index of fir.cuh's x index 0
    int C, rem0, js;
    int rows;               // 1: the rows path
    int tile;               // outputs a CTA
    int n_tiles;            // tiles a channel (group)
    int groups;             // rows path: channel groups
    int cg;                 // rows path: channels a CTA
    int row_stride;         // rows path: floats a tap row (odd)
    int span_stride;        // rows path: float2 a channel's span (odd)
};

// What a CTA works on.  The index arithmetic is 64-bit divisions: one
// thread does it, once.
struct WindowPlan {
    int ch, unit;           // channel (rows: first channel of the group), tile
    int cnt;                // outputs of the tile
    long long j0;           // first output of the tile
    FirRun run;             // fir path
    long long lo, last;     // fir path: fir x indices of the span
    long long org;          // fir: x index of span k = 0; rows: buffer index
    int pr0;                // rows path: (j0·Q + rem0) mod P
    int span;               // rows path: samples of each channel's span
};

template <bool kRows>
__device__ __forceinline__ void window_plan(const WindowArgs& a, unsigned block,
                                            WindowPlan& w) {
    split_block(block, kRows ? a.groups : a.C, a.n_tiles, w.ch, w.unit);
    if (kRows) w.ch *= a.cg;
    w.j0 = (long long)w.unit * a.tile;
    w.cnt = (int)min64((long long)a.tile, a.M - w.j0);
    const FirStage& f = a.f;
    if (!kRows) {
        const long long J0 = w.j0 + a.js;
        w.run = fir_make_run(f, J0, w.cnt);
        w.org = span_origin(f, w.run.i_lo);
        w.lo = div_nonneg(J0 * f.Q, f.P) - (f.T - 1);
        w.last = div_nonneg((J0 + w.cnt - 1) * f.Q, f.P);
        return;
    }
    const long long u0 = w.j0 * f.Q + a.rem0;
    const long long n0 = div_nonneg(u0, f.P);
    w.pr0 = (int)(u0 - n0 * f.P);
    w.org = a.off0 + n0;
    w.span = (int)(div_nonneg(u0 + (long long)(w.cnt - 1) * f.Q, f.P) - n0) + f.T;
}

// fir path: the span entry of fir x index lo + i
struct FirSpanDst {
    float2* xs;
    int S;
    unsigned magic;
    int lo;                 // lo − origin
    __device__ __forceinline__ float2* operator()(int i) const {
        return xs + span_pad(lo + i, S, magic);
    }
};

// rows path: entry i of one channel's span
struct RowSpanDst {
    float2* xs;
    __device__ __forceinline__ float2* operator()(int i) const { return xs + i; }
};

struct WindowSink {
    float* yi;
    float* yq;
    int js;
    __device__ __forceinline__ void put(long long J, float vi, float vq) const {
        yi[J - js] = vi;
        yq[J - js] = vq;
    }
};

// rows path, phase 1: thread t computes output t / cg of the tile for its
// channel slot t mod cg, from its row of taps and its offset into the
// channel's span.  The threads past cg·tile only fill.
__device__ __forceinline__ void window_rows_dot(
        const float* __restrict__ taps, const float2* __restrict__ xs,
        float* __restrict__ yi, float* __restrict__ yq, const WindowArgs& a,
        const WindowPlan& w, int tid) {
    const int P = a.f.P, Q = a.f.Q, T = a.f.T;
    const int cl = tid % a.cg, jj = tid / a.cg;
    if (jj >= w.cnt || w.ch + cl >= a.C) return;
    const float* row = taps + jj * a.row_stride;
    // the newest sample of output jj: its base ⌊(j·Q+rem0)/P⌋ − n0 + T−1
    const float2* x = xs + cl * a.span_stride + (w.pr0 + jj * Q) / P + (T - 1);
    float ai = 0.0f, aq = 0.0f;
#pragma unroll 4
    for (int l = 0; l < T; ++l) {
        const float t = row[l];
        const float2 v = x[-l];
        ai = __fmaf_rn(t, v.x, ai);
        aq = __fmaf_rn(t, v.y, aq);
    }
    const long long c = w.ch + cl, j = w.j0 + jj;
    yi[c * a.M + j] = ai;
    yq[c * a.M + j] = aq;
}

// Phase `ph` of the CTA with plan `w`, for thread `tid` of `nthreads`; true
// while a further phase follows (after a barrier).
template <bool kRows>
__device__ __forceinline__ bool window_phase(
        const float* __restrict__ xi, const float* __restrict__ xq,
        const float* __restrict__ bank_rev, float* __restrict__ yi,
        float* __restrict__ yq, const WindowArgs& a, const WindowPlan& w,
        int tid, int nthreads, int ph, float* smem) {
    const FirStage& f = a.f;
    if (!kRows) {
        const size_t row = (size_t)w.ch * a.x_stride;
        if (ph == 0) {
            fir_load_taps<true>(smem, f, bank_rev, tid, nthreads);
            FirSpanDst dst{reinterpret_cast<float2*>(smem + f.buf_off), f.S,
                           f.magic, (int)(w.lo - w.org)};
            span_fill<false>(xi + row, xq + row, a.len, w.lo + a.d,
                             (int)(w.last - w.lo + 1), tid, nthreads, dst);
            smem_copy_wait();
            return true;
        }
        WindowSink sink{yi + (size_t)w.ch * a.M, yq + (size_t)w.ch * a.M, a.js};
        fir_run(reinterpret_cast<const float2*>(smem + f.buf_off),
                smem + f.tap_off, f, w.run, tid, nthreads, sink);
        return false;
    }
    float2* xs = reinterpret_cast<float2*>(smem + f.buf_off);
    if (ph == 0) {
        // the tile's rows, natural order: row jj is bank row (pr0 + jj·Q) mod P
        const int qm = f.Q % f.P;
        for (int jj = 0; jj < w.cnt; ++jj) {
            const float* src = bank_rev + (size_t)((w.pr0 + jj * qm) % f.P) * f.T
                + (f.T - 1);
            float* d = smem + jj * a.row_stride;
#pragma unroll 4
            for (int l = tid; l < f.T; l += nthreads) smem_copy(d + l, src - l);
        }
        const int n_ch = (int)min64((long long)a.cg, (long long)a.C - w.ch);
        for (int cl = 0; cl < n_ch; ++cl) {
            const size_t row = (size_t)(w.ch + cl) * a.x_stride;
            span_fill<false>(xi + row, xq + row, a.len, w.org, w.span, tid,
                             nthreads, RowSpanDst{xs + cl * a.span_stride});
        }
        smem_copy_wait();
        return true;
    }
    window_rows_dot(smem, xs, yi, yq, a, w, tid);
    return false;
}

// js and d of the fir path: js·Q ≡ rem0 (mod P), 0 ≤ js < P.
inline void window_shift(long long off0, int rem0, int P, int Q, int T, int& js,
                         long long& d) {
    js = 0;
    while ((long long)js * Q % P != rem0) ++js;
    d = off0 + T - 1 - ((long long)js * Q - rem0) / P;
}

// WindowArgs from doppler_window's arguments (below); false where they are
// not ones the kernel takes.  layout: rows, tile, R, tap_stride, tap_off,
// buf_off, cg, row_stride, span_stride (ops/cuda/geometry.py
// WindowLayout.args).
inline bool make_window_args(WindowArgs& a, int C, long long len,
                             long long x_stride, long long M, int rem0,
                             long long off0, int P, int Q, int T,
                             const int* layout) {
    if (C < 1 || M < 1 || P < 1 || Q < 1 || T < 1 || rem0 < 0 || rem0 >= P
            || len < 1 || x_stride < len)
        return false;
    a = WindowArgs{};
    a.len = len;
    a.x_stride = x_stride;
    a.M = M;
    a.off0 = off0;
    a.C = C;
    a.rem0 = rem0;
    a.rows = layout[0];
    a.tile = layout[1];
    a.f.P = P;
    a.f.Q = Q;
    a.f.T = T;
    a.f.R = layout[2];
    a.f.tap_stride = layout[3];
    a.f.tap_off = layout[4];
    a.f.buf_off = layout[5];
    a.cg = layout[6];
    a.row_stride = layout[7];
    a.span_stride = layout[8];
    if (a.tile < 1) return false;
    a.n_tiles = (int)((M + a.tile - 1) / a.tile);
    if (a.rows) {
        if (a.cg < 1 || a.row_stride < T || a.span_stride < 1 || a.f.buf_off % 2)
            return false;
        a.groups = (C + a.cg - 1) / a.cg;
    } else {
        if (!fir_r_ok(a.f.R) || a.f.tap_stride < T + 10 || a.f.tap_stride % 4
                || a.f.tap_off % 4 || a.f.buf_off % 4)
            return false;
        fir_derive(a.f);
        window_shift(off0, rem0, P, Q, T, a.js, a.d);
    }
    return true;
}

}  // namespace doppler

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using doppler::WindowArgs;

constexpr int kWindowMaxThreads = 256;

template <bool kRows>
__global__ void __launch_bounds__(kWindowMaxThreads)
window_kernel(const float* __restrict__ xi, const float* __restrict__ xq,
              const float* __restrict__ bank_rev, float* __restrict__ yi,
              float* __restrict__ yq, const __grid_constant__ WindowArgs a) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ doppler::WindowPlan plan;
    if (threadIdx.x == 0) doppler::window_plan<kRows>(a, blockIdx.x, plan);
    __syncthreads();
    for (int ph = 0;; ++ph) {
        if (!doppler::window_phase<kRows>(xi, xq, bank_rev, yi, yq, a, plan,
                                          (int)threadIdx.x, (int)blockDim.x, ph,
                                          smem))
            break;
        __syncthreads();
    }
}

}  // namespace

// xi, xq: (C, x_stride) float32 rows of len samples; bank_rev: (P, T);
// yi, yq: (C, M).  layout: 9 ints, threads and smem as
// ops/cuda/geometry.py pick_window lays them out.  Returns
// cudaGetLastError() after the launch.
extern "C" int doppler_window(const float* xi, const float* xq,
                              const float* bank_rev, float* yi, float* yq, int C,
                              long long len, long long x_stride, long long M,
                              int rem0, long long off0, int P, int Q, int T,
                              const int* layout, int threads, long long smem,
                              void* stream) {
    WindowArgs a;
    if (threads < 1 || threads > kWindowMaxThreads || smem <= 0
            || !doppler::make_window_args(a, C, len, x_stride, M, rem0, off0, P,
                                          Q, T, layout))
        return (int)cudaErrorInvalidValue;
    const long long grid = (long long)(a.rows ? a.groups : C) * a.n_tiles;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    auto kernel = a.rows ? window_kernel<true> : window_kernel<false>;
    // beyond 48 KB with the static plan, the CTA must opt in
    if (smem + 1024 > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, threads, (size_t)smem,
             static_cast<cudaStream_t>(stream)>>>(xi, xq, bank_rev, yi, yq, a);
    return (int)cudaGetLastError();
}

#endif  // __CUDACC__
