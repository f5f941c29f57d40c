// Banded-matmul resampler (the 'conv' form): the R-term product of a
// stride-Q unfold of the input with the (R·Q, P) taps matrix, for the kept
// outputs of one chunk.
//
// Replaces the XLA dot_generals of doppler_tpu/ops/resample.py:96
// resample_conv_stream (no Pallas kernel: the JAX package leaves the
// product to XLA at Precision.HIGHEST).  On the card a library product
// (cuBLAS) picks its kernel, and with it its summation order, from the
// shape, so the bytes of an output could depend on the chunk around it;
// this kernel gives every output one fixed order instead.
//
// Function.  Output m of channel c (0 ≤ m < M) is cycle output f = p0 + m,
// k = f / P, p = f % P:
//     y[m] = Σ_{r<R} ( Σ_{q<Q} x[start0 + k·Q + r·Q + q] · taps[r·Q + q, p] )
// where x reads 0 outside [0, len) (the JAX form's PADZ/TAIL zeros) and
// taps reads 0 at rows ≥ w_len (its zero-padded taps_pad).  Each inner sum
// is a __fmaf_rn chain over q = 0..Q−1 from +0; the R terms add in order
// r = 0..R−1, as the JAX form adds its R dot_general terms.  Every product
// the JAX form computes is computed (zero taps included), so a NaN input
// reaches the same outputs.  The order depends on nothing but (p, Q, R):
// an output's bits do not depend on M, p0, the chunk width or the grid.
//
// Bound on this card.  Bytes: each input sample read once (4 B a plane),
// each output written once (4 B a plane): 8·C·(len + M) bytes at 3.35 TB/s.
// Operations: R·Q FMAs an output-plane, 2·R·Q·2·C·M float32 operations at
// 67 TFLOP/s.  At config 3 (P/Q = 3/64, T = 370, R = 7) an output costs 448
// FMAs and reads 64/3 ≈ 21 input samples: at 2^24 inputs 1.41 GFLOP and
// 140 MB, bound by bytes (0.042 ms against 0.021 ms).
//
// Design (ops/cuda/geometry.py pick_conv chooses the path and its sizes).
// Both paths stage the x a CTA reads in shared memory once, zeros where it
// lies outside [0, len), and every thread computes both planes.
//
// - tile (P ≤ 4): a CTA owns a tile of consecutive cycles of one channel and
//   holds their rows of x (neighbouring cycles overlap by (R−1)·Q samples)
//   and the whole taps matrix, a row as one float4 (P ≤ 4 phases, zeros
//   after them and at rows ≥ w_len).  A thread owns the P outputs of one
//   cycle, so one x load feeds 2·P FMAs, each term a chain over q =
//   0..Q−1 in order.  x sits as float2 (I, Q) at pad(s) = s + ⌊s/Q⌋
//   (fir.cuh's span padding), so the lanes of a warp, Q + 1 entries apart,
//   meet different banks; the taps are one warp-uniform 16-byte load.
// - rows (larger P, e.g. the 100 Msps split tail's 384/3125): a CTA owns a
//   tile of consecutive outputs (one thread each) of CG channels, and
//   stages x and the taps in chunks of QC columns between two barriers (a
//   row is Q samples, 3125 at the tail): the cycles' rows of x for its CG
//   channels, a warp's lanes reading one address (a broadcast), and its
//   outputs' columns of taps, a lane its own word; each tap feeds its CG
//   channels' FMAs.  The R terms run RG at a time, each its own chain.
//
// Every fill is smem_copy's (cp.async): a thread's copies fly at once.
#include "fir.cuh"
#include "nco.cuh"

namespace doppler {

struct ConvArgs {
    long long len;      // samples of each input row
    long long x_stride; // elements between channel rows of the input
    long long M;        // outputs a row
    long long start0;   // input index where cycle p0 / P's window row begins
    int C, P, Q, R, w_len, p0;
    int rows;           // 1: the rows path
    int tile;           // tile: cycles a CTA; rows: outputs a CTA
    int n_tiles;        // tiles a channel (group)
    int groups;         // channel groups (rows path; C for the tile path)
    unsigned magic;     // tile: ⌈2^32 / Q⌉ (span_div)
    int cg;             // rows: channels a CTA
    int rg;             // rows: terms at a time
    int qc;             // rows: columns of a chunk of x (a multiple of 4)
    int qs;             // rows: floats a column of taps takes (4 mod 32)
    int tap_off;        // float offsets into shared memory (tile: the taps)
    int buf_off;        // the span of x
};

struct ConvPlan {
    int ch, unit;           // channel (rows: first of the group), tile
    long long k_lo;         // first cycle of the tile (tile path: of the CTA)
    long long m_lo;         // rows: first output of the tile
    int cnt;                // rows: outputs of the tile
    int kspan;              // rows: cycles the tile's outputs fall in
};

// The rows path's registers: what a thread carries across the barriers.
template <int CG, int RG>
struct ConvRowsState {
    float ti[CG][RG], tq[CG][RG];   // the open terms
    float ai[CG], aq[CG];           // the sum of the closed ones
};

template <bool kRows>
__device__ __forceinline__ void conv_plan(const ConvArgs& a, unsigned block,
                                          ConvPlan& w) {
    split_block(block, a.groups, a.n_tiles, w.ch, w.unit);
    if (!kRows) {
        w.k_lo = (long long)w.unit * a.tile;
        return;
    }
    w.ch *= a.cg;
    w.m_lo = (long long)w.unit * a.tile;
    w.cnt = (int)min64((long long)a.tile, a.M - w.m_lo);
    w.k_lo = div_nonneg(a.p0 + w.m_lo, a.P);
    w.kspan = (int)(div_nonneg(a.p0 + w.m_lo + w.cnt - 1, a.P) - w.k_lo) + 1;
}

// -- the tile path ------------------------------------------------------------

struct ConvSpanDst {
    float2* xs;
    int S;
    unsigned magic;
    __device__ __forceinline__ float2* operator()(int s) const {
        return xs + span_pad(s, S, magic);
    }
};

// Rows 0 .. R·Q−1 of the taps matrix as float4 (phases 0..P−1, then +0),
// +0 at rows ≥ w_len.
__device__ __forceinline__ void conv_load_taps(float4* __restrict__ dst,
                                               const float* __restrict__ taps,
                                               const ConvArgs& a, int tid,
                                               int nthreads) {
    float* d = reinterpret_cast<float*>(dst);
#pragma unroll 4
    for (int e = tid; e < 4 * a.R * a.Q; e += nthreads) {
        const int row = e >> 2, p = e & 3;
        if (row < a.w_len && p < a.P) {
            smem_copy(d + e, taps + (size_t)row * a.P + p);
        } else {
            d[e] = 0.0f;
        }
    }
}

__device__ __forceinline__ float lane4(const float4& w, int p) {
    return p == 0 ? w.x : (p == 1 ? w.y : (p == 2 ? w.z : w.w));
}

// One step q of a term: x's (I, Q) against the P phases' taps.
template <int P>
__device__ __forceinline__ void conv_fma(const float2 v, const float4 t,
                                         float* ti, float* tq) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
        ti[p] = __fmaf_rn(v.x, lane4(t, p), ti[p]);
        tq[p] = __fmaf_rn(v.y, lane4(t, p), tq[p]);
    }
}

// Thread g of the tile holds cycle k_lo + g: its row of x starts at span
// position g·Q, padded g·(Q+1), and term r's Q samples follow r·(Q+1) later.
template <int P>
__device__ __forceinline__ void conv_tile_dot(const float2* __restrict__ xs,
                                              const float4* __restrict__ taps,
                                              float* __restrict__ yi,
                                              float* __restrict__ yq,
                                              const ConvArgs& a,
                                              const ConvPlan& w, int tid,
                                              int nthreads) {
    const int Q = a.Q, R = a.R;
    for (int g = tid; g < a.tile; g += nthreads) {
        const float2* xg = xs + g * (Q + 1);
        float ai[P], aq[P];
        for (int r = 0; r < R; ++r) {
            const float2* xb = xg + r * (Q + 1);
            const float4* tb = taps + r * Q;
            float ti[P], tq[P];
#pragma unroll
            for (int p = 0; p < P; ++p) ti[p] = tq[p] = 0.0f;
            // four steps' loads issued before their FMAs: with one pair of
            // registers reused a step, each load waited for the FMAs before it
            int q = 0;
            for (; q + 4 <= Q; q += 4) {
                float2 v[4];
                float4 t[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    v[u] = xb[q + u];
                    t[u] = tb[q + u];
                }
#pragma unroll
                for (int u = 0; u < 4; ++u) conv_fma<P>(v[u], t[u], ti, tq);
            }
            for (; q < Q; ++q) conv_fma<P>(xb[q], tb[q], ti, tq);
#pragma unroll
            for (int p = 0; p < P; ++p) {
                ai[p] = r == 0 ? ti[p] : __fadd_rn(ai[p], ti[p]);
                aq[p] = r == 0 ? tq[p] : __fadd_rn(aq[p], tq[p]);
            }
        }
#pragma unroll
        for (int p = 0; p < P; ++p) {
            const long long m = (w.k_lo + g) * P + p - a.p0;
            if (m >= 0 && m < a.M) {
                yi[(size_t)w.ch * a.M + m] = ai[p];
                yq[(size_t)w.ch * a.M + m] = aq[p];
            }
        }
    }
}

template <int P>
__device__ __forceinline__ bool conv_tile_phase(
        const float* __restrict__ xi, const float* __restrict__ xq,
        const float* __restrict__ taps, float* __restrict__ yi,
        float* __restrict__ yq, const ConvArgs& a, const ConvPlan& w, int tid,
        int nthreads, int ph, float* smem) {
    float4* taps4 = reinterpret_cast<float4*>(smem + a.tap_off);
    float2* xs = reinterpret_cast<float2*>(smem + a.buf_off);
    if (ph == 0) {
        conv_load_taps(taps4, taps, a, tid, nthreads);
        const size_t row = (size_t)w.ch * a.x_stride;
        span_fill<true>(xi + row, xq + row, a.len, a.start0 + w.k_lo * a.Q,
                        (a.tile + a.R - 1) * a.Q, tid, nthreads,
                        ConvSpanDst{xs, a.Q, a.magic});
        smem_copy_wait();
        return true;
    }
    conv_tile_dot<P>(xs, taps4, yi, yq, a, w, tid, nthreads);
    return false;
}

// -- the rows path ------------------------------------------------------------

struct ConvChunkDst {
    float2* xs;
    __device__ __forceinline__ float2* operator()(int i) const { return xs + i; }
};

// Phase `ph` of a rows CTA: even phases stage chunk ph/2 (term group
// ⌊ph/2 / chunks⌋, columns q0 .. q0+qn−1 of the rows of x its terms read
// and of its outputs' taps), odd phases feed it to the open terms; the last
// chunk of a group closes its terms, the last phase stores.  x sits as
// [channel][row][column] at buf_off, the taps as [term][output][column] at
// tap_off (a column qs floats, 4 mod 32: lanes that read 16 bytes each
// meet different banks).  Threads past the tile's outputs only stage.
template <int CG, int RG>
__device__ __forceinline__ bool conv_rows_phase(
        const float* __restrict__ xi, const float* __restrict__ xq,
        const float* __restrict__ taps, float* __restrict__ yi,
        float* __restrict__ yq, const ConvArgs& a, const ConvPlan& w, int tid,
        int nthreads, int ph, float* smem, ConvRowsState<CG, RG>& st) {
    const int Q = a.Q, R = a.R, NJ = a.tile;
    const int chunks = (Q + a.qc - 1) / a.qc;
    const int step = ph >> 1, grp = step / chunks, r0 = grp * RG;
    const int q0 = (step - grp * chunks) * a.qc;
    const int qn = Q - q0 < a.qc ? Q - q0 : a.qc;
    const int nb = w.kspan + RG - 1;        // rows of x a group reads
    float2* xs = reinterpret_cast<float2*>(smem + a.buf_off);
    float* ts = smem + a.tap_off;
    if ((ph & 1) == 0) {
        if (ph == 0) {
#pragma unroll
            for (int cl = 0; cl < CG; ++cl) st.ai[cl] = st.aq[cl] = 0.0f;
        }
        // thread t copies column jj = t mod NJ (output m_lo + jj, taps column
        // (p0 + m_lo + jj) mod P) of the rows q0 + k, k ≡ t / NJ (mod
        // nthreads / NJ): no division a word
        const int jj = tid % NJ, k0 = tid / NJ, dk = nthreads / NJ;
        const int pj = (int)((a.p0 + w.m_lo + jj) % a.P);
        for (int rr = 0; rr < RG; ++rr) {
            const int r = r0 + rr;
            const float* src = taps + (size_t)(r * Q + q0) * a.P + pj;
            float* d = ts + (rr * NJ + jj) * a.qs;
            // the rows of this chunk below w_len (the rest are zero taps)
            const int below = a.w_len - (r * Q + q0);
            const int n_tap = (r < R && jj < w.cnt)
                ? (below < 0 ? 0 : (below < qn ? below : qn)) : 0;
#pragma unroll 4
            for (int qq = k0; qq < qn; qq += dk) {
                if (qq < n_tap) {
                    smem_copy(d + qq, src + (size_t)qq * a.P);
                } else {
                    d[qq] = 0.0f;
                }
            }
        }
        for (int cl = 0; cl < CG; ++cl) {
            const bool on = w.ch + cl < a.C;
            const size_t row = (size_t)(on ? w.ch + cl : 0) * a.x_stride;
            for (int bb = 0; bb < nb; ++bb) {
                const long long b_lo = a.start0 + (w.k_lo + r0 + bb) * Q + q0;
                span_fill<true>(xi + row, xq + row, on ? a.len : 0, b_lo, qn, tid,
                                nthreads, ConvChunkDst{xs + (cl * nb + bb) * a.qc});
            }
        }
        smem_copy_wait();
        return true;
    }
    const bool mine = tid < w.cnt;
    const long long f = a.p0 + w.m_lo + (mine ? tid : 0);
    const int kk = (int)(div_nonneg(f, a.P) - w.k_lo);
    if (q0 == 0) {
#pragma unroll
        for (int cl = 0; cl < CG; ++cl) {
#pragma unroll
            for (int rr = 0; rr < RG; ++rr) st.ti[cl][rr] = st.tq[cl][rr] = 0.0f;
        }
    }
    if (mine) {
        // four columns a step: one 16-byte load of a term's taps, two of
        // each channel's x (a broadcast), 8·CG FMAs, each chain in q order
        const int nr = R - r0 < RG ? R - r0 : RG;
        const float* tp = ts + tid * a.qs;
        const float2* xp = xs + kk * a.qc;
        const int q4 = qn & ~3;
        int qq = 0;
#pragma unroll 2
        for (; qq < q4; qq += 4) {
#pragma unroll
            for (int rr = 0; rr < RG; ++rr) {
                if (rr >= nr) break;
                const float4 t = *reinterpret_cast<const float4*>(
                    tp + rr * NJ * a.qs + qq);
#pragma unroll
                for (int cl = 0; cl < CG; ++cl) {
                    const float4* xv = reinterpret_cast<const float4*>(
                        xp + (cl * nb + rr) * a.qc + qq);
                    const float4 v01 = xv[0], v23 = xv[1];
                    float& ai = st.ti[cl][rr];
                    float& aq = st.tq[cl][rr];
                    ai = __fmaf_rn(v01.x, t.x, ai);
                    aq = __fmaf_rn(v01.y, t.x, aq);
                    ai = __fmaf_rn(v01.z, t.y, ai);
                    aq = __fmaf_rn(v01.w, t.y, aq);
                    ai = __fmaf_rn(v23.x, t.z, ai);
                    aq = __fmaf_rn(v23.y, t.z, aq);
                    ai = __fmaf_rn(v23.z, t.w, ai);
                    aq = __fmaf_rn(v23.w, t.w, aq);
                }
            }
        }
        for (; qq < qn; ++qq) {
#pragma unroll
            for (int rr = 0; rr < RG; ++rr) {
                if (rr >= nr) break;
                const float t = tp[rr * NJ * a.qs + qq];
#pragma unroll
                for (int cl = 0; cl < CG; ++cl) {
                    const float2 v = xp[(cl * nb + rr) * a.qc + qq];
                    st.ti[cl][rr] = __fmaf_rn(v.x, t, st.ti[cl][rr]);
                    st.tq[cl][rr] = __fmaf_rn(v.y, t, st.tq[cl][rr]);
                }
            }
        }
    }
    if (q0 + qn < Q) return true;
    // the group's terms are whole: add them in order
#pragma unroll
    for (int rr = 0; rr < RG; ++rr) {
        const int r = r0 + rr;
        if (r >= R) break;
#pragma unroll
        for (int cl = 0; cl < CG; ++cl) {
            st.ai[cl] = r == 0 ? st.ti[cl][rr] : __fadd_rn(st.ai[cl], st.ti[cl][rr]);
            st.aq[cl] = r == 0 ? st.tq[cl][rr] : __fadd_rn(st.aq[cl], st.tq[cl][rr]);
        }
    }
    if (r0 + RG < R) return true;
    if (mine) {
        const long long m = w.m_lo + tid;
#pragma unroll
        for (int cl = 0; cl < CG; ++cl) {
            if (w.ch + cl < a.C) {
                yi[(size_t)(w.ch + cl) * a.M + m] = st.ai[cl];
                yq[(size_t)(w.ch + cl) * a.M + m] = st.aq[cl];
            }
        }
    }
    return false;
}

// ConvArgs from doppler_conv's arguments (below); false where they are not
// ones the kernel takes.  layout: rows, tile, cg, rg, qc, tap_off, buf_off
// (ops/cuda/geometry.py ConvLayout.args).
inline bool make_conv_args(ConvArgs& a, int C, long long len, long long x_stride,
                           long long M, long long start0, int p0, int P, int Q,
                           int R, int w_len, const int* layout) {
    if (C < 1 || M < 1 || P < 1 || Q < 1 || R < 1 || w_len < 1 || w_len > R * Q
            || p0 < 0 || p0 >= P || len < 0 || x_stride < len)
        return false;
    a = ConvArgs{};
    a.len = len;
    a.x_stride = x_stride;
    a.M = M;
    a.start0 = start0;
    a.C = C;
    a.P = P;
    a.Q = Q;
    a.R = R;
    a.w_len = w_len;
    a.p0 = p0;
    a.rows = layout[0];
    a.tile = layout[1];
    a.cg = layout[2];
    a.rg = layout[3];
    a.qc = layout[4];
    a.tap_off = layout[5];
    a.buf_off = layout[6];
    if (a.tile < 1 || a.buf_off % 4 || a.tap_off % 4) return false;
    if (a.rows) {
        if ((a.cg != 1 && a.cg != 2 && a.cg != 4) || (a.rg != 1 && a.rg != 2)
                || a.qc < 4 || a.qc % 4)
            return false;
        a.qs = ((a.qc + 31) & ~31) + 4;
        a.groups = (C + a.cg - 1) / a.cg;
        a.n_tiles = (int)((M + a.tile - 1) / a.tile);
    } else {
        if (P > 4) return false;
        a.groups = C;
        const long long cycles = (p0 + M - 1) / P + 1;
        a.n_tiles = (int)((cycles + a.tile - 1) / a.tile);
        a.magic = Q > 1 ? (unsigned)((0x100000000ULL + Q - 1) / Q) : 0u;
    }
    return true;
}

}  // namespace doppler

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using doppler::ConvArgs;

constexpr int kConvMaxThreads = 256;

template <int P>
__global__ void __launch_bounds__(kConvMaxThreads)
conv_tile_kernel(const float* __restrict__ xi, const float* __restrict__ xq,
                 const float* __restrict__ taps, float* __restrict__ yi,
                 float* __restrict__ yq, const __grid_constant__ ConvArgs a) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ doppler::ConvPlan plan;
    if (threadIdx.x == 0) doppler::conv_plan<false>(a, blockIdx.x, plan);
    __syncthreads();
    for (int ph = 0;; ++ph) {
        if (!doppler::conv_tile_phase<P>(xi, xq, taps, yi, yq, a, plan,
                                             (int)threadIdx.x, (int)blockDim.x,
                                             ph, smem))
            break;
        __syncthreads();
    }
}

template <int CG, int RG>
__global__ void __launch_bounds__(kConvMaxThreads)
conv_rows_kernel(const float* __restrict__ xi, const float* __restrict__ xq,
                 const float* __restrict__ taps, float* __restrict__ yi,
                 float* __restrict__ yq, const __grid_constant__ ConvArgs a) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    __shared__ doppler::ConvPlan plan;
    if (threadIdx.x == 0) doppler::conv_plan<true>(a, blockIdx.x, plan);
    __syncthreads();
    doppler::ConvRowsState<CG, RG> st;
    for (int ph = 0;; ++ph) {
        if (!doppler::conv_rows_phase<CG, RG>(xi, xq, taps, yi, yq, a, plan,
                                              (int)threadIdx.x, (int)blockDim.x,
                                              ph, smem, st))
            break;
        __syncthreads();
    }
}

using Kernel = void (*)(const float*, const float*, const float*, float*, float*,
                        const ConvArgs);

Kernel pick(const ConvArgs& a) {
    if (a.rows) {
        const int i = (a.cg == 1 ? 0 : a.cg == 2 ? 1 : 2) * 2 + (a.rg - 1);
        static const Kernel k[6] = {conv_rows_kernel<1, 1>, conv_rows_kernel<1, 2>,
                                    conv_rows_kernel<2, 1>, conv_rows_kernel<2, 2>,
                                    conv_rows_kernel<4, 1>, conv_rows_kernel<4, 2>};
        return k[i];
    }
    static const Kernel k[4] = {conv_tile_kernel<1>, conv_tile_kernel<2>,
                                conv_tile_kernel<3>, conv_tile_kernel<4>};
    return k[a.P - 1];
}

}  // namespace

// xi, xq: (C, x_stride) float32 rows of len samples; taps: (w_len, P);
// yi, yq: (C, M).  layout: 7 ints, threads and smem as ops/cuda/geometry.py
// pick_conv lays them out.  Returns cudaGetLastError() after the launch.
extern "C" int doppler_conv(const float* xi, const float* xq, const float* taps,
                            float* yi, float* yq, int C, long long len,
                            long long x_stride, long long M, long long start0,
                            int p0, int P, int Q, int R, int w_len,
                            const int* layout, int threads, long long smem,
                            void* stream) {
    ConvArgs a;
    if (threads < 1 || threads > kConvMaxThreads || smem <= 0
            || !doppler::make_conv_args(a, C, len, x_stride, M, start0, p0, P, Q,
                                        R, w_len, layout)
            || (a.rows && (threads < a.tile || threads % a.tile)))
        return (int)cudaErrorInvalidValue;
    const long long grid = (long long)a.groups * a.n_tiles;
    if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    Kernel kernel = pick(a);
    // beyond 48 KB with the static plan, the CTA must opt in
    if (smem + 1024 > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, threads, (size_t)smem,
             static_cast<cudaStream_t>(stream)>>>(xi, xq, taps, yi, yq, a);
    return (int)cudaGetLastError();
}

#endif  // __CUDACC__
