// The bf16 tensor-core FIR dot of the kernels of --precision fast: the
// chain's (chain_fast.cu) and the cascade's (cascade_fast.cu).
//
// One stage computes, for output j = P·i + p (window i, phase p,
// off_p = ⌊p·Q/P⌋, bank row (p·Q) mod P, as in fir.cuh), the banded
// (Toeplitz) product
//     Y[i, p] = Σ_k A[i, k]·G[k, p],   A[i, k] = x[Q·i − (T−1) − lead + k],
//     G[k, p] = t[p, T−1 + lead + off_p − k] where that tap exists, else 0,
// k < K = 16·ks, ks = ⌈(T + lead + off_{P−1})/16⌉, lead = (1 − T) mod 4 (so
// that span entry 0 is 4-aligned): row i of A is a window of a span of x
// held in shared memory as four bf16 planes I_h, I_l, Q_h, Q_l
// (x_h = bf16(x), x_l = bf16(x − x_h), ops/precision.py), and G is the TPU
// kernels' banded taps matrix with its per-128-row slices joined, laid out
// as the mma's B fragments.  A warp owns 16 windows × 8 phases; a k-step is
// one ldmatrix.x4 a plane (16-bit or 32-bit loads where Q < 8) and, for
// kPasses = 3 (dot_precision 'split3'), three mma.sync.m16n8k16.bf16
// (float32 accumulation) a plane, hh, hl and lh, each into a fresh
// accumulator, added as (hh + hl) + lh to the output's running sum with
// __fadd_rn: the tensor core's own rounding touches one product's 16-term
// partial sum only.  kPasses = 1 (dot_precision 'default', one bf16 pass as
// the TPU's DEFAULT dot) takes hh alone, and neither stores nor reads the
// low planes.
//
// Bytes.  An output's k-steps run in one order (k ascending), its row in
// its mma is i mod 16 (the callers start every tile at a multiple of 16
// windows) and its column p mod 8; there is no split-K and no atomic.  So
// its bytes depend on its band of x alone, not on which CTA or warp
// computes it.  They are not the plain version's: a tensor core does not
// add as IEEE float32 does.
//
// NaN.  G's zeros multiply real x: a NaN or ±∞ at x[n] reaches all P
// outputs of every window whose band, x[Q·i − (T−1) − lead] and the K − 1
// samples after it, holds n: wider than the exact kernels' T-window (as the
// TPU kernels' zero-padded taps matrices are, chain.py:87-119); ±∞ splits
// into x_l = NaN.  So every span entry a band reads must be written (zeros
// where there is no sample): the callers fill the whole span.
#pragma once

#include "fir.cuh"

#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace doppler {

// bf16 bits of v rounded to nearest even (astype(bfloat16)), and back.
__device__ __forceinline__ uint16_t bf16_rn(float v) {
#ifdef __CUDACC__
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
#else
    const unsigned u = __float_as_uint(v);
    if ((u & 0x7FFFFFFFu) > 0x7F800000u) return (uint16_t)((u >> 16) | 0x40u);
    return (uint16_t)((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
#endif
}

__device__ __forceinline__ float bf16_float(uint16_t b) {
    return __uint_as_float((unsigned)b << 16);
}

__device__ __forceinline__ unsigned pack2(uint16_t lo, uint16_t hi) {
    return (unsigned)lo | ((unsigned)hi << 16);
}

// One stage's dot as the kernels see it (ops/cuda/geometry.py fast_layout
// lays out the shared memory; fast_derive the rest).
struct FastDot {
    int P, Q, T;
    int lq;                 // log2 Q
    int pad;                // bf16 entries after every Q entries of a plane
    int lead;               // (1 − T) mod 4: band columns below the taps
    int ks, nt;             // k-steps of 16, N-tiles of 8 phases
    int plane;              // bf16 entries a plane: a multiple of 8
    int g_off, x_off;       // word offsets of the B fragments and the planes
    const uint16_t* bank_h; // (P, T) bf16
    const uint16_t* bank_l;
};

// The derived fields of a stage; false unless P, Q, T > 0 and Q is a power
// of two (the planes' pads and indices shift by log2 Q).
__host__ __device__ inline bool fast_derive(FastDot& d, int P, int Q, int T) {
    if (P <= 0 || Q <= 0 || T <= 0 || (Q & (Q - 1))) return false;
    d.P = P;
    d.Q = Q;
    d.T = T;
    d.lq = 0;
    while ((1 << d.lq) < Q) ++d.lq;
    d.pad = Q >= 16 ? 8 : 0;
    d.lead = (4 - (T - 1) % 4) % 4;
    d.ks = (T + d.lead + ((P - 1) * Q) / P + 15) / 16;
    d.nt = (P + 7) / 8;
    return true;
}

// Padded plane index of span entry k.
__host__ __device__ __forceinline__ int fast_pidx(const FastDot& g, int k) {
    return k + g.pad * (k >> g.lq);
}

// Whether a span of `len` entries fits the planes, and the fragments and
// the planes lie apart inside `smem` bytes.
__host__ __device__ inline bool fast_fits(const FastDot& g, long long len,
                                          long long smem) {
    if (len < 1 || g.plane <= 0 || g.plane % 8 || g.g_off < 0 || g.g_off % 4 ||
        g.x_off < 0 || g.x_off % 4 || len > 0x7FFFFFFFLL)
        return false;
    const long long g_end = g.g_off + 128LL * g.ks * g.nt;
    const long long x_end = g.x_off + 2LL * g.plane;
    return fast_pidx(g, (int)(len - 1)) < g.plane &&
           (g_end <= g.x_off || x_end <= g.g_off) &&
           4 * (g_end > x_end ? g_end : x_end) <= smem;
}

// Two neighbouring entries k, k + 1 of G's column for a phase whose bank
// row is `row` and whose tap l sits at k = top − l, top = T−1 + lead + off_p.
__device__ __forceinline__ unsigned fast_taps2(const uint16_t* __restrict__ row,
                                               int top, int T, int k) {
    const int l0 = top - k, l1 = l0 - 1;
    return pack2((l0 >= 0 && l0 < T) ? row[l0] : (uint16_t)0,
                 (l1 >= 0 && l1 < T) ? row[l1] : (uint16_t)0);
}

// G as B fragments at smem + g_off: for k-step s, N-tile n and lane
// (g = lane/4, q = lane%4) the words {t_h(k0, k0+1), t_h(k0+8, k0+9),
// t_l(k0, k0+1), t_l(k0+8, k0+9)} of column p = 8n + g, k0 = 16s + 2q: one
// 16-byte load a lane and k-step.  nthreads is a multiple of 32, so a
// thread keeps its lane, and its column.
__device__ __forceinline__ void fast_load_taps(unsigned* __restrict__ smem,
                                               const FastDot& g, int tid,
                                               int nthreads) {
    unsigned* gf = smem + g.g_off;
    const int lane = tid & 31;
    for (int n = 0; n < g.nt; ++n) {
        const int p = 8 * n + (lane >> 2);
        const int top = g.T - 1 + g.lead + (p * g.Q) / g.P;
        const int row = ((p * g.Q) % g.P) * g.T;
        const uint16_t* rh = g.bank_h + row;
        const uint16_t* rl = g.bank_l + row;
        for (int s = tid >> 5; s < g.ks; s += nthreads >> 5) {
            const int k0 = 16 * s + 2 * (lane & 3);
            uint4 w = make_uint4(0u, 0u, 0u, 0u);
            if (p < g.P)
                w = make_uint4(fast_taps2(rh, top, g.T, k0),
                               fast_taps2(rh, top, g.T, k0 + 8),
                               fast_taps2(rl, top, g.T, k0),
                               fast_taps2(rl, top, g.T, k0 + 8));
            reinterpret_cast<uint4*>(gf)[(s * g.nt + n) * 32 + lane] = w;
        }
    }
}

// The store of a span: one sample split into the four planes, or a group
// of four (span entries k .. k+3, k ≡ 0 mod 4, never across a pad) as one
// 8-byte store a plane.  One pass reads no low plane and stores none: its
// planes keep split3's places, so its shared memory is split3's.
template <int kPasses>
struct SplitStore {
    uint16_t* xs;           // I_h; I_l, Q_h, Q_l `plane` entries apart
    const FastDot* g;
    long long origin;       // x index of span entry 0, ≡ 0 (mod 4)
    __device__ __forceinline__ void operator()(long long n, float vi,
                                               float vq) const {
        const int k = fast_pidx(*g, (int)(n - origin));
        const float v[2] = {vi, vq};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const uint16_t h = bf16_rn(v[c]);
            xs[(2 * c) * g->plane + k] = h;
            if (kPasses == 3)
                xs[(2 * c + 1) * g->plane + k] = bf16_rn(__fsub_rn(v[c], bf16_float(h)));
        }
    }
    __device__ __forceinline__ void group(long long n, const float* vi,
                                          const float* vq) const {
        const int k = fast_pidx(*g, (int)(n - origin));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            uint16_t h[4], l[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float v = c ? vq[i] : vi[i];
                h[i] = bf16_rn(v);
                l[i] = bf16_rn(__fsub_rn(v, bf16_float(h[i])));
            }
            put4(xs + (2 * c) * g->plane + k, h);
            if (kPasses == 3) put4(xs + (2 * c + 1) * g->plane + k, l);
        }
    }
    __device__ __forceinline__ static void put4(uint16_t* p, const uint16_t* v) {
#ifdef __CUDACC__
        *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
#else
        for (int i = 0; i < 4; ++i) p[i] = v[i];
#endif
    }
};

// Entries idx, idx+1 of a plane as one word (the lower k in the low half):
// one 4-byte load where Q is even (idx is then even), else two.
template <bool kOddQ>
__device__ __forceinline__ unsigned fast_pair(const uint16_t* __restrict__ plane,
                                              int idx) {
#ifdef __CUDACC__
    if (!kOddQ) return *reinterpret_cast<const unsigned*>(plane + idx);
#endif
    return pack2(plane[idx], plane[idx + 1]);
}

// The A fragments of the planes for rows r0, r0 + 8 of the tile and
// columns k, k + 1, k + 8, k + 9: a[plane][reg] in the PTX layout
// (reg 0: row r0, k; 1: row r0 + 8, k; 2: row r0, k + 8; 3: row r0 + 8,
// k + 8); one pass reads the high planes only.  A pair never straddles a
// pad: pads follow an even count of entries wherever there are any.
template <int kPasses, bool kOddQ>
__device__ __forceinline__ void fast_a(const FastDot& g,
                                       const uint16_t* __restrict__ xs, int r0,
                                       int k, unsigned (&a)[4][4]) {
    const int k00 = g.Q * r0 + k, k10 = k00 + 8 * g.Q;
    const int idx[4] = {fast_pidx(g, k00), fast_pidx(g, k10),
                        fast_pidx(g, k00 + 8), fast_pidx(g, k10 + 8)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        if (kPasses == 1 && (c & 1)) continue;
#pragma unroll
        for (int r = 0; r < 4; ++r) a[c][r] = fast_pair<kOddQ>(xs + c * g.plane, idx[r]);
    }
}

#ifdef __CUDACC__
// fast_a for even Q ≥ 8 as one ldmatrix.x4 a plane: lane L gives the row
// (L & 7) + 8·((L >> 3) & 1) of the tile and the columns k + 8·(L >> 4),
// 16 bytes aligned (Q·row, k and the pads are multiples of 8 entries).
template <int kPasses>
__device__ __forceinline__ void fast_a_ldm(const FastDot& g,
                                           const uint16_t* __restrict__ xs,
                                           int mt, int s, int lane,
                                           unsigned (&a)[4][4]) {
    const int row = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int idx = fast_pidx(g, g.Q * row + 16 * s + 8 * (lane >> 4));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        if (kPasses == 1 && (c & 1)) continue;
        const unsigned addr =
            (unsigned)__cvta_generic_to_shared(xs + c * g.plane + idx);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[c][0]), "=r"(a[c][1]), "=r"(a[c][2]), "=r"(a[c][3])
                     : "r"(addr));
    }
}
#endif

__device__ __forceinline__ uint4 fast_b(const unsigned* __restrict__ gf,
                                        const FastDot& g, int s, int n, int lane) {
    return reinterpret_cast<const uint4*>(gf)[(s * g.nt + n) * 32 + lane];
}

// A lane's four results (rows r0, r0 + 8; phases p, p + 1) to the sink,
// output j = (i0 + row)·P + p for the rows under n_rows.
template <class Sink>
__device__ __forceinline__ void fast_put(const FastDot& g, long long i0,
                                         int n_rows, int mt, int n, int lane,
                                         const float* ci, const float* cq,
                                         Sink& sink) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int r = 16 * mt + (lane >> 2) + 8 * (e >> 1);
        const int p = 8 * n + 2 * (lane & 3) + (e & 1);
        if (r < n_rows && p < g.P) sink.put((i0 + r) * g.P + p, ci[e], cq[e]);
    }
}

#ifdef __CUDACC__

// d += a·b, m16n8k16, bf16 operands, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp item: 16 windows (M-tile mt of the span's windows, the first at
// i0) × 8 phases (N-tile n).  A k-step's passes go into fresh accumulators
// (independent mma), added as (hh + hl) + lh to the running sum.
template <int kPasses, bool kOddQ, class Sink>
__device__ __forceinline__ void fast_item(const FastDot& g,
                                          const unsigned* __restrict__ smem,
                                          long long i0, int n_rows, int mt, int n,
                                          int lane, Sink& sink) {
    const unsigned* gf = smem + g.g_off;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(smem + g.x_off);
    const int r0 = 16 * mt + (lane >> 2);
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int s = 0; s < g.ks; ++s) {
        unsigned a[4][4];
        if (!kOddQ && g.Q >= 8) {
            fast_a_ldm<kPasses>(g, xs, mt, s, lane, a);
        } else {
            fast_a<kPasses, kOddQ>(g, xs, r0, 16 * s + 2 * (lane & 3), a);
        }
        const uint4 b = fast_b(gf, g, s, n, lane);
#pragma unroll
        for (int c = 0; c < 2; ++c) {               // I, then Q
            float hh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(hh, a[2 * c], b.x, b.y);       // x_h · t_h
            if (kPasses == 1) {
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[c][e] = __fadd_rn(acc[c][e], hh[e]);
                continue;
            }
            float hl[4] = {0.0f, 0.0f, 0.0f, 0.0f}, lh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(hl, a[2 * c], b.z, b.w);       // x_h · t_l
            mma_bf16(lh, a[2 * c + 1], b.x, b.y);   // x_l · t_h
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[c][e] = __fadd_rn(acc[c][e], __fadd_rn(__fadd_rn(hh[e], hl[e]), lh[e]));
        }
    }
    fast_put(g, i0, n_rows, mt, n, lane, acc[0], acc[1], sink);
}

#else  // a host compiler: a warp's 32 lanes at once

// d += a·b for the 32 lanes' fragments in the PTX layout of
// mma.m16n8k16.row.col: each result a float fmaf chain over k = 0..15.
inline void mma_bf16_warp(float (*d)[4], const unsigned (*a)[4],
                          const unsigned (*b)[2]) {
    auto half = [](unsigned w, int k) {
        return bf16_float((uint16_t)((k & 1) ? w >> 16 : w & 0xFFFFu));
    };
    for (int lane = 0; lane < 32; ++lane) {
        for (int e = 0; e < 4; ++e) {
            const int row = (lane >> 2) + 8 * (e >> 1), col = 2 * (lane & 3) + (e & 1);
            float acc = d[lane][e];
            for (int k = 0; k < 16; ++k) {
                const int q = (k & 7) >> 1;
                const float av = half(a[4 * (row & 7) + q][(row >> 3) + 2 * (k >> 3)], k);
                const float bv = half(b[4 * col + q][k >> 3], k);
                acc = __fmaf_rn(av, bv, acc);
            }
            d[lane][e] = acc;
        }
    }
}

template <int kPasses, bool kOddQ, class Sink>
void fast_item_warp(const FastDot& g, const unsigned* smem, long long i0,
                    int n_rows, int mt, int n, Sink& sink) {
    const unsigned* gf = smem + g.g_off;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(smem + g.x_off);
    float acc[2][32][4] = {};
    for (int s = 0; s < g.ks; ++s) {
        unsigned a[4][32][4] = {}, bh[32][2], bl[32][2];
        for (int lane = 0; lane < 32; ++lane) {
            unsigned al[4][4] = {};
            fast_a<kPasses, kOddQ>(g, xs, 16 * mt + (lane >> 2), 16 * s + 2 * (lane & 3), al);
            for (int c = 0; c < 4; ++c)
                for (int r = 0; r < 4; ++r) a[c][lane][r] = al[c][r];
            const uint4 b = fast_b(gf, g, s, n, lane);
            bh[lane][0] = b.x;
            bh[lane][1] = b.y;
            bl[lane][0] = b.z;
            bl[lane][1] = b.w;
        }
        for (int c = 0; c < 2; ++c) {
            float hh[32][4] = {}, hl[32][4] = {}, lh[32][4] = {};
            mma_bf16_warp(hh, a[2 * c], bh);
            if (kPasses == 3) {
                mma_bf16_warp(hl, a[2 * c], bl);
                mma_bf16_warp(lh, a[2 * c + 1], bh);
            }
            for (int lane = 0; lane < 32; ++lane)
                for (int e = 0; e < 4; ++e)
                    acc[c][lane][e] = kPasses == 1
                        ? __fadd_rn(acc[c][lane][e], hh[lane][e])
                        : __fadd_rn(acc[c][lane][e],
                                    __fadd_rn(__fadd_rn(hh[lane][e], hl[lane][e]),
                                              lh[lane][e]));
        }
    }
    for (int lane = 0; lane < 32; ++lane)
        fast_put(g, i0, n_rows, mt, n, lane, acc[0][lane], acc[1][lane], sink);
}

#endif  // __CUDACC__

// Every warp item of a span's windows i0 .. i0 + n_rows − 1 (the span's
// first window i0 a multiple of 16), shared out over the CTA's warps.
template <int kPasses, bool kOddQ, class Sink>
__device__ __forceinline__ void fast_items(const FastDot& g,
                                           const unsigned* __restrict__ smem,
                                           long long i0, int n_rows, int tid,
                                           int nthreads, Sink& sink) {
    const int n_items = (n_rows + 15) / 16 * g.nt;
    for (int item = tid >> 5; item < n_items; item += nthreads >> 5) {
        const int mt = item / g.nt, n = item - mt * g.nt;
#ifdef __CUDACC__
        fast_item<kPasses, kOddQ>(g, smem, i0, n_rows, mt, n, tid & 31, sink);
#else
        if ((tid & 31) == 0) fast_item_warp<kPasses, kOddQ>(g, smem, i0, n_rows, mt, n, sink);
#endif
    }
}

}  // namespace doppler
