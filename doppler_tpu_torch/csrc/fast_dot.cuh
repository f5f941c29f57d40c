// The bf16 tensor-core FIR dot of the kernels of --precision fast: the
// chain's (chain_fast.cu) and the cascade's (cascade_fast.cu).
//
// One stage computes, for output j = P·i + p (window i, phase p,
// off_p = ⌊p·Q/P⌋, bank row (p·Q) mod P, as in fir.cuh), the banded
// (Toeplitz) product of D neighbouring windows a row:
//     Y[r, (d, p)] = Σ_k A[r, k]·G[k, (d, p)],  window i = D·r + d,
//     A[r, k] = x[S·r − (T−1) − lead + k],  S = D·Q,
//     G[k, (d, p)] = t[p, T−1 + lead + off_p + Q·d − k] where that tap
//     exists, else 0,
// k < K = 16·ks, ks = ⌈(T + lead + off_{P−1} + Q·(D−1))/16⌉, lead =
// (1 − T) mod 4 (so that span entry 0 is 4-aligned): row r of A is a
// stretch of a span of x held in shared memory as bf16 planes — I_h, I_l,
// Q_h, Q_l, or I_h, Q_h alone where the dot takes one pass and is laid out
// compact — (x_h = bf16(x), x_l = bf16(x − x_h), ops/precision.py), and G
// is the TPU kernels' banded taps matrix with its per-128-row slices
// joined, its D·P ≤ 8 columns (d, p) at d·P + p, laid out as the mma's B
// fragments.  D = 1 is the TPU's own layout, a window a row; the kernels
// take the largest power of two with D·P ≤ 8 that tiles every block
// (ops/cuda/geometry.py fast_columns; the cascade per stage), which fills
// D·P of the mma's 8 columns where one window fills P, for a band (D − 1)·Q
// wider.  A warp owns 16 rows × 8 columns; a k-step is one ldmatrix.x4 a
// plane (16-bit or 32-bit loads where S < 8) and, for
// kPasses = 3 (dot_precision 'split3'), three mma.sync.m16n8k16.bf16
// (float32 accumulation) a plane, hh, hl and lh, each into a fresh
// accumulator, added as (hh + hl) + lh to the output's running sum with
// __fadd_rn: the tensor core's own rounding touches one product's 16-term
// partial sum only.  kPasses = 1 (dot_precision 'default', one bf16 pass as
// the TPU's DEFAULT dot) takes hh alone, and neither stores nor reads the
// low planes.
//
// Bytes.  An output's k-steps run in one order (k ascending), its row in
// its mma is ⌊i/D⌋ mod 16 (the callers start every tile at a multiple of
// 16·D windows) and its column (i mod D)·P + p; there is no split-K and no
// atomic.  So its bytes depend on its band of x alone, not on which CTA or
// warp computes it.  They are not the plain version's: a tensor core does
// not add as IEEE float32 does.
//
// NaN.  G's zeros multiply real x: a NaN or ±∞ at x[n] reaches all D·P
// outputs of every row whose band, x[S·r − (T−1) − lead] and the K − 1
// samples after it, holds n: wider than the exact kernels' T-window (as the
// TPU kernels' zero-padded taps matrices are, chain.py:87-119), and at
// D > 1 (D − 1)·Q wider again; ±∞ splits into x_l = NaN.  So every span
// entry a band reads must be written (zeros where there is no sample): the
// callers fill the whole span.
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

// What a launch of a fast kernel runs: the whole kernel, or one of its two
// halves alone, so that a timing can tell how much of the whole each costs
// (chip_smoke.py phase 6).  kMixOnly: the dot is cut; each warp XORs the
// span's words into a side word, which keeps every mixed sample alive.
// kDotOnly: the mix is cut; 16-byte stores fill the span with zeros (a
// tensor core takes as long over zeros), and the dot's outputs are stored
// as the whole kernel stores them.
enum FastPart { kWhole = 0, kMixOnly = 1, kDotOnly = 2 };

// One stage's dot as the kernels see it (ops/cuda/geometry.py fast_layout
// lays out the shared memory; fast_derive the rest).
struct FastDot {
    int P, Q, T;
    int D;                  // windows a row of A
    int S, ls;              // a row's step through the span, D·Q, and log2 S
    int pad;                // bf16 entries after every S entries of a plane
    int lead;               // (1 − T) mod 4: band columns below the taps
    int ks, nt;             // k-steps of 16, N-tiles of 8 columns
    int bw;                 // words of B fragments a lane and k-step: 4, or
                            // 2 where the layout is compact (t_h alone)
    int planes;             // 4 (I_h, I_l, Q_h, Q_l), or 2 compact (I_h, Q_h)
    int plane;              // bf16 entries a plane: a multiple of 8
    int g_off, x_off;       // word offsets of the B fragments and the planes
};

// The derived fields of a stage; false unless P, Q, T > 0 and Q and D are
// powers of two (the planes' pads and indices shift by log2 S).  `compact`:
// one pass, two planes and no t_l in the B fragments.
__host__ __device__ inline bool fast_derive(FastDot& d, int P, int Q, int T,
                                            int D = 1, bool compact = false) {
    if (P <= 0 || Q <= 0 || T <= 0 || D <= 0 || (Q & (Q - 1)) || (D & (D - 1)))
        return false;
    d.P = P;
    d.Q = Q;
    d.T = T;
    d.D = D;
    d.S = D * Q;
    d.ls = 0;
    while ((1 << d.ls) < d.S) ++d.ls;
    d.pad = d.S >= 16 ? 8 : 0;
    d.lead = (4 - (T - 1) % 4) % 4;
    d.ks = (T + d.lead + ((P - 1) * Q) / P + Q * (D - 1) + 15) / 16;
    d.nt = (D * P + 7) / 8;
    d.bw = compact ? 2 : 4;
    d.planes = compact ? 2 : 4;
    return true;
}

// Padded plane index of span entry k.
__host__ __device__ __forceinline__ int fast_pidx(const FastDot& g, int k) {
    return k + g.pad * (k >> g.ls);
}

// Whether a span of `len` entries fits the planes, and the fragments and
// the planes lie apart inside `smem` bytes.
__host__ __device__ inline bool fast_fits(const FastDot& g, long long len,
                                          long long smem) {
    if (len < 1 || g.plane <= 0 || g.plane % 8 || g.g_off < 0 || g.g_off % 4 ||
        g.x_off < 0 || g.x_off % 4 || len > 0x7FFFFFFFLL)
        return false;
    const long long g_end = g.g_off + 32LL * g.bw * g.ks * g.nt;
    const long long x_end = g.x_off + (long long)g.planes * g.plane / 2;
    return fast_pidx(g, (int)(len - 1)) < g.plane &&
           (g_end <= g.x_off || x_end <= g.g_off) &&
           4 * (g_end > x_end ? g_end : x_end) <= smem;
}

// G as B fragments at smem + g_off, laid out once per bank by the wrapper
// (ops/cuda/geometry.py fast_taps_index): for k-step s, N-tile n and lane
// (g = lane/4, q = lane%4) the words {t_h(k0, k0+1), t_h(k0+8, k0+9),
// t_l(k0, k0+1), t_l(k0+8, k0+9)} of column (d, p) = d·P + p = 8n + g, k0 =
// 16s + 2q (without the t_l words where the layout is compact): one load a
// lane and k-step.  nthreads is a multiple of 32, so a thread keeps its
// lane, and its column.  Copied into smem + g_off with 16-byte cp.async;
// fast_copy_wait before the barrier that ends the phase.
__device__ __forceinline__ void fast_copy_taps(unsigned* __restrict__ smem,
                                               const FastDot& g,
                                               const unsigned* __restrict__ taps,
                                               int tid, int nthreads) {
    const int n16 = g.bw * g.ks * g.nt * 8;      // 16-byte pieces
    uint4* dst = reinterpret_cast<uint4*>(smem + g.g_off);
    const uint4* src = reinterpret_cast<const uint4*>(taps);
    for (int i = tid; i < n16; i += nthreads) {
#ifdef __CUDACC__
        const unsigned a = (unsigned)__cvta_generic_to_shared(dst + i);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(src + i));
#else
        dst[i] = src[i];
#endif
    }
}

__device__ __forceinline__ void fast_copy_wait() {
#ifdef __CUDACC__
    asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// kMixOnly's side words: the XOR of `n` words of the planes by each warp of
// the CTA into side[warp], or XORed onto it where `accumulate`.
__device__ __forceinline__ void fast_xor_words(const unsigned* __restrict__ words,
                                               int n, int tid, int nthreads,
                                               unsigned* __restrict__ side,
                                               bool accumulate = false) {
    unsigned x = 0u;
    for (int w = tid; w < n; w += nthreads) x ^= words[w];
#ifdef __CUDACC__
    for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, o);
#endif
    if ((tid & 31) == 0) side[tid / 32] = accumulate ? side[tid / 32] ^ x : x;
}

// Plane of component c (0: I, 1: Q) and half h (0: x_h, 1: x_l): four
// planes I_h, I_l, Q_h, Q_l, or compact I_h, Q_h.
template <bool kCompact>
__host__ __device__ __forceinline__ constexpr int fast_plane_of(int c, int h) {
    return kCompact ? c : 2 * c + h;
}

// The store of a span: one sample split into the planes, or a group of
// four (span entries k .. k+3, k ≡ 0 mod 4, never across a pad) as one
// 8-byte store a plane.  One pass reads no low plane and stores none: its
// planes keep split3's places unless the layout is compact.
template <int kPasses, bool kCompact = false>
struct SplitStore {
    uint16_t* xs;           // plane 0; the others `plane` entries apart
    const FastDot* g;
    long long origin;       // x index of span entry 0, ≡ 0 (mod 4)
    __device__ __forceinline__ void operator()(long long n, float vi,
                                               float vq) const {
        const int k = fast_pidx(*g, (int)(n - origin));
        const float v[2] = {vi, vq};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const uint16_t h = bf16_rn(v[c]);
            xs[fast_plane_of<kCompact>(c, 0) * g->plane + k] = h;
            if (kPasses == 3)
                xs[fast_plane_of<kCompact>(c, 1) * g->plane + k] =
                    bf16_rn(__fsub_rn(v[c], bf16_float(h)));
        }
    }
    __device__ __forceinline__ void group(long long n, const float* vi,
                                          const float* vq) const {
        const int k = fast_pidx(*g, (int)(n - origin));
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const float* v = c ? vq : vi;
            unsigned h[2], l[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) split2(v[2 * i], v[2 * i + 1], h[i], l[i]);
            put4(xs + fast_plane_of<kCompact>(c, 0) * g->plane + k, h);
            if (kPasses == 3) put4(xs + fast_plane_of<kCompact>(c, 1) * g->plane + k, l);
        }
    }
    // The halves of two neighbouring samples as two words (the first in the
    // low half): on the card with the paired conversion, one instruction
    // for both roundings, the same bits as bf16_rn of each.
    __device__ __forceinline__ static void split2(float a, float b, unsigned& h,
                                                  unsigned& l) {
#ifdef __CUDACC__
        const __nv_bfloat162 hb = __floats2bfloat162_rn(a, b);
        const __nv_bfloat162 lb = __floats2bfloat162_rn(
            __fsub_rn(a, __low2float(hb)), __fsub_rn(b, __high2float(hb)));
        h = *reinterpret_cast<const unsigned*>(&hb);
        l = *reinterpret_cast<const unsigned*>(&lb);
#else
        const uint16_t ha = bf16_rn(a), hb = bf16_rn(b);
        h = pack2(ha, hb);
        l = pack2(bf16_rn(__fsub_rn(a, bf16_float(ha))),
                  bf16_rn(__fsub_rn(b, bf16_float(hb))));
#endif
    }
    __device__ __forceinline__ static void put4(uint16_t* p, const unsigned* w) {
#ifdef __CUDACC__
        *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
#else
        for (int i = 0; i < 2; ++i) {
            p[2 * i] = (uint16_t)(w[i] & 0xFFFFu);
            p[2 * i + 1] = (uint16_t)(w[i] >> 16);
        }
#endif
    }
};

// Entries idx, idx+1 of a plane as one word (the lower k in the low half):
// one 4-byte load where S is even (idx is then even), else two.
template <bool kOddS>
__device__ __forceinline__ unsigned fast_pair(const uint16_t* __restrict__ plane,
                                              int idx) {
#ifdef __CUDACC__
    if (!kOddS) return *reinterpret_cast<const unsigned*>(plane + idx);
#endif
    return pack2(plane[idx], plane[idx + 1]);
}

// The A fragments of the planes for rows r0, r0 + 8 of the tile and
// columns k, k + 1, k + 8, k + 9: a[2c + h][reg] for component c, half h,
// in the PTX layout (reg 0: row r0, k; 1: row r0 + 8, k; 2: row r0, k + 8;
// 3: row r0 + 8, k + 8); one pass reads the high planes only.  A pair never
// straddles a pad: pads follow an even count of entries wherever there are
// any.
template <int kPasses, bool kOddS, bool kCompact = false>
__device__ __forceinline__ void fast_a(const FastDot& g,
                                       const uint16_t* __restrict__ xs, int r0,
                                       int k, unsigned (&a)[4][4]) {
    const int k00 = g.S * r0 + k, k10 = k00 + 8 * g.S;
    const int idx[4] = {fast_pidx(g, k00), fast_pidx(g, k10),
                        fast_pidx(g, k00 + 8), fast_pidx(g, k10 + 8)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        if (kPasses == 1 && (c & 1)) continue;
        const uint16_t* plane = xs + fast_plane_of<kCompact>(c >> 1, c & 1) * g.plane;
#pragma unroll
        for (int r = 0; r < 4; ++r) a[c][r] = fast_pair<kOddS>(plane, idx[r]);
    }
}

#ifdef __CUDACC__
// fast_a for even S ≥ 8 as one ldmatrix.x4 a plane: lane L gives the row
// (L & 7) + 8·((L >> 3) & 1) of the tile and the columns k + 8·(L >> 4),
// 16 bytes aligned (S·row, k and the pads are multiples of 8 entries).
template <int kPasses, bool kCompact = false>
__device__ __forceinline__ void fast_a_ldm(const FastDot& g,
                                           const uint16_t* __restrict__ xs,
                                           int mt, int s, int lane,
                                           unsigned (&a)[4][4]) {
    const int row = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int idx = fast_pidx(g, g.S * row + 16 * s + 8 * (lane >> 4));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        if (kPasses == 1 && (c & 1)) continue;
        const unsigned addr = (unsigned)__cvta_generic_to_shared(
            xs + fast_plane_of<kCompact>(c >> 1, c & 1) * g.plane + idx);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[c][0]), "=r"(a[c][1]), "=r"(a[c][2]), "=r"(a[c][3])
                     : "r"(addr));
    }
}
#endif

// A lane's B fragments of k-step s, N-tile n: {t_h, t_h, t_l, t_l} words,
// or {t_h, t_h, 0, 0} where the layout is compact.
template <bool kCompact = false>
__device__ __forceinline__ uint4 fast_b(const unsigned* __restrict__ gf,
                                        const FastDot& g, int s, int n, int lane) {
    if (kCompact) {
        const uint2 w = reinterpret_cast<const uint2*>(gf)[(s * g.nt + n) * 32 + lane];
        return make_uint4(w.x, w.y, 0u, 0u);
    }
    return reinterpret_cast<const uint4*>(gf)[(s * g.nt + n) * 32 + lane];
}

// A lane's four results (rows r0, r0 + 8; columns col, col + 1) to the
// sink: column (d, p) of row r is phase p of window i = D·r + d, output
// j = (i0 + i)·P + p, for the windows under n_win.
template <class Sink>
__device__ __forceinline__ void fast_put(const FastDot& g, long long i0,
                                         int n_win, int mt, int n, int lane,
                                         const float* ci, const float* cq,
                                         Sink& sink) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
        const int r = 16 * mt + (lane >> 2) + 8 * (e >> 1);
        const int col = 8 * n + 2 * (lane & 3) + (e & 1);
        const int d = col / g.P, p = col - d * g.P;
        const int i = g.D * r + d;
        if (d < g.D && i < n_win) sink.put((i0 + i) * g.P + p, ci[e], cq[e]);
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
template <int kPasses, bool kOddS, bool kCompact, class Sink>
__device__ __forceinline__ void fast_item(const FastDot& g,
                                          const unsigned* __restrict__ smem,
                                          long long i0, int n_win, int mt, int n,
                                          int lane, Sink& sink) {
    const unsigned* gf = smem + g.g_off;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(smem + g.x_off);
    const int r0 = 16 * mt + (lane >> 2);
    float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int s = 0; s < g.ks; ++s) {
        unsigned a[4][4];
        if (!kOddS && g.S >= 8) {
            fast_a_ldm<kPasses, kCompact>(g, xs, mt, s, lane, a);
        } else {
            fast_a<kPasses, kOddS, kCompact>(g, xs, r0, 16 * s + 2 * (lane & 3), a);
        }
        const uint4 b = fast_b<kCompact>(gf, g, s, n, lane);
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
    fast_put(g, i0, n_win, mt, n, lane, acc[0], acc[1], sink);
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

template <int kPasses, bool kOddS, bool kCompact, class Sink>
void fast_item_warp(const FastDot& g, const unsigned* smem, long long i0,
                    int n_win, int mt, int n, Sink& sink) {
    const unsigned* gf = smem + g.g_off;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(smem + g.x_off);
    float acc[2][32][4] = {};
    for (int s = 0; s < g.ks; ++s) {
        unsigned a[4][32][4] = {}, bh[32][2], bl[32][2];
        for (int lane = 0; lane < 32; ++lane) {
            unsigned al[4][4] = {};
            fast_a<kPasses, kOddS, kCompact>(g, xs, 16 * mt + (lane >> 2),
                                             16 * s + 2 * (lane & 3), al);
            for (int c = 0; c < 4; ++c)
                for (int r = 0; r < 4; ++r) a[c][lane][r] = al[c][r];
            const uint4 b = fast_b<kCompact>(gf, g, s, n, lane);
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
        fast_put(g, i0, n_win, mt, n, lane, acc[0][lane], acc[1][lane], sink);
}

#endif  // __CUDACC__

// Every warp item of a span's windows i0 .. i0 + n_win − 1 (the span's
// first window i0 a multiple of 16·D), shared out over the CTA's warps.
template <int kPasses, bool kOddS, bool kCompact = false, class Sink>
__device__ __forceinline__ void fast_items(const FastDot& g,
                                           const unsigned* __restrict__ smem,
                                           long long i0, int n_win, int tid,
                                           int nthreads, Sink& sink) {
    const int rows = (n_win + g.D - 1) / g.D;
    const int n_items = (rows + 15) / 16 * g.nt;
    for (int item = tid >> 5; item < n_items; item += nthreads >> 5) {
        const int mt = item / g.nt, n = item - mt * g.nt;
#ifdef __CUDACC__
        fast_item<kPasses, kOddS, kCompact>(g, smem, i0, n_win, mt, n, tid & 31, sink);
#else
        if ((tid & 31) == 0)
            fast_item_warp<kPasses, kOddS, kCompact>(g, smem, i0, n_win, mt, n, sink);
#endif
    }
}

}  // namespace doppler
