// Fused chain kernel of --precision fast: decode → NCO mix → P/Q polyphase
// FIR as a bf16 tensor-core dot → encode.
//
// Replaces the dot_precision='split3' branch of
// doppler_tpu/ops/pallas/chain.py:240 _make_kernel (its _acc_slices,
// chain.py:191-221, on operands split by _split_bf16_exact, chain.py:126,
// against taps split by split3_taps, chain.py:138), reached through
// mix_resample_chain_pallas_stream (chain.py:404) and, with a channel axis,
// mix_resample_chain_pallas_channels (chain.py:556).
//
// Computes, for output j = P·i + p (window i, phase p, off_p = ⌊p·Q/P⌋, bank
// row (p·Q) mod P, as in fir.cuh),
//     y[j] = Σ_{l<T} x_h·t_h + x_h·t_l + x_l·t_h,   x = x[Q·i + off_p − l]
// with x_h = bf16(x), x_l = bf16(x − x_h) and the taps split alike
// (ops/precision.py).  Every product is exact in float32; only the order of
// the sums is the kernel's own.  The carry is chain.cuh's, the exact
// kernel's: bitwise the same mixed samples.
//
// Design.  Phase 0 is chain.cu's: the CTA mixes its span with its T−1 halo
// (chain.cuh chain_fill, nco.cuh mix_span); the store splits each sample
// (__float2bfloat16_rn, __fsub_rn, __float2bfloat16_rn) into four bf16
// planes I_h, I_l, Q_h, Q_l, a group of four samples as one 8-byte store a
// plane, and the entries before the carry or past the chunk are zeros.  It
// also lays the taps out as the mma's B fragments.  Phase 1 is the banded
// (Toeplitz) product
//     Y[i, p] = Σ_k A[i, k]·G[k, p],   A[i, k] = x[Q·i − (T−1) − lead + k],
//     G[k, p] = t[p, T−1 + lead + off_p − k] where that tap exists, else 0,
// k < K = 16·⌈(T + lead + off_{P−1})/16⌉, lead = (1 − T) mod 4 (so that span
// entry 0 is 4-aligned): row i of A is a window of the span (no copy), and G
// is the TPU kernel's banded taps matrix with its per-128-row slices joined.
// A warp owns 16 windows × 8 phases; a k-step is one ldmatrix.x4 a plane
// (16-bit or 32-bit loads where Q < 8) and three mma.sync.m16n8k16.bf16
// (float32 accumulation) a plane, hh, hl and lh, each into a fresh
// accumulator, added as (hh + hl) + lh to the output's running sum with
// __fadd_rn: the tensor core's own rounding touches one product's 16-term
// partial sum only.
//
// Bytes.  Every output takes its k-steps in one order (k ascending), sits in
// row i mod 16 of its mma (tiles start at multiples of 16 windows) and in
// column p mod 8; there is no split-K and no atomic.  So the bytes do not
// depend on the tile or the threads, nor on how the stream is cut into
// chunks of a multiple of 16 windows (any cut at the blocks of 2048 samples
// of the CLI, for Q ≤ 128).  They are not the plain version's: a tensor
// core does not add as IEEE float32 does.
//
// NaN.  G's zeros multiply real x: a NaN or ±∞ at x[n] reaches all P
// outputs of every window i whose band, x[Q·i − (T−1) − lead] and the K − 1
// samples after it, holds n: wider than the exact kernel's T-window (as the
// TPU kernel's zero-padded taps matrices are, chain.py:87-119); ±∞ splits
// into x_l = NaN.
//
// Bound on this card.  Bytes: 4 + 4·P/Q a sample (i16 words in, words
// out), plan words, banks and carries, at 3.35 TB/s; operations: the
// float32 mix (29 a sample, nco.cuh) at 67 TFLOP/s, and the split3 dot
// (3 passes × I and Q × 2·T·P/Q a sample) at 989 TFLOP/s bf16.  At config 3
// (P/Q = 3/64, T = 370), B = 16384, L = 2048: 140.5 MB → 0.0419 ms, mix
// 0.0145 ms, dot 0.0070 ms: bound by bytes (chip_smoke.py computes it).  The
// banded form multiplies K·8 entries a window for P·T useful taps: 416·8 /
// 1110 ≈ 3.0× the useful MACs at 3/64/370.  What the design spends: the mix
// is chain.cu's ≈ 60 instructions a sample plus the split; the A fragments
// are 2 KB a warp and k-step from shared memory, conflict-free (a plane
// holds a pad of 8 entries after every Q ≥ 16, so the 8 rows of an ldmatrix
// phase meet 8 different bank groups); every CTA builds G's fragments
// (13 KB at config 3) from the two bf16 banks.  __launch_bounds__(256, 3):
// the picked CTA (96 windows, 192 threads, 70 KB) is three an SM by its
// shared memory, so the registers (up to 85) cost no warps.
#include "chain.cuh"
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

struct FastArgs {
    int P, Q, T, C, B, L;
    int lq;                 // log2 Q
    int pad;                // bf16 entries after every Q entries of a plane
    int lead;               // (1 − T) mod 4: band columns below the taps
    int wt;                 // windows a tile: a multiple of 16
    int n_tiles;
    int ks, nt;             // k-steps of 16, N-tiles of 8 phases
    int plane;              // bf16 entries a plane: a multiple of 8
    int g_off, x_off;       // word offsets of the B fragments and the planes
    int vec4;               // the input takes 16-byte loads
    int out_f32;
    long long n_win, m_total;
    const uint16_t* bank_h; // (P, T) bf16
    const uint16_t* bank_l;
    const float* carry_in;  // (C, 2, T−1)
    float* carry_out;       // (C, 2, T−1)
};

// Padded plane index of span entry k.
__host__ __device__ __forceinline__ int fast_pidx(const FastArgs& g, int k) {
    return k + g.pad * (k >> g.lq);
}

// Two neighbouring entries k, k + 1 of G's column for a phase whose bank
// row is `row` and whose tap l sits at k = top − l, top = T−1 + lead + off_p.
__device__ __forceinline__ unsigned fast_taps2(const uint16_t* __restrict__ row,
                                               int top, int T, int k) {
    const int l0 = top - k, l1 = l0 - 1;
    return pack2((l0 >= 0 && l0 < T) ? row[l0] : (uint16_t)0,
                 (l1 >= 0 && l1 < T) ? row[l1] : (uint16_t)0);
}

// G as B fragments: for k-step s, N-tile n and lane (g = lane/4, q = lane%4)
// the words {t_h(k0, k0+1), t_h(k0+8, k0+9), t_l(k0, k0+1), t_l(k0+8, k0+9)}
// of column p = 8n + g, k0 = 16s + 2q: one 16-byte load a lane and k-step.
// nthreads is a multiple of 32, so a thread keeps its lane, and its column.
__device__ __forceinline__ void fast_load_taps(unsigned* __restrict__ gf,
                                               const FastArgs& g, int tid,
                                               int nthreads) {
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

// The fill loops' store: one sample split into the four planes, or a group
// of four (span entries k .. k+3, k ≡ 0 mod 4, never across a pad) as one
// 8-byte store a plane.
struct SplitStore {
    uint16_t* xs;           // I_h; I_l, Q_h, Q_l `plane` entries apart
    const FastArgs* g;
    long long origin;       // x index of span entry 0, ≡ 0 (mod 4)
    __device__ __forceinline__ void operator()(long long n, float vi,
                                               float vq) const {
        const int k = fast_pidx(*g, (int)(n - origin));
        const float v[2] = {vi, vq};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const uint16_t h = bf16_rn(v[c]);
            xs[(2 * c) * g->plane + k] = h;
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
            put4(xs + (2 * c + 1) * g->plane + k, l);
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

// The A fragments of the four planes for rows r0, r0 + 8 of the tile and
// columns k, k + 1, k + 8, k + 9: a[plane][reg] in the PTX layout
// (reg 0: row r0, k; 1: row r0 + 8, k; 2: row r0, k + 8; 3: row r0 + 8,
// k + 8).  A pair never straddles a pad: pads follow an even count of
// entries wherever there are any.
template <bool kOddQ>
__device__ __forceinline__ void fast_a(const FastArgs& g,
                                       const uint16_t* __restrict__ xs, int r0,
                                       int k, unsigned (&a)[4][4]) {
    const int k00 = g.Q * r0 + k, k10 = k00 + 8 * g.Q;
    const int idx[4] = {fast_pidx(g, k00), fast_pidx(g, k10),
                        fast_pidx(g, k00 + 8), fast_pidx(g, k10 + 8)};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[c][r] = fast_pair<kOddQ>(xs + c * g.plane, idx[r]);
    }
}

#ifdef __CUDACC__
// fast_a for even Q ≥ 8 as one ldmatrix.x4 a plane: lane L gives the row
// (L & 7) + 8·((L >> 3) & 1) of the tile and the columns k + 8·(L >> 4),
// 16 bytes aligned (Q·row, k and the pads are multiples of 8 entries).
__device__ __forceinline__ void fast_a_ldm(const FastArgs& g,
                                           const uint16_t* __restrict__ xs,
                                           int mt, int s, int lane,
                                           unsigned (&a)[4][4]) {
    const int row = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
    const int idx = fast_pidx(g, g.Q * row + 16 * s + 8 * (lane >> 4));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const unsigned addr =
            (unsigned)__cvta_generic_to_shared(xs + c * g.plane + idx);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(a[c][0]), "=r"(a[c][1]), "=r"(a[c][2]), "=r"(a[c][3])
                     : "r"(addr));
    }
}
#endif

__device__ __forceinline__ uint4 fast_b(const unsigned* __restrict__ gf,
                                        const FastArgs& g, int s, int n, int lane) {
    return reinterpret_cast<const uint4*>(gf)[(s * g.nt + n) * 32 + lane];
}

// A lane's four results (rows r0, r0 + 8; phases p, p + 1) to the sink.
template <class Sink>
__device__ __forceinline__ void fast_put(const FastArgs& g, long long i0,
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

// One warp item: 16 windows (M-tile mt of the tile) × 8 phases (N-tile n).
// A k-step's three passes go into three fresh accumulators (independent
// mma), added as (hh + hl) + lh to the running sum.
template <bool kOddQ, class Sink>
__device__ __forceinline__ void fast_item(const FastArgs& g,
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
            fast_a_ldm(g, xs, mt, s, lane, a);
        } else {
            fast_a<kOddQ>(g, xs, r0, 16 * s + 2 * (lane & 3), a);
        }
        const uint4 b = fast_b(gf, g, s, n, lane);
#pragma unroll
        for (int c = 0; c < 2; ++c) {               // I, then Q
            float hh[4] = {0.0f, 0.0f, 0.0f, 0.0f}, hl[4] = {0.0f, 0.0f, 0.0f, 0.0f},
                  lh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            mma_bf16(hh, a[2 * c], b.x, b.y);       // x_h · t_h
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

template <bool kOddQ, class Sink>
void fast_item_warp(const FastArgs& g, const unsigned* smem, long long i0,
                    int n_rows, int mt, int n, Sink& sink) {
    const unsigned* gf = smem + g.g_off;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(smem + g.x_off);
    float acc[2][32][4] = {};
    for (int s = 0; s < g.ks; ++s) {
        unsigned a[4][32][4], bh[32][2], bl[32][2];
        for (int lane = 0; lane < 32; ++lane) {
            unsigned al[4][4];
            fast_a<kOddQ>(g, xs, 16 * mt + (lane >> 2), 16 * s + 2 * (lane & 3), al);
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
            mma_bf16_warp(hl, a[2 * c], bl);
            mma_bf16_warp(lh, a[2 * c + 1], bh);
            for (int lane = 0; lane < 32; ++lane)
                for (int e = 0; e < 4; ++e)
                    acc[c][lane][e] = __fadd_rn(
                        acc[c][lane][e],
                        __fadd_rn(__fadd_rn(hh[lane][e], hl[lane][e]), lh[lane][e]));
        }
    }
    for (int lane = 0; lane < 32; ++lane)
        fast_put(g, i0, n_rows, mt, n, lane, acc[0][lane], acc[1][lane], sink);
}

#endif  // __CUDACC__

// Phase `ph` of the CTA for channel `ch`, unit `unit` (a tile of `wt`
// windows, or the channel's carry), thread `tid` of `nthreads`; true while
// a further phase follows (after a barrier).
template <bool kInF32, bool kOddQ>
__device__ __forceinline__ bool chain_fast_phase(
        const void* __restrict__ in, void* __restrict__ out,
        const uint32_t* __restrict__ plans, const FastArgs& g, int ch, int unit,
        int tid, int nthreads, int ph, unsigned* smem) {
    const int H = g.T - 1;
    plans += (size_t)ch * g.B;
    const size_t stride = (size_t)g.C * g.B;
    const float* carry_in = g.carry_in + (size_t)ch * 2 * H;

    if (unit == g.n_tiles) {                   // the carry CTA
        chain_carry<kInF32>(in, plans, stride, g.B, g.L, H, carry_in,
                            g.carry_out + (size_t)ch * 2 * H, tid, nthreads);
        return false;
    }
    const long long i0 = (long long)unit * g.wt;
    const int n_rows = (int)min64((long long)g.wt, g.n_win - i0);
    if (ph == 0) {
        fast_load_taps(smem + g.g_off, g, tid, nthreads);
        // span entry 0 is x[org]: Q·i0 is a multiple of 16 and org of 4,
        // so the groups of four the mix stores whole are 8-byte aligned
        const long long org = i0 * g.Q - H - g.lead;
        const long long end = org + g.Q * (g.wt - 1) + 16 * g.ks;   // past the span
        const long long n_in = (long long)g.B * g.L;
        SplitStore store{reinterpret_cast<uint16_t*>(smem + g.x_off), &g, org};
        chain_fill<kInF32>(max64(org, -H), min64(end, n_in) - 1, in, plans, stride,
                           g.B, g.L, g.vec4 != 0, H, carry_in, tid, nthreads, store);
        // before the carry (lead columns of the first tile) and past the
        // chunk: zeros, which only zero taps multiply
        for (long long n = org + tid; n < -H; n += nthreads) store(n, 0.0f, 0.0f);
        for (long long n = max64(org, n_in) + tid; n < end; n += nthreads)
            store(n, 0.0f, 0.0f);
        return true;
    }
    ChainSink sink{g.out_f32, out, g.m_total, g.C, ch};
    const int n_items = (n_rows + 15) / 16 * g.nt;
    for (int item = tid >> 5; item < n_items; item += nthreads >> 5) {
        const int mt = item / g.nt, n = item - mt * g.nt;
#ifdef __CUDACC__
        fast_item<kOddQ>(g, smem, i0, n_rows, mt, n, tid & 31, sink);
#else
        if ((tid & 31) == 0) fast_item_warp<kOddQ>(g, smem, i0, n_rows, mt, n, sink);
#endif
    }
    return false;
}

// FastArgs from doppler_chain_fast's arguments (below); false where they
// are not ones the kernel takes.
inline bool make_fast_args(FastArgs& g, const void* in, const uint16_t* bank_h,
                           const uint16_t* bank_l, const float* carry_in,
                           float* carry_out, int C, int B, int L, int P, int Q,
                           int T, int wt, int plane, int g_off, int x_off,
                           int out_f32, long long smem) {
    if (C <= 0 || B <= 0 || L <= 0 || P <= 0 || Q <= 0 || T <= 0 || (Q & (Q - 1)) ||
        L % Q != 0 || wt <= 0 || wt % 16 || plane <= 0 || plane % 8 || g_off < 0 ||
        g_off % 4 || x_off % 4)
        return false;
    g = FastArgs{};
    g.P = P;
    g.Q = Q;
    g.T = T;
    g.C = C;
    g.B = B;
    g.L = L;
    while ((1 << g.lq) < Q) ++g.lq;
    g.pad = Q >= 16 ? 8 : 0;
    g.lead = (4 - (T - 1) % 4) % 4;
    g.wt = wt;
    g.ks = (T + g.lead + ((P - 1) * Q) / P + 15) / 16;
    g.nt = (P + 7) / 8;
    g.plane = plane;
    g.g_off = g_off;
    g.x_off = x_off;
    g.n_win = (long long)B * L / Q;
    g.m_total = g.n_win * P;
    g.n_tiles = (int)((g.n_win + wt - 1) / wt);
    g.vec4 = (L % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0) ? 1 : 0;
    g.out_f32 = out_f32;
    g.bank_h = bank_h;
    g.bank_l = bank_l;
    g.carry_in = carry_in;
    g.carry_out = carry_out;
    // the span's last entry in its plane; the fragments and the planes apart
    const long long g_end = g_off + 128LL * g.ks * g.nt;
    return fast_pidx(g, Q * (wt - 1) + 16 * g.ks - 1) < plane &&
           (g_end <= x_off || x_off + 2LL * plane <= g_off) &&
           4 * (g_end > x_off + 2LL * plane ? g_end : x_off + 2LL * plane) <= smem;
}

}  // namespace doppler

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using doppler::FastArgs;

// 256 threads, three CTAs an SM: up to 85 registers a thread (the picked
// CTAs take 192 threads, three an SM by their shared memory)
constexpr int kMaxThreads = 256;

template <bool kInF32, bool kOddQ>
__global__ void __launch_bounds__(kMaxThreads, 3)
chain_fast_kernel(const void* __restrict__ in, void* __restrict__ out,
                  const uint32_t* __restrict__ plans,
                  const __grid_constant__ FastArgs g) {
    extern __shared__ uint4 smem4[];
    unsigned* smem = reinterpret_cast<unsigned*>(smem4);
    int ch, unit;
    doppler::split_block(blockIdx.x, g.C, g.n_tiles + (g.T > 1), ch, unit);
    for (int ph = 0;; ++ph) {
        if (!doppler::chain_fast_phase<kInF32, kOddQ>(in, out, plans, g, ch, unit,
                                               (int)threadIdx.x, (int)blockDim.x,
                                               ph, smem))
            break;
        __syncthreads();
    }
}

template <bool kInF32, bool kOddQ>
int launch(const void* in, void* out, const uint32_t* plans, const FastArgs& g,
           int threads, long long smem, cudaStream_t stream) {
    const long long grid = (long long)g.C * (g.n_tiles + (g.T > 1 ? 1 : 0));
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    auto kernel = chain_fast_kernel<kInF32, kOddQ>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<(unsigned)grid, threads, (size_t)smem, stream>>>(in, out, plans, g);
    return (int)cudaGetLastError();
}

}  // namespace

// in, out, plans, carry_in, carry_out: as doppler_chain (chain.cu); bank_h,
// bank_l: the (P, T) bank's bf16 halves (ops/precision.py split3_bank).  wt:
// windows a CTA (a multiple of 16); threads: a multiple of 32 up to 256;
// plane: bf16 entries of each of the four span planes; g_off, x_off: word
// offsets of the B fragments and of the planes in the `smem` bytes of
// dynamic shared memory, as ops/cuda/geometry.py fast_layout lays them out.
// Needs Q a power of two and L % Q == 0.  Returns cudaGetLastError() after
// the launch.
extern "C" int doppler_chain_fast(const void* in, void* out, const uint32_t* plans,
                                  const uint16_t* bank_h, const uint16_t* bank_l,
                                  const float* carry_in, float* carry_out, int C,
                                  int B, int L, int P, int Q, int T, int wt,
                                  int threads, int plane, int g_off, int x_off,
                                  long long smem, int in_f32, int out_f32,
                                  void* stream) {
    FastArgs g;
    if (threads < 32 || threads > kMaxThreads || threads % 32 || smem <= 0 ||
        !doppler::make_fast_args(g, in, bank_h, bank_l, carry_in, carry_out, C,
                                 B, L, P, Q, T, wt, plane, g_off, x_off, out_f32,
                                 smem))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (Q & 1)
        return in_f32 ? launch<true, true>(in, out, plans, g, threads, smem, s)
                      : launch<false, true>(in, out, plans, g, threads, smem, s);
    return in_f32 ? launch<true, false>(in, out, plans, g, threads, smem, s)
                  : launch<false, false>(in, out, plans, g, threads, smem, s);
}

#endif  // __CUDACC__
