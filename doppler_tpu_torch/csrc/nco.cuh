// Shared device helpers of the mixer, chain, cascade and probe kernels: decode,
// the exact Q0.64 NCO phase, the quarter-wave tone, the rotation and the encode.
//
// Replaces the helpers the TPU kernels inline:
//   doppler_tpu/ops/pallas/mixer.py:42  phase_q24
//   doppler_tpu/ops/sincos.py:33-99     mix_tone, sincos_q24_neg
//
// Contraction policy: every float product and sum below is written with
// __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never contracts into an
// FMA (the library is also built with -fmad=false).  Each step then rounds
// exactly as the plain torch version's separate operations do, so the
// kernels' mixed float32 equals doppler_tpu_torch.ops.nco.mix_blocks
// bitwise on the card.  The FIR dots in chain.cu and cascade.cu use
// explicit __fmaf_rn, which this policy leaves alone.
#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "host_shim.cuh"

namespace doppler {

// Per-block plan words: (D, C1, C2, t) of ops/phase_plan.py, as the
// (7, C, B) uint32 stack d_hi, d_lo, c1_hi, c1_lo, c2_hi, c2_lo, t (C = 1
// for a single stream).
struct Plan {
    uint64_t d, c1, c2;
    uint32_t t;
};

// Which channel a CTA works for, and which unit of that channel's work
// (a tile, or a carry).  The channel is the fast index of the schedule, so
// the CTAs in flight together read the same span of the shared input and
// all but the first find it in L2.  Compiling with -DDOPPLER_CHANNEL_MAJOR
// walks one channel's units before the next channel's instead: the same
// results, kept only so that the two schedules can be timed against each
// other.
__device__ __forceinline__ void split_block(unsigned bid, int C, int units,
                                            int& c, int& unit) {
#ifdef DOPPLER_CHANNEL_MAJOR
    c = (int)(bid / (unsigned)units);
    unit = (int)(bid - (unsigned)c * (unsigned)units);
#else
    unit = (int)(bid / (unsigned)C);
    c = (int)(bid - (unsigned)unit * (unsigned)C);
#endif
}

// `plans` points at the channel's first word (base + c·B); `stride` is the
// distance between two fields of the stack, C·B.
__device__ __forceinline__ Plan load_plan(const uint32_t* __restrict__ plans,
                                          size_t stride, int b) {
    Plan p;
    p.d = ((uint64_t)__ldg(plans + 0 * stride + b) << 32) | __ldg(plans + 1 * stride + b);
    p.c1 = ((uint64_t)__ldg(plans + 2 * stride + b) << 32) | __ldg(plans + 3 * stride + b);
    p.c2 = ((uint64_t)__ldg(plans + 4 * stride + b) << 32) | __ldg(plans + 5 * stride + b);
    p.t = __ldg(plans + 6 * stride + b);
    return p;
}

// Top 24 bits of (j·D + C) mod 2^64, C = C1 for j < t and C2 after.
// Native 64-bit unsigned arithmetic wraps mod 2^64 by definition, so no
// block length needs a special case.
__device__ __forceinline__ int phase_q24(uint32_t j, const Plan& p) {
    uint64_t c = j < p.t ? p.c1 : p.c2;
    return (int)(((uint64_t)j * p.d + c) >> 40);
}

// The polynomial pair (sin x, cos x) on x = (q24 mod 2²²)·(π/2)·2⁻²² in
// [0, π/2), shared by both quadrant folds below.
__device__ __forceinline__ void quarter_poly(int q24, float& sp, float& cp) {
    const float x = __fmul_rn((float)(q24 & 0x3FFFFF), 0x1.921fb6p-22f);
    const float x2 = __fmul_rn(x, x);
    sp = __fadd_rn(-0x1.9f6446p-13f, __fmul_rn(x2, 0x1.5d38b6p-19f));
    sp = __fadd_rn(0x1.110eb4p-7f, __fmul_rn(x2, sp));
    sp = __fadd_rn(-0x1.555542p-3f, __fmul_rn(x2, sp));
    sp = __fadd_rn(0x1.fffffep-1f, __fmul_rn(x2, sp));
    sp = __fmul_rn(x, sp);
    cp = __fadd_rn(0x1.9f6b42p-16f, __fmul_rn(x2, -0x1.17b5b2p-22f));
    cp = __fadd_rn(-0x1.6c1374p-10f, __fmul_rn(x2, cp));
    cp = __fadd_rn(0x1.555548p-5f, __fmul_rn(x2, cp));
    cp = __fadd_rn(-0x1.0p-1f, __fmul_rn(x2, cp));
    cp = __fadd_rn(1.0f, __fmul_rn(x2, cp));
}

// (cos θ, sin θ) for θ = −2π·q24·2⁻²⁴, 0 ≤ q24 < 2²⁴: the polynomial pair
// and a quadrant fold by swap-select plus sign-bit XOR.  The quadrant (bits
// 23, 22 of q24) is read at the top of a word, u = q24·2⁸: the pair swaps
// in odd quadrants (bit 30); cos is negated in quadrants 1 and 2, where bit
// 31 of u + 2³⁰ (the quadrant plus one) is set; sin in quadrants 0 and 1,
// where bit 31 of u is clear.  The same bits as the fold of
// ops/sincos.py, in fewer integer operations.
__device__ __forceinline__ void sincos_q24_neg(int q24, float& c, float& s) {
    const unsigned u = (unsigned)q24 << 8;
    float sp, cp;
    quarter_poly(q24, sp, cp);
    const bool swap = (u & 0x40000000u) != 0;
    const unsigned signc = (u + 0x40000000u) & 0x80000000u;
    const unsigned signs = ~u & 0x80000000u;
    c = __uint_as_float(__float_as_uint(swap ? sp : cp) ^ signc);
    s = __uint_as_float(__float_as_uint(swap ? cp : sp) ^ signs);
}

// The same tone with the quadrant fold written as a chain of selects over
// negated values (tools/probe_chain_precision.py:108 sincos_select).  Only
// the tone probe runs it: a negation flips the sign bit exactly as the XOR
// does, so the two folds give the same bits, and the probe times one
// against the other.
__device__ __forceinline__ void sincos_q24_neg_select(int q24, float& c, float& s) {
    const int quad = q24 >> 22;
    float sp, cp;
    quarter_poly(q24, sp, cp);
    const float cos_u = quad == 0 ? cp : (quad == 1 ? -sp : (quad == 2 ? -cp : sp));
    const float sin_u = quad == 0 ? sp : (quad == 1 ? cp : (quad == 2 ? -sp : -cp));
    c = cos_u;
    s = -sin_u;
}

// One LE i16 IQ pair word → planar floats scaled by 1/32768 (dsp.rs:85-99).
__device__ __forceinline__ void decode_i16(int w, float& fi, float& fq) {
    fi = __fmul_rn((float)(short)(w & 0xFFFF), 0x1.0p-15f);
    fq = __fmul_rn((float)(w >> 16), 0x1.0p-15f);
}

// Rotate one sample by the tone of phase q24: (fi·c − fq·s, fi·s + fq·c).
// kSelect takes the select-chain tone (the tone probe only).
template <bool kSelect = false>
__device__ __forceinline__ void mix_q24(float fi, float fq, int q24, float& oi,
                                        float& oq) {
    float c, s;
    if (kSelect) {
        sincos_q24_neg_select(q24, c, s);
    } else {
        sincos_q24_neg(q24, c, s);
    }
    oi = __fsub_rn(__fmul_rn(fi, c), __fmul_rn(fq, s));
    oq = __fadd_rn(__fmul_rn(fi, s), __fmul_rn(fq, c));
}

// Mix one sample of block-local index j.
template <bool kSelect = false>
__device__ __forceinline__ void mix_sample(float fi, float fq, uint32_t j,
                                           const Plan& p, float& oi, float& oq) {
    mix_q24<kSelect>(fi, fq, phase_q24(j, p), oi, oq);
}

// Mixed sample at chunk index g ≥ 0 of a (B, L) chunk: int32 words, or
// float32 planes (2, B, L) when kInF32 — the input is shared by every
// channel, so its Q plane sits B·L after the I plane whatever C is.
// `plans`/`stride` as in load_plan; `cur`/`p` cache the plan of the block
// this thread loaded last.  One division and one 64-bit product a sample:
// the carry CTAs and single samples use it, the spans use mix_span below.
template <bool kInF32, bool kSelect = false>
__device__ __forceinline__ void mix_at(long long g, const void* __restrict__ in,
                                       const uint32_t* __restrict__ plans,
                                       size_t stride, int B, int L, int& cur,
                                       Plan& p, float& oi, float& oq) {
    const int b = (int)(g / L);
    const int j = (int)(g - (long long)b * L);
    if (b != cur) {
        p = load_plan(plans, stride, b);
        cur = b;
    }
    float fi, fq;
    if (kInF32) {
        fi = static_cast<const float*>(in)[g];
        fq = static_cast<const float*>(in)[(long long)B * L + g];
    } else {
        decode_i16(static_cast<const int*>(in)[g], fi, fq);
    }
    mix_sample<kSelect>(fi, fq, (uint32_t)j, p, oi, oq);
}

// The strided walker: the phase of samples g, g + step, g + 2·step, … without
// a division or a 64-bit multiply a sample.  A thread divides once (seek),
// then every advance adds the stride to j and step·D to the 64-bit product
// j·D.  Unsigned addition wraps mod 2^64 exactly as the product does, so the
// top 24 bits of (prod + C) are bitwise phase_q24's.  Where j runs past the
// block the walker moves on to the block that holds it, reloads the plan
// words there and multiplies once.
struct Walker {
    Plan p;
    int b;              // block
    uint32_t j;         // index inside the block
    uint64_t prod;      // j·D mod 2^64
    uint64_t step_d;    // step·D mod 2^64, of the block's D
};

__device__ __forceinline__ void walker_seek(Walker& w, long long g, uint32_t step,
                                            const uint32_t* __restrict__ plans,
                                            size_t stride, int L) {
    // in 32 bits where g fits: a 64-bit division is a long subroutine
    w.b = (g >> 32) == 0 ? (int)((uint32_t)g / (uint32_t)L) : (int)(g / L);
    w.j = (uint32_t)(g - (long long)w.b * L);
    w.p = load_plan(plans, stride, w.b);
    w.prod = (uint64_t)w.j * w.p.d;
    w.step_d = (uint64_t)step * w.p.d;
}

// Forward by `step` samples; the caller never advances past the chunk.
__device__ __forceinline__ void walker_advance(Walker& w, uint32_t step,
                                               const uint32_t* __restrict__ plans,
                                               size_t stride, int L) {
    w.j += step;
    if (w.j < (uint32_t)L) {
        w.prod += w.step_d;
        return;
    }
    do {
        w.j -= (uint32_t)L;
        ++w.b;
    } while (w.j >= (uint32_t)L);
    w.p = load_plan(plans, stride, w.b);
    w.prod = (uint64_t)w.j * w.p.d;
    w.step_d = (uint64_t)step * w.p.d;
}

// The walker at sample j of block b, without a division: for a caller
// that knows the block (the mixer's CTAs each lie inside one).
__device__ __forceinline__ void walker_start(Walker& w, int b, uint32_t j,
                                             uint32_t step,
                                             const uint32_t* __restrict__ plans,
                                             size_t stride) {
    w.b = b;
    w.j = j;
    w.p = load_plan(plans, stride, b);
    w.prod = (uint64_t)j * w.p.d;
    w.step_d = (uint64_t)step * w.p.d;
}

// phase_q24 of the sample i places after the walker's (same block).
__device__ __forceinline__ int walker_q24(const Walker& w, uint32_t i,
                                          uint64_t prod_i) {
    const uint64_t c = w.j + i < w.p.t ? w.p.c1 : w.p.c2;
    return (int)((prod_i + c) >> 40);
}

// phase_q24 of the walker's sample and the three after it (same block):
// adds only.  Where all four lie on one side of the switch at t, as nearly
// every group does, C joins the running sum once, not once a sample.
__device__ __forceinline__ void walker_q24x4(const Walker& w, int (&q24)[4]) {
    if (w.j + 3u < w.p.t || w.j >= w.p.t) {
        uint64_t sum = w.prod + (w.j < w.p.t ? w.p.c1 : w.p.c2);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            q24[i] = (int)(sum >> 40);
            sum += w.p.d;
        }
    } else {
        uint64_t prod = w.prod;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            q24[i] = walker_q24(w, (uint32_t)i, prod);
            prod += w.p.d;
        }
    }
}

// Whether a store takes a whole group of four samples at once:
// store.group(g, oi, oq) for the mixed samples g .. g+3, g ≡ 0 (mod 4).
template <class S, class = void>
struct HasGroupStore : std::false_type {};
template <class S>
struct HasGroupStore<S, std::void_t<decltype(&S::group)>> : std::true_type {};

// Mixed samples g = first..last of a (B, L) chunk (0 ≤ first, last < B·L),
// shared out over the CTA's threads: store(g, i, q) is called once for
// every g, by some thread (a store with a `group` member takes the groups
// of four that lie whole inside, on the 16-byte path).  `in`, `plans`,
// `stride` as in mix_at.  With `vec4` a thread takes four neighbouring
// samples from one 16-byte load (two for float32 planes) on a 4-aligned g;
// the caller passes it only when L % 4 == 0 and `in` is 16-byte aligned, so
// a group never leaves its block or the chunk.  Otherwise one sample a step.
// Either way the values are bitwise mix_at's.
template <bool kInF32, bool kSelect = false, class Store>
__device__ __forceinline__ void mix_span(long long first, long long last,
                                         const void* __restrict__ in,
                                         const uint32_t* __restrict__ plans,
                                         size_t stride, int B, int L, bool vec4,
                                         int tid, int nthreads, Store& store) {
    const long long n_in = (long long)B * L;
    Walker w;
    if (vec4) {
        long long g = (first & ~3LL) + 4LL * tid;
        if (g > last) return;
        const uint32_t step = 4u * (uint32_t)nthreads;
        // the next group's words are loaded before this group is mixed, so
        // that the load's latency hides behind the mix (a thread of a
        // cascade_fast.cu slab mixes only a few groups between barriers)
        const int4* words = static_cast<const int4*>(in);
        const float4* planes = static_cast<const float4*>(in);
        int4 v;
        float4 vi, vq;
        if (kInF32) {
            vi = planes[g >> 2];
            vq = planes[(n_in + g) >> 2];
        } else {
            v = words[g >> 2];
        }
        walker_seek(w, g, step, plans, stride, L);
        for (;;) {
            float fi[4], fq[4];
            const long long gn = g + step;
            if (kInF32) {
                fi[0] = vi.x; fi[1] = vi.y; fi[2] = vi.z; fi[3] = vi.w;
                fq[0] = vq.x; fq[1] = vq.y; fq[2] = vq.z; fq[3] = vq.w;
                if (gn <= last) {
                    vi = planes[gn >> 2];
                    vq = planes[(n_in + gn) >> 2];
                }
            } else {
                decode_i16(v.x, fi[0], fq[0]);
                decode_i16(v.y, fi[1], fq[1]);
                decode_i16(v.z, fi[2], fq[2]);
                decode_i16(v.w, fi[3], fq[3]);
                if (gn <= last) v = words[gn >> 2];
            }
            // the four phases first, then the four tones and rotations as
            // one straight line: four independent chains for the scheduler
            int q24[4];
            walker_q24x4(w, q24);
            float oi[4], oq[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                mix_q24<kSelect>(fi[i], fq[i], q24[i], oi[i], oq[i]);
            if (g >= first && g + 3 <= last) {      // all but the ragged ends
                if constexpr (HasGroupStore<Store>::value) {
                    store.group(g, oi, oq);
                } else {
#pragma unroll
                    for (int i = 0; i < 4; ++i) store(g + i, oi[i], oq[i]);
                }
            } else {
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    if (g + i >= first && g + i <= last) store(g + i, oi[i], oq[i]);
            }
            g += step;
            if (g > last) break;
            walker_advance(w, step, plans, stride, L);
        }
    } else {
        long long g = first + tid;
        if (g > last) return;
        const uint32_t step = (uint32_t)nthreads;
        walker_seek(w, g, step, plans, stride, L);
        for (;;) {
            float fi, fq, oi, oq;
            if (kInF32) {
                fi = static_cast<const float*>(in)[g];
                fq = static_cast<const float*>(in)[n_in + g];
            } else {
                decode_i16(static_cast<const int*>(in)[g], fi, fq);
            }
            mix_q24<kSelect>(fi, fq, walker_q24(w, 0u, w.prod), oi, oq);
            store(g, oi, oq);
            g += step;
            if (g > last) break;
            walker_advance(w, step, plans, stride, L);
        }
    }
}

// ×32767, truncate toward zero, NaN → 0, saturate (main.rs:76-84), written
// out for the host build.
__device__ __forceinline__ int encode_i16(float v) {
    v = truncf(__fmul_rn(v, 32767.0f));
    if (isnan(v)) v = 0.0f;
    v = fminf(fmaxf(v, -32768.0f), 32767.0f);
    return (int)v;
}

// Two encoded values as one LE IQ pair word.  On the card each value is one
// conversion: cvt.rzi.s16.f32 truncates, takes NaN to 0 and saturates to the
// int16 range, which is encode_i16 for every float, ±∞ included, and the two
// halves are packed as they come.
__device__ __forceinline__ int pack_i16(float i, float q) {
#ifdef __CUDACC__
    short si, sq;
    asm("cvt.rzi.s16.f32 %0, %1;" : "=h"(si) : "f"(__fmul_rn(i, 32767.0f)));
    asm("cvt.rzi.s16.f32 %0, %1;" : "=h"(sq) : "f"(__fmul_rn(q, 32767.0f)));
    unsigned r;
    asm("mov.b32 %0, {%1, %2};" : "=r"(r) : "h"(si), "h"(sq));
    return (int)r;
#else
    return (int)(((unsigned)encode_i16(i) & 0xFFFFu) |
                 ((unsigned)encode_i16(q) << 16));
#endif
}

}  // namespace doppler
