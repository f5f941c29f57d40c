// The chain and cascade kernels of doppler_tpu_torch/csrc run on the CPU:
// a CTA's threads one after the other, phase by phase (the barrier between
// two phases is the end of the loop over the threads), over the device
// functions the kernels are made of — built with a host compiler through
// csrc/host_shim.cuh.  Beside them a reference that sums every output as one
// fmaf chain over l = 0..T−1 from mix_at's samples, one output at a time:
// what the kernels must equal byte for byte whatever their tile, threads and
// register tile.  The kernel of --precision fast (chain_fast.cu) runs a
// warp's 32 lanes at once where it calls mma.sync: its host stand-in takes
// the 32 lanes' fragments in the PTX layout.  Its bytes are its own (a
// tensor core does not add as IEEE float32 does), so its reference is the
// plain torch version, within a tolerance, and itself across geometries;
// so is the cascade's (cascade_fast.cu), on the same stand-in.  The mixer
// (mixer.cu) runs its CTAs' threads one after the other; its reference is
// the plain torch version, bitwise.
//
//   g++ -O1 -ffp-contract=off -shared -fPIC -std=c++17 \
//       -I doppler_tpu_torch/csrc -o emu.so \
//       doppler_tpu_torch/csrc/host/kernel_emulation.cpp
#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

#include "cascade.cu"
#include "cascade_fast.cu"
#include "chain.cu"
#include "chain_fast.cu"
#include "mixer.cu"

using namespace doppler;

namespace {

// shared memory the way a fresh CTA finds it: nothing a result may depend
// on (all ones: a NaN as float32 and as bf16)
void poison(std::vector<float4>& smem) {
    std::memset(smem.data(), 0xFF, smem.size() * sizeof(float4));
}

template <bool kInF32>
void mixed_stream(const void* in, const uint32_t* plans, size_t stride, int B,
                  int L, std::vector<float>& xi, std::vector<float>& xq) {
    const long long n = (long long)B * L;
    xi.resize(n);
    xq.resize(n);
    int cur = -1;
    Plan p;
    for (long long g = 0; g < n; ++g)
        mix_at<kInF32>(g, in, plans, stride, B, L, cur, p, xi[g], xq[g]);
}

// one stage, one output at a time; x[k < 0] from the carry
void ref_stage(const std::vector<float>& xi, const std::vector<float>& xq,
               const float* carry, const float* bank, int P, int Q, int T,
               std::vector<float>& yi, std::vector<float>& yq, float* carry_out) {
    const int H = T - 1;
    const long long n = (long long)xi.size(), m_total = n / Q * P;
    auto at = [&](const std::vector<float>& x, int plane, long long k) {
        return k < 0 ? carry[(plane + 1) * H + k] : x[k];
    };
    yi.resize(m_total);
    yq.resize(m_total);
    for (long long m = 0; m < m_total; ++m) {
        const long long u = m * Q, nm = u / P;
        const float* w = bank + (u - nm * P) * T;
        float ai = 0.0f, aq = 0.0f;
        for (int l = 0; l < T; ++l) {
            ai = std::fmaf(w[l], at(xi, 0, nm - l), ai);
            aq = std::fmaf(w[l], at(xq, 1, nm - l), aq);
        }
        yi[m] = ai;
        yq[m] = aq;
    }
    for (int k = 0; k < H; ++k) {
        carry_out[k] = at(xi, 0, n - H + k);
        carry_out[H + k] = at(xq, 1, n - H + k);
    }
}

void write_out(const std::vector<float>& yi, const std::vector<float>& yq,
               void* out, int C, int ch, int out_f32) {
    const long long n = (long long)yi.size();
    for (long long j = 0; j < n; ++j) {
        if (out_f32) {
            static_cast<float*>(out)[ch * n + j] = yi[j];
            static_cast<float*>(out)[((long long)C + ch) * n + j] = yq[j];
        } else {
            static_cast<int*>(out)[ch * n + j] = pack_i16(yi[j], yq[j]);
        }
    }
}

template <bool kInF32>
void run_cascade(const void* in, void* out, const uint32_t* plans,
                 const Geometry& g, int B, int L, int threads, long long smem) {
    std::vector<float4> shared((smem + 15) / 16);
    for (unsigned block = 0; block < (unsigned)(g.C * g.units); ++block) {
        poison(shared);
        CtaPlan plan;
        cascade_plan(g, block, plan);
        for (int ph = 0;; ++ph) {
            bool more = false;
            for (int tid = 0; tid < threads; ++tid)
                more = cascade_phase<kInF32>(in, out, plans, g, B, L, plan, tid,
                                             threads, ph,
                                             reinterpret_cast<float*>(shared.data()));
            if (!more) break;
        }
    }
}

template <bool kInF32>
void run_chain(const void* in, void* out, const uint32_t* plans,
               const ChainArgs& g, int threads, long long smem) {
    std::vector<float4> shared((smem + 15) / 16);
    const unsigned grid = (unsigned)(g.C * (g.n_tiles + (g.f.T > 1 ? 1 : 0)));
    for (unsigned block = 0; block < grid; ++block) {
        poison(shared);
        ChainPlan plan;
        chain_plan(g, block, plan);
        for (int ph = 0;; ++ph) {
            bool more = false;
            for (int tid = 0; tid < threads; ++tid)
                more = chain_phase<kInF32>(in, out, plans, g, plan, tid, threads,
                                           ph, reinterpret_cast<float*>(shared.data()));
            if (!more) break;
        }
    }
}

template <bool kInF32, bool kOddS, int kPasses>
void run_chain_fast(const void* in, void* out, const uint32_t* plans,
                    const FastArgs& g, int threads, long long smem) {
    std::vector<float4> shared((smem + 15) / 16);
    const unsigned grid = (unsigned)(g.C * (g.n_tiles + (g.T > 1 ? 1 : 0)));
    for (unsigned block = 0; block < grid; ++block) {
        poison(shared);
        int ch, unit;
        split_block(block, g.C, g.n_tiles + (g.T > 1), ch, unit);
        for (int ph = 0;; ++ph) {
            bool more = false;
            for (int tid = 0; tid < threads; ++tid)
                more = chain_fast_phase<kInF32, kOddS, kPasses>(
                    in, out, plans, g, ch, unit, tid, threads, ph,
                    reinterpret_cast<unsigned*>(shared.data()));
            if (!more) break;
        }
    }
}

template <bool kInF32, int kPasses>
void run_cascade_fast(const void* in, void* out, const uint32_t* plans,
                      const FastCascade& g, int threads, long long smem) {
    std::vector<float4> shared((smem + 15) / 16);
    for (unsigned block = 0; block < (unsigned)g.units; ++block) {
        poison(shared);
        FastCtaPlan plan;
        fast_cascade_plan(g, block, plan);
        for (int ph = 0;; ++ph) {
            bool more = false;
            for (int tid = 0; tid < threads; ++tid)
                more = fast_cascade_phase<kInF32, kPasses>(
                    in, out, plans, g, plan, tid, threads, ph,
                    reinterpret_cast<unsigned*>(shared.data()));
            if (!more) break;
        }
    }
}

template <bool kInF32, bool kOutF32, bool kVec4>
void run_mixer(const void* in, void* out, const uint32_t* plans, const MixerArgs& a,
               long long ctas) {
    for (long long block = 0; block < ctas; ++block)
        for (int tid = 0; tid < kMixerThreads; ++tid)
            mixer_cta<kInF32, kOutF32, kVec4>(in, out, plans, a, (unsigned)block, tid);
}

}  // namespace

// doppler_mix_blocks's arguments (csrc/mixer.cu), all pointers to host
// memory; returns 2 where the launch takes the 16-byte path, 1 where it
// takes one sample a step, 0 where the arguments are refused.
extern "C" int emu_mixer(const void* in, void* out, const uint32_t* plans, int C,
                         int B, int L, int in_f32, int out_f32, int G) {
    const bool vec4 = mixer_vec4(in, out, L);
    MixerArgs a;
    long long ctas;
    if (!make_mixer_args(a, C, B, L, G, vec4, ctas)) return 0;
    auto run = vec4 ? (in_f32 ? (out_f32 ? run_mixer<true, true, true> : run_mixer<true, false, true>)
                              : (out_f32 ? run_mixer<false, true, true> : run_mixer<false, false, true>))
                    : (in_f32 ? (out_f32 ? run_mixer<true, true, false> : run_mixer<true, false, false>)
                              : (out_f32 ? run_mixer<false, true, false> : run_mixer<false, false, false>));
    run(in, out, plans, a, ctas);
    return vec4 ? 2 : 1;
}

// doppler_cascade's arguments (csrc/cascade.cu), all pointers to host memory.
extern "C" int emu_cascade(const void* in, void* out, const uint32_t* plans,
                           const void* const* banks, const void* const* carry_in,
                           void* const* carry_out, const int* layout, int S, int C,
                           int B, int L, int tile, int threads, long long smem,
                           int in_f32, int out_f32) {
    Geometry g;
    if (!make_geometry(g, in, banks, carry_in, carry_out, layout, S, C, B, L,
                       tile, out_f32))
        return 1;
    if (in_f32) {
        run_cascade<true>(in, out, plans, g, B, L, threads, smem);
    } else {
        run_cascade<false>(in, out, plans, g, B, L, threads, smem);
    }
    return 0;
}

// doppler_chain's arguments (csrc/chain.cu), all pointers to host memory.
extern "C" int emu_chain(const void* in, void* out, const uint32_t* plans,
                         const float* bank, const float* carry_in,
                         float* carry_out, int C, int B, int L, int P, int Q,
                         int T, int tile, int threads, int R, int tap_stride,
                         int tap_off, int buf_off, long long smem, int in_f32,
                         int out_f32) {
    ChainArgs g;
    if (!make_chain_args(g, in, bank, carry_in, carry_out, C, B, L, P, Q, T,
                         tile, R, tap_stride, tap_off, buf_off, out_f32))
        return 1;
    if (in_f32) {
        run_chain<true>(in, out, plans, g, threads, smem);
    } else {
        run_chain<false>(in, out, plans, g, threads, smem);
    }
    return 0;
}

// The reference: stages = 3 ints a stage (P, Q, T); the other arguments as
// emu_cascade's.  A chain is a cascade of one stage.
extern "C" int ref_cascade(const void* in, void* out, const uint32_t* plans,
                           const void* const* banks, const void* const* carry_in,
                           void* const* carry_out, const int* stages, int S, int C,
                           int B, int L, int in_f32, int out_f32) {
    for (int ch = 0; ch < C; ++ch) {
        std::vector<float> xi, xq, yi, yq;
        if (in_f32) {
            mixed_stream<true>(in, plans + (size_t)ch * B, (size_t)C * B, B, L, xi, xq);
        } else {
            mixed_stream<false>(in, plans + (size_t)ch * B, (size_t)C * B, B, L, xi, xq);
        }
        for (int s = 0; s < S; ++s) {
            const int P = stages[3 * s], Q = stages[3 * s + 1], T = stages[3 * s + 2];
            const size_t off = (size_t)ch * 2 * (T - 1);
            ref_stage(xi, xq, static_cast<const float*>(carry_in[s]) + off,
                      static_cast<const float*>(banks[s]), P, Q, T, yi, yq,
                      static_cast<float*>(carry_out[s]) + off);
            xi.swap(yi);
            xq.swap(yq);
        }
        write_out(xi, xq, out, C, ch, out_f32);
    }
    return 0;
}

// doppler_chain_fast's arguments (csrc/chain_fast.cu), all pointers to host
// memory; passes 3 (split3) or 1 (default, the compact layout).
extern "C" int emu_chain_fast(const void* in, void* out, const uint32_t* plans,
                              const unsigned* taps, const float* carry_in,
                              float* carry_out, int C, int B, int L, int P, int Q,
                              int T, int D, int wt, int threads, int plane,
                              int g_off, int x_off, long long smem, int in_f32,
                              int out_f32, int passes) {
    FastArgs g;
    if (threads % 32 || (passes != 1 && passes != 3) ||
        !make_fast_args(g, in, taps, carry_in, carry_out, C, B, L, P, Q, T, D,
                        passes == 1, wt, plane, g_off, x_off, out_f32, smem))
        return 1;
    const bool odd = g.S & 1;
    auto run = passes == 1
        ? (in_f32 ? (odd ? run_chain_fast<true, true, 1> : run_chain_fast<true, false, 1>)
                  : (odd ? run_chain_fast<false, true, 1> : run_chain_fast<false, false, 1>))
        : (in_f32 ? (odd ? run_chain_fast<true, true, 3> : run_chain_fast<true, false, 3>)
                  : (odd ? run_chain_fast<false, true, 3> : run_chain_fast<false, false, 3>));
    run(in, out, plans, g, threads, smem);
    return 0;
}

// doppler_cascade_fast's arguments (csrc/cascade_fast.cu), all pointers to
// host memory.
extern "C" int emu_cascade_fast(const void* in, void* out, const uint32_t* plans,
                                const void* const* taps, const void* const* carry_in,
                                void* const* carry_out, const int* layout, int S, int B,
                                int L, int wt, int slab, int threads, long long smem,
                                int in_f32, int out_f32, int passes) {
    FastCascade g;
    if (threads % 32 || !make_fast_cascade(g, in, taps, carry_in, carry_out, layout, S,
                                           B, L, wt, slab, out_f32, passes, smem))
        return 1;
    auto run = passes == 1 ? (in_f32 ? run_cascade_fast<true, 1> : run_cascade_fast<false, 1>)
                           : (in_f32 ? run_cascade_fast<true, 3> : run_cascade_fast<false, 3>);
    run(in, out, plans, g, threads, smem);
    return 0;
}

// fast_cascade_plan of every CTA of a launch (doppler_cascade_fast's layout,
// S, B, L, wt, slab, passes and smem; no data): 3 + 6·S values a CTA, t, a,
// c, then per stage s < S ja, jb, w0, rows, org, len (zeros above t).
// Returns the CTA count, or −1 where the arguments are refused.
extern "C" int emu_fast_cascade_plans(const int* layout, int S, int B, int L, int wt,
                                      int slab, int passes, long long smem,
                                      long long* out) {
    const void* none[kFastStages] = {};
    FastCascade g;
    if (!make_fast_cascade(g, nullptr, none, none, const_cast<void* const*>(none),
                           layout, S, B, L, wt, slab, 0, passes, smem))
        return -1;
    for (int block = 0; block < g.units; ++block) {
        FastCtaPlan p;
        fast_cascade_plan(g, (unsigned)block, p);
        long long* o = out + (long long)block * (3 + 6 * S);
        o[0] = p.t;
        o[1] = p.a;
        o[2] = p.c;
        for (int s = 0; s < S; ++s) {
            const bool on = s < p.t;
            o[3 + 6 * s] = on ? p.ja[s] : 0;
            o[4 + 6 * s] = on ? p.jb[s] : 0;
            o[5 + 6 * s] = on ? p.w0[s] : 0;
            o[6 + 6 * s] = on ? p.rows[s] : 0;
            o[7 + 6 * s] = on ? p.org[s] : 0;
            o[8 + 6 * s] = on ? p.len[s] : 0;
        }
    }
    return g.units;
}
