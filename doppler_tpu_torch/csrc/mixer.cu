// Mixer kernel: decode → exact Q0.64 NCO phase → quarter-wave tone →
// rotate → encode, elementwise over a (B, L) chunk of reference blocks,
// for C channels that each mix the same chunk with their own plan words.
//
// Replaces doppler_tpu/ops/pallas/mixer.py:139 _make_mixer_kernel (reached
// through mix_blocks_pallas_fmt, mixer.py:227).  Its channel axis does the
// work of the jitted XLA function doppler_tpu/runtime/channels.py:65
// _channels_mix_kernel: C channels mix the same (B, L) chunk, each with its
// own plan words (7, C, B), into (C, B, L) words or (2, C, B, L) planes.  A
// single stream is C = 1.
//
// Wire formats: i16 = int32 words (B, L); f32 = planar float32 (2, B, L)
// with the I plane first.  The NaN → 0 encode rule applies to f32 input.
//
// Bound on this card.  Bytes: 4 B a sample in (8 for f32 planes) and 4 B a
// channel-sample out (8), at 3.35 TB/s; operations: the mix's 29 float32
// operations a channel-sample (nco.cuh), none of them an FMA (-fmad=false),
// so 29 instructions at half the card's 67 TFLOP/s FMA rate.  One stream
// (C = 1, i16 → i16, 8 B a sample) is bound by bytes; at C = 16 the bytes
// (0.683 ms at B = 16384) and the instructions are near each other, and
// the instructions a channel-sample decide: chip_smoke.py counts them from
// the SASS and prints the count.
//
// Design.  A CTA owns a tile of samples of one block and a group of G
// channels (mixer_group below; the last group may hold fewer).  So the plan words are uniform across the CTA, and a
// thread:
// - takes four neighbouring samples from one 16-byte load of words (two
//   for f32 planes), kMixerIters groups in all, every load issued before
//   the first mix, and decodes them once for all G channels;
// - advances each channel's phase with nco.cuh's walker: one 64-bit
//   product a channel when it starts, then adds (walker_q24x4: the four
//   phases of a group from one running sum);
// - mixes them for one channel after the other (a loop that is not
//   unrolled: its body, 16 channel-samples, stays small in the instruction
//   cache) and gives each group of four one 16-byte store a channel (f32:
//   one float4 a plane).
// Ten CTAs of 128 threads an SM (at most 48 registers a thread, a word or
// two spilled): the stream, bound by its bytes, and the channels, bound by
// their instructions, both want the warps (PERF.md times 128 threads × 4
// groups against 256 × 2, 512 × 1 and 64 × 8, and caps of 64 to 48
// registers).
// Where L % 4 ≠ 0 or a pointer is not 16-byte aligned, a thread takes one
// sample a step instead (kVec4 = false), with the per-sample phase product
// of mix_sample: the same bits.  The channel group is the fast index of
// the grid (nco.cuh split_block), so the CTAs that read one input tile run
// together and all but the first find it in L2.
#include "nco.cuh"

namespace doppler {

constexpr int kMixerThreads = 128;
constexpr int kMixerIters = 4;     // groups of four samples a thread (16-byte path)
constexpr int kMixerMinCtas = 10;  // CTAs an SM: at most 48 registers a thread
constexpr int kMixerPerThread = 8; // samples a thread (one-sample path)
// CTAs a launch keeps when it picks its channel group (mixer_group): about
// 16 an SM of an H100's 132, where ten fit at once.  From chip_smoke.py's
// sweep of G at C = 16 (PERF.md §6): at B = 256 (256 tiles) G = 2 (2048
// CTAs) was the fastest in three runs, G = 4 (1024) 0.4–5% slower, G = 8
// (512) 5–14% and G = 16 (256) 47–90%; at B = 16384 every G keeps far more
// CTAs and G = 16 is the fastest.
constexpr long long kMixerMinGrid = 2048;

// One launch: C channels in groups of G over a (B, L) chunk.
struct MixerArgs {
    int C, B, L;
    int G;                  // channels a CTA
    int groups;             // ⌈C / G⌉
    int tiles_per_block;
};

// Samples a CTA covers, with and without the 16-byte path.
__host__ __device__ constexpr int mixer_tile(bool vec4) {
    return vec4 ? 4 * kMixerIters * kMixerThreads : kMixerPerThread * kMixerThreads;
}

// Channels a CTA mixes from one decode of its samples: the most of 16, 8,
// 4, 2, 1, at most C, that still leaves kMixerMinGrid CTAs over the (B, L)
// chunk; else 1.  Any C works: the last group may hold fewer.
__host__ __device__ inline int mixer_group(int C, int B, int L, bool vec4) {
    const long long tiles = (long long)B * ((L + mixer_tile(vec4) - 1) / mixer_tile(vec4));
    for (int G = 16; G > 1; G /= 2)
        if (G <= C && (long long)((C + G - 1) / G) * tiles >= kMixerMinGrid) return G;
    return 1;
}

// Channel c's output at chunk index g: i16 words (C, n) or planes (2, C, n).
template <bool kOutF32>
__device__ __forceinline__ void mixer_put(void* out, int C, int c, long long n,
                                          long long g, float oi, float oq) {
    if (kOutF32) {
        static_cast<float*>(out)[c * n + g] = oi;
        static_cast<float*>(out)[((long long)C + c) * n + g] = oq;
    } else {
        static_cast<int*>(out)[c * n + g] = pack_i16(oi, oq);
    }
}

// The four samples g .. g+3 of channel c as one 16-byte store (a plane).
template <bool kOutF32>
__device__ __forceinline__ void mixer_put4(void* out, int C, int c, long long n,
                                           long long g, const float* oi,
                                           const float* oq) {
    if (kOutF32) {
        float* o = static_cast<float*>(out);
        *reinterpret_cast<float4*>(o + c * n + g) = make_float4(oi[0], oi[1], oi[2], oi[3]);
        *reinterpret_cast<float4*>(o + ((long long)C + c) * n + g) =
            make_float4(oq[0], oq[1], oq[2], oq[3]);
    } else {
        *reinterpret_cast<int4*>(static_cast<int*>(out) + c * n + g) =
            make_int4(pack_i16(oi[0], oq[0]), pack_i16(oi[1], oq[1]),
                      pack_i16(oi[2], oq[2]), pack_i16(oi[3], oq[3]));
    }
}

// CTA `block`'s work for thread `tid` of kMixerThreads.
template <bool kInF32, bool kOutF32, bool kVec4>
__device__ __forceinline__ void mixer_cta(const void* __restrict__ in,
                                          void* __restrict__ out,
                                          const uint32_t* __restrict__ plans,
                                          const MixerArgs& a, unsigned block, int tid) {
    int grp, unit;
    split_block(block, a.groups, a.B * a.tiles_per_block, grp, unit);
    const int b = unit / a.tiles_per_block;
    const int j0 = (unit - b * a.tiles_per_block) * mixer_tile(kVec4);
    const int c0 = grp * a.G;
    const int c_end = c0 + a.G < a.C ? c0 + a.G : a.C;
    const size_t stride = (size_t)a.C * a.B;
    const long long n = (long long)a.B * a.L;
    const long long row = (long long)b * a.L;
    if (kVec4) {
        const uint32_t step = 4u * kMixerThreads;
        const int j_first = j0 + 4 * tid;
        if (j_first >= a.L) return;
        // every load first, so that they are all in flight together
        float fi[kMixerIters][4], fq[kMixerIters][4];
#pragma unroll
        for (int k = 0; k < kMixerIters; ++k) {
            const long long g = row + j_first + (long long)k * step;
            if (j_first + k * (int)step >= a.L) break;
            if (kInF32) {
                const float4 vi = *reinterpret_cast<const float4*>(static_cast<const float*>(in) + g);
                const float4 vq = *reinterpret_cast<const float4*>(static_cast<const float*>(in) + n + g);
                fi[k][0] = vi.x; fi[k][1] = vi.y; fi[k][2] = vi.z; fi[k][3] = vi.w;
                fq[k][0] = vq.x; fq[k][1] = vq.y; fq[k][2] = vq.z; fq[k][3] = vq.w;
            } else {
                const int4 v = *reinterpret_cast<const int4*>(static_cast<const int*>(in) + g);
                decode_i16(v.x, fi[k][0], fq[k][0]);
                decode_i16(v.y, fi[k][1], fq[k][1]);
                decode_i16(v.z, fi[k][2], fq[k][2]);
                decode_i16(v.w, fi[k][3], fq[k][3]);
            }
        }
#pragma unroll 1
        for (int c = c0; c < c_end; ++c) {
            Walker w;
            walker_start(w, b, (uint32_t)j_first, step, plans + (size_t)c * a.B, stride);
#pragma unroll
            for (int k = 0; k < kMixerIters; ++k) {
                if (j_first + k * (int)step >= a.L) break;
                int q24[4];
                walker_q24x4(w, q24);
                float oi[4], oq[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) mix_q24(fi[k][i], fq[k][i], q24[i], oi[i], oq[i]);
                mixer_put4<kOutF32>(out, a.C, c, n, row + w.j, oi, oq);
                w.j += step;                // inside the block: no reload
                w.prod += w.step_d;
            }
        }
        return;
    }
    float fi[kMixerPerThread], fq[kMixerPerThread];
#pragma unroll
    for (int k = 0; k < kMixerPerThread; ++k) {
        const int j = j0 + k * kMixerThreads + tid;
        if (j >= a.L) break;
        const long long g = row + j;
        if (kInF32) {
            fi[k] = static_cast<const float*>(in)[g];
            fq[k] = static_cast<const float*>(in)[n + g];
        } else {
            decode_i16(static_cast<const int*>(in)[g], fi[k], fq[k]);
        }
    }
#pragma unroll 1
    for (int c = c0; c < c_end; ++c) {
        const Plan p = load_plan(plans + (size_t)c * a.B, stride, b);
#pragma unroll
        for (int k = 0; k < kMixerPerThread; ++k) {
            const int j = j0 + k * kMixerThreads + tid;
            if (j >= a.L) break;
            float oi, oq;
            mix_sample(fi[k], fq[k], (uint32_t)j, p, oi, oq);
            mixer_put<kOutF32>(out, a.C, c, n, row + j, oi, oq);
        }
    }
}

// MixerArgs and the CTA count of a launch (G ≤ 0: mixer_group's); false
// where the arguments are not ones the kernel takes.
inline bool make_mixer_args(MixerArgs& a, int C, int B, int L, int G, bool vec4,
                            long long& ctas) {
    if (C <= 0 || B <= 0 || L <= 0) return false;
    a.G = G > 0 ? G : mixer_group(C, B, L, vec4);
    a.C = C;
    a.B = B;
    a.L = L;
    a.groups = (C + a.G - 1) / a.G;
    const int tile = mixer_tile(vec4);
    a.tiles_per_block = (L + tile - 1) / tile;
    ctas = (long long)a.groups * B * a.tiles_per_block;
    return ctas <= 0x7FFFFFFFLL;
}

// Whether a launch takes the 16-byte path: L % 4 == 0 and both pointers
// 16-byte aligned (then every group of four lies inside its block).
inline bool mixer_vec4(const void* in, const void* out, int L) {
    return L % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
           reinterpret_cast<uintptr_t>(out) % 16 == 0;
}

}  // namespace doppler

// The channel group a launch of C channels over a (B, L) chunk on the
// 16-byte path takes when it is given none (doppler_mix_blocks, G = 0).
extern "C" int doppler_mixer_group(int C, int B, int L) {
    return doppler::mixer_group(C, B, L, true);
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

namespace {

using doppler::MixerArgs;

template <bool kInF32, bool kOutF32, bool kVec4>
__global__ void __launch_bounds__(doppler::kMixerThreads, doppler::kMixerMinCtas)
mixer_kernel(const void* __restrict__ in, void* __restrict__ out,
             const uint32_t* __restrict__ plans, const __grid_constant__ MixerArgs a) {
    doppler::mixer_cta<kInF32, kOutF32, kVec4>(in, out, plans, a, blockIdx.x,
                                               (int)threadIdx.x);
}

template <bool kInF32, bool kOutF32>
int launch(const void* in, void* out, const uint32_t* plans, int C, int B, int L,
           int G, cudaStream_t stream) {
    const bool vec4 = doppler::mixer_vec4(in, out, L);
    MixerArgs a;
    long long ctas;
    if (!doppler::make_mixer_args(a, C, B, L, G, vec4, ctas))
        return (int)cudaErrorInvalidValue;
    if (vec4) {
        mixer_kernel<kInF32, kOutF32, true>
            <<<(unsigned)ctas, doppler::kMixerThreads, 0, stream>>>(in, out, plans, a);
    } else {
        mixer_kernel<kInF32, kOutF32, false>
            <<<(unsigned)ctas, doppler::kMixerThreads, 0, stream>>>(in, out, plans, a);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// in: device pointer in the wire layouts above; out: (C, B, L) words or
// (2, C, B, L) planes; plans: (7, C, B) uint32; G: channels a CTA, or 0
// for mixer_group's.  Returns cudaGetLastError() after the launch.
extern "C" int doppler_mix_blocks(const void* in, void* out,
                                  const uint32_t* plans, int C, int B, int L,
                                  int in_f32, int out_f32, int G, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (in_f32) {
        return out_f32 ? launch<true, true>(in, out, plans, C, B, L, G, s)
                       : launch<true, false>(in, out, plans, C, B, L, G, s);
    }
    return out_f32 ? launch<false, true>(in, out, plans, C, B, L, G, s)
                   : launch<false, false>(in, out, plans, C, B, L, G, s);
}

// Message for a cudaError_t code returned by the entry points.
extern "C" const char* doppler_error_string(int e) {
    return cudaGetErrorString(static_cast<cudaError_t>(e));
}

#endif  // __CUDACC__
