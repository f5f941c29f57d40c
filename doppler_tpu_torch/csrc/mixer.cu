// Mixer kernel: decode → exact Q0.64 NCO phase → quarter-wave tone →
// rotate → encode, elementwise over a (B, L) chunk of reference blocks.
//
// Replaces doppler_tpu/ops/pallas/mixer.py:139 _make_mixer_kernel (reached
// through mix_blocks_pallas_fmt, mixer.py:227).
//
// Bound: HBM bytes — 8 B/sample i16→i16, up to 16 B/sample f32→f32; the
// arithmetic (one 64-bit multiply-add and ~25 float ops a sample) is far
// below the card's rate.  Design: one CTA covers TILE consecutive samples
// of one block, so the block's 7 plan words are uniform across the CTA (the
// TPU kernel's scalar prefetch becomes a broadcast load); each thread
// strides by blockDim so a warp reads 128 contiguous bytes per plane.
//
// Wire formats: i16 = int32 words (B, L); f32 = planar float32 (2, B, L)
// with the I plane first.  The NaN → 0 encode rule applies to f32 input.
//
// Channels: C channels mix the same (B, L) chunk, each with its own plan
// words (7, C, B), into (C, B, L) words or (2, C, B, L) planes — what
// doppler_tpu/runtime/channels.py:64 _channels_mix_kernel computes.  A
// single stream is C = 1.  The channel is the fast index of the grid (see
// nco.cuh split_block), so the C CTAs that read one input tile run together.
#include <cuda_runtime.h>

#include "nco.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;

template <bool kInF32, bool kOutF32>
__global__ void __launch_bounds__(kThreads)
mixer_kernel(const void* __restrict__ in, void* __restrict__ out,
             const uint32_t* __restrict__ plans, int C, int B, int L,
             int tiles_per_block) {
    int c, unit;
    doppler::split_block(blockIdx.x, C, B * tiles_per_block, c, unit);
    const int b = unit / tiles_per_block;
    const int j0 = (unit - b * tiles_per_block) * kTile;
    const doppler::Plan p =
        doppler::load_plan(plans + (size_t)c * B, (size_t)C * B, b);
    const long long n = (long long)B * L;
    const long long row = (long long)b * L;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int j = j0 + k * kThreads + threadIdx.x;
        if (j >= L) break;
        const long long g = row + j;
        float fi, fq;
        if (kInF32) {
            fi = static_cast<const float*>(in)[g];
            fq = static_cast<const float*>(in)[n + g];
        } else {
            doppler::decode_i16(static_cast<const int*>(in)[g], fi, fq);
        }
        float oi, oq;
        doppler::mix_sample(fi, fq, (uint32_t)j, p, oi, oq);
        if (kOutF32) {
            // output planes (2, C, n): Q sits C·n after I
            static_cast<float*>(out)[c * n + g] = oi;
            static_cast<float*>(out)[((long long)C + c) * n + g] = oq;
        } else {
            static_cast<int*>(out)[c * n + g] = doppler::pack_i16(oi, oq);
        }
    }
}

template <bool kInF32, bool kOutF32>
int launch(const void* in, void* out, const uint32_t* plans, int C, int B,
           int L, cudaStream_t stream) {
    const int tpb = (L + kTile - 1) / kTile;
    const long long grid = (long long)C * B * tpb;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    mixer_kernel<kInF32, kOutF32><<<(unsigned)grid, kThreads, 0, stream>>>(
        in, out, plans, C, B, L, tpb);
    return (int)cudaGetLastError();
}

}  // namespace

// in: device pointer in the wire layouts above; out: (C, B, L) words or
// (2, C, B, L) planes; plans: (7, C, B) uint32.  Returns cudaGetLastError()
// after the launch.
extern "C" int doppler_mix_blocks(const void* in, void* out,
                                  const uint32_t* plans, int C, int B, int L,
                                  int in_f32, int out_f32, void* stream) {
    if (C <= 0 || B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (in_f32) {
        return out_f32 ? launch<true, true>(in, out, plans, C, B, L, s)
                       : launch<true, false>(in, out, plans, C, B, L, s);
    }
    return out_f32 ? launch<false, true>(in, out, plans, C, B, L, s)
                   : launch<false, false>(in, out, plans, C, B, L, s);
}

// Message for a cudaError_t code returned by the entry points.
extern "C" const char* doppler_error_string(int e) {
    return cudaGetErrorString(static_cast<cudaError_t>(e));
}
