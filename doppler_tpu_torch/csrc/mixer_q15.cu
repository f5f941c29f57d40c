// Integer-domain mixer: the mixer's plan words and tone, the sample path kept
// in int32 — i16 components × a Q15 tone, truncating ÷2¹⁵, saturate, pack.
//
// Replaces doppler_tpu/ops/pallas/mixer.py:294 _make_q15_kernel (reached
// through mix_blocks_pallas_q15, mixer.py:357).
//
// Not byte-exact against the reference: the tone carries 15 bits, so the
// output sits a few LSB from the float32 mixer's.  It exists to be timed
// beside mixer.cu: both move 8 B/sample (bound: HBM bytes), and this one
// does without the two i16→f32 casts, the 1/32768 and 32767 scalings and
// the float encode, so the difference of the two times is what those cost.
//
// Design: mixer.cu's launch shape (one CTA covers a tile of one block, so
// the plan words are uniform across the CTA; a warp reads 128 contiguous
// bytes), one channel.
//
// Rounding.  The Q15 tone is (int)(v·32767 ± 0.5): __fmul_rn, then
// __fadd_rn, then the truncating float→int cast, each rounded on its own as
// the plain torch version's three operations are.  The scale is 32767, not
// 32768, so |i·c − q·s| ≤ 2·32768·32767 < 2³¹ and the int32 products cannot
// overflow.  `>>` on a negative int is the arithmetic shift.
#include <cuda_runtime.h>

#include "nco.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;

// v·32767 rounded half away from zero.
__device__ __forceinline__ int q15(float v) {
    return (int)__fadd_rn(__fmul_rn(v, 32767.0f), v >= 0.0f ? 0.5f : -0.5f);
}

// ÷2¹⁵ truncating toward zero, then saturate to i16.
__device__ __forceinline__ int down(int v) {
    v = (v + ((v >> 31) & 32767)) >> 15;
    return min(max(v, -32768), 32767);
}

__global__ void __launch_bounds__(kThreads)
mixer_q15_kernel(const int* __restrict__ in, int* __restrict__ out,
                 const uint32_t* __restrict__ plans, int B, int L,
                 int tiles_per_block) {
    const int b = blockIdx.x / tiles_per_block;
    const int j0 = (blockIdx.x - b * tiles_per_block) * kTile;
    const doppler::Plan p = doppler::load_plan(plans, (size_t)B, b);
    const long long row = (long long)b * L;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
        const int j = j0 + k * kThreads + threadIdx.x;
        if (j >= L) break;
        const int w = in[row + j];
        const int iw = (int)(short)(w & 0xFFFF);
        const int qw = w >> 16;
        float c, s;
        doppler::sincos_q24_neg(doppler::phase_q24((uint32_t)j, p), c, s);
        const int c15 = q15(c), s15 = q15(s);
        const int re = iw * c15 - qw * s15;
        const int im = iw * s15 + qw * c15;
        out[row + j] = (int)(((unsigned)down(re) & 0xFFFFu) |
                             ((unsigned)down(im) << 16));
    }
}

}  // namespace

// in, out: int32 words (B, L); plans: (7, B) uint32.  Returns
// cudaGetLastError() after the launch.
extern "C" int doppler_mix_blocks_q15(const void* in, void* out,
                                      const uint32_t* plans, int B, int L,
                                      void* stream) {
    if (B <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
    const int tpb = (L + kTile - 1) / kTile;
    const long long grid = (long long)B * tpb;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    mixer_q15_kernel<<<(unsigned)grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(in), static_cast<int*>(out), plans, B, L, tpb);
    return (int)cudaGetLastError();
}
