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
// Design.  One thread an output-plane value, consecutive threads on
// consecutive m, the plane in blockIdx.y.  A thread walks its window row
// from device memory through L1: the P threads of one cycle read the same
// row and neighbouring cycles overlap by (R−1)·Q samples, so L1 serves most
// loads.  The taps come through the read-only path.  A simple first kernel:
// no shared-memory tile and no skipping of the zero taps.
#include <cuda_runtime.h>

namespace {

constexpr int kConvThreads = 256;

struct ConvArgs {
    long long len;      // samples of each input row
    long long x_stride; // elements between channel rows of the input
    long long M;        // outputs a row
    long long start0;   // input index where cycle p0 / P's window row begins
    int C, P, Q, R, w_len, p0;
};

__global__ void __launch_bounds__(kConvThreads)
conv_kernel(const float* __restrict__ xi, const float* __restrict__ xq,
            const float* __restrict__ taps, float* __restrict__ yi,
            float* __restrict__ yq, const __grid_constant__ ConvArgs a) {
    const long long o = (long long)blockIdx.x * kConvThreads + threadIdx.x;
    if (o >= (long long)a.C * a.M) return;
    const long long c = o / a.M;
    const long long m = o - c * a.M;
    const float* x = (blockIdx.y ? xq : xi) + c * a.x_stride;
    float* y = (blockIdx.y ? yq : yi) + c * a.M;
    const long long f = a.p0 + m;
    const long long k = f / a.P;
    const int p = (int)(f - k * a.P);
    const long long base = a.start0 + k * a.Q;
    // rows of the window that lie inside [0, len)
    const long long lo = base < 0 ? -base : 0;
    const long long hi = a.len - base;
    float acc = 0.0f;
    for (int r = 0; r < a.R; ++r) {
        float t = 0.0f;
        for (int q = 0; q < a.Q; ++q) {
            const int row = r * a.Q + q;
            const float v = (row >= lo && row < hi) ? x[base + row] : 0.0f;
            const float w = row < a.w_len ? __ldg(taps + (long long)row * a.P + p) : 0.0f;
            t = __fmaf_rn(v, w, t);
        }
        acc = r == 0 ? t : __fadd_rn(acc, t);
    }
    y[m] = acc;
}

}  // namespace

// xi, xq: (C, x_stride) float32 rows of len samples; taps: (w_len, P);
// yi, yq: (C, M).  Returns cudaGetLastError() after the launch.
extern "C" int doppler_conv(const float* xi, const float* xq, const float* taps,
                            float* yi, float* yq, int C, long long len,
                            long long x_stride, long long M, long long start0,
                            int p0, int P, int Q, int R, int w_len, void* stream) {
    if (C < 1 || M < 1 || P < 1 || Q < 1 || R < 1 || w_len < 1 || w_len > R * Q
            || p0 < 0 || p0 >= P || len < 0 || x_stride < len)
        return (int)cudaErrorInvalidValue;
    ConvArgs a{len, x_stride, M, start0, C, P, Q, R, w_len, p0};
    const long long n = (long long)C * M;
    const long long ctas = (n + kConvThreads - 1) / kConvThreads;
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    conv_kernel<<<dim3((unsigned)ctas, 2), kConvThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(xi, xq, taps, yi, yq, a);
    return (int)cudaGetLastError();
}
