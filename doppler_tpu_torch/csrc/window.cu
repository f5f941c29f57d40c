// The polyphase resampler's window form on the card: M outputs of a
// streaming chunk from its [T−1 history | inputs] buffer.
//
// Replaces the XLA gather + fixed-tree function doppler_tpu/ops/resample.py:61
// window_dot (no Pallas kernel: the JAX package leaves it to XLA), which
// the stream runs wherever the fused kernels do not take a chunk: the EOF
// chunk and the drain, every chunk under --impl xla, a split cascade's tail
// stages, the mixer + resampler route of an ineligible geometry, and the
// window step of --mesh.  Its plain version (ops/resample.py window_dot)
// sums a fixed power-of-two tree; this kernel sums each output as the chain
// and cascade kernels' FIR does (fir.cuh): one __fmaf_rn chain over the taps
// l = 0..T−1 of bank[p] from +0, newest input first.  So on the card a
// chunk gives the same bits whether the fused kernel or the mixer and this
// kernel compute it, and the bytes do not depend on the chunk width.
//
// Function.  Output j (0 ≤ j < M) of channel c: u = j·Q + rem0,
// p = u mod P, base = off0 + ⌊u/P⌋;
//     y[j] = Σ_{l<T} bank[p, l] · x[base + T − 1 − l]
// (bank_rev[p, k] = bank[p, T−1−k] is what the caller holds).  Indices
// clamp to [0, len), as window_dot's gather clips: only outputs past the
// valid count reach the edges.
//
// Bound on this card.  Bytes: each input read once and each output written
// once, 8·C·(len + M) bytes at 3.35 TB/s.  Operations: T FMAs an
// output-plane, 2·T·2·C·M float32 operations at 67 TFLOP/s.  At config 3's
// single stage (P/Q = 3/64, T = 370) an output costs 370 FMAs and reads
// 64/3 input samples: bound by bytes.
//
// Design.  One thread an output-plane value, consecutive threads on
// consecutive outputs, the plane in blockIdx.y; a thread walks its T-sample
// window downwards through L1 (the P outputs of a window and its
// neighbours share most of it).  A simple first kernel, as the conv form's
// (conv.cu): no shared-memory tile, no register tile.
#include <cuda_runtime.h>

namespace {

constexpr int kWindowThreads = 256;

struct WindowArgs {
    long long len;      // samples of each input row
    long long x_stride; // elements between channel rows of the input
    long long M;        // outputs a row
    long long off0;     // buffer index of ⌊m0·Q/P⌋ − (T−1)
    int C, P, Q, T, rem0;
};

__global__ void __launch_bounds__(kWindowThreads)
window_kernel(const float* __restrict__ xi, const float* __restrict__ xq,
              const float* __restrict__ bank_rev, float* __restrict__ yi,
              float* __restrict__ yq, const __grid_constant__ WindowArgs a) {
    const long long o = (long long)blockIdx.x * kWindowThreads + threadIdx.x;
    if (o >= (long long)a.C * a.M) return;
    const long long c = o / a.M;
    const long long j = o - c * a.M;
    const float* x = (blockIdx.y ? xq : xi) + c * a.x_stride;
    float* y = (blockIdx.y ? yq : yi) + c * a.M;
    const long long u = j * a.Q + a.rem0;
    const long long n = u / a.P;
    const int p = (int)(u - n * a.P);
    const long long base = a.off0 + n;
    const float* taps = bank_rev + (long long)p * a.T;
    const long long last = a.len - 1;
    float acc = 0.0f;
    for (int k = a.T - 1; k >= 0; --k) {     // tap l = T−1−k, ascending
        long long idx = base + k;
        idx = idx < 0 ? 0 : (idx > last ? last : idx);
        acc = __fmaf_rn(__ldg(taps + k), x[idx], acc);
    }
    y[j] = acc;
}

}  // namespace

// xi, xq: (C, x_stride) float32 rows of len samples; bank_rev: (P, T);
// yi, yq: (C, M).  Returns cudaGetLastError() after the launch.
extern "C" int doppler_window(const float* xi, const float* xq,
                              const float* bank_rev, float* yi, float* yq, int C,
                              long long len, long long x_stride, long long M,
                              int rem0, long long off0, int P, int Q, int T,
                              void* stream) {
    if (C < 1 || M < 1 || P < 1 || Q < 1 || T < 1 || rem0 < 0 || rem0 >= P
            || len < 1 || x_stride < len)
        return (int)cudaErrorInvalidValue;
    WindowArgs a{len, x_stride, M, off0, C, P, Q, T, rem0};
    const long long n = (long long)C * M;
    const long long ctas = (n + kWindowThreads - 1) / kWindowThreads;
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    window_kernel<<<dim3((unsigned)ctas, 2), kWindowThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(xi, xq, bank_rev, yi, yq, a);
    return (int)cudaGetLastError();
}
