// What one group of four steps of fir.cuh's register tile costs an SM, apart
// from the kernels: a stand-alone program (tools/fir_group_bench.py builds and
// runs it).  A thread owns the three phases of one window as the chain does
// at P/Q = 3/64: a group is 4 loads of x as float2 (the lanes 65 entries
// apart, as in a padded span at S = 64), 3 warp-uniform 16-byte loads of taps
// and 24 FFMA.  The variants take the loads away one kind at a time, fetch
// them another way, or give a thread two windows, and the program prints the
// clocks a group of one warp takes (clock64 around the loop, averaged over
// the SMs) and the SM's clocks for 24 FFMA of a warp, at several numbers of
// resident warps.  24 FFMA and the loop are ≈ 29 instructions, 7.25 clocks of
// an SM's four issue slots; what a variant takes above that is its loads.
#include <cstdio>
#include <cuda_runtime.h>

__constant__ float c_taps[4096];

// kX: 0 keep x in registers, 1 four 8-byte loads (lanes 65 entries apart), 2
// two 16-byte loads (lanes 66 apart, which keeps 16-byte alignment and the
// banks of a quarter warp apart).  kTaps: 0 keep the taps in registers, 1 one
// 16-byte shared load an output, 2 four 4-byte shared loads, 3 __constant__
// memory.  kR: neighbouring windows a thread (their taps 64 apart, as at
// Q = 64): 3·kR outputs share each loaded x.
template <int kX, int kTaps, int kR>
__global__ void __launch_bounds__(512, 2)
fir_group(float* out, long long* clocks, int groups) {
    extern __shared__ float4 smem4[];
    float* smem = reinterpret_cast<float*>(smem4);
    for (int i = threadIdx.x; i < 12288; i += blockDim.x) smem[i] = i * 1e-6f;
    __syncthreads();
    float ai[3][kR], aq[3][kR];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int r = 0; r < kR; ++r) ai[p][r] = aq[p][r] = 0.0f;
    }
    const int lane = threadIdx.x & 31;
    // an odd entry for the 16-byte loads: they take (xp − 1, xp), (xp − 3, xp − 2)
    const float2* xp = reinterpret_cast<const float2*>(smem)
        + (kX == 2 ? 1025 + lane * 66 : 1024 + lane * 65);
    const float* row[3] = {smem + 64, smem + 576, smem + 1088};
    float2 v[4] = {{1, 2}, {3, 4}, {5, 6}, {7, 8}};
    float4 w = {1, 2, 3, 4};
    const long long t0 = clock64();
    int l4 = 0;
#pragma unroll 2
    for (int it = 0; it < groups; ++it) {
        if (kX == 1) {
            v[0] = xp[0];
            v[1] = xp[-1];
            v[2] = xp[-2];
            v[3] = xp[-3];
        }
        if (kX == 2) {
            const float4 a = *reinterpret_cast<const float4*>(xp - 1);
            const float4 b = *reinterpret_cast<const float4*>(xp - 3);
            v[0] = make_float2(a.z, a.w);
            v[1] = make_float2(a.x, a.y);
            v[2] = make_float2(b.z, b.w);
            v[3] = make_float2(b.x, b.y);
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) {
#pragma unroll
            for (int r = 0; r < kR; ++r) {
                const float* t = row[p] + l4 - 64 * r;
                if (kTaps == 1) w = *reinterpret_cast<const float4*>(t);
                if (kTaps == 2) w = make_float4(t[0], t[1], t[2], t[3]);
                if (kTaps == 3) {
                    const float* c = c_taps + (t - smem);
                    w = make_float4(c[0], c[1], c[2], c[3]);
                }
                ai[p][r] = __fmaf_rn(w.x, v[0].x, ai[p][r]);
                aq[p][r] = __fmaf_rn(w.x, v[0].y, aq[p][r]);
                ai[p][r] = __fmaf_rn(w.y, v[1].x, ai[p][r]);
                aq[p][r] = __fmaf_rn(w.y, v[1].y, aq[p][r]);
                ai[p][r] = __fmaf_rn(w.z, v[2].x, ai[p][r]);
                aq[p][r] = __fmaf_rn(w.z, v[2].y, aq[p][r]);
                ai[p][r] = __fmaf_rn(w.w, v[3].x, ai[p][r]);
                aq[p][r] = __fmaf_rn(w.w, v[3].y, aq[p][r]);
            }
        }
        xp -= 4;
        l4 += 4;
        if (l4 >= 360) {
            l4 = 0;
            xp += 360;
        }
    }
    const long long t1 = clock64();
    float sum = 0.0f;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int r = 0; r < kR; ++r) sum += ai[p][r] + aq[p][r];
    }
    out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
    if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}

template <int kX, int kTaps, int kR>
int run(const char* name, int warps, int sms) {
    const int groups = 20000, smem = 49152;
    float* out;
    long long* clocks;
    if (cudaMalloc(&out, sizeof(float) * sms * warps * 32) != cudaSuccess ||
        cudaMalloc(&clocks, sizeof(long long) * sms) != cudaSuccess)
        return 1;
    for (int rep = 0; rep < 2; ++rep)
        fir_group<kX, kTaps, kR><<<sms, warps * 32, smem>>>(out, clocks, groups);
    if (cudaDeviceSynchronize() != cudaSuccess) return 1;
    long long* host = new long long[sms];
    cudaMemcpy(host, clocks, sizeof(long long) * sms, cudaMemcpyDeviceToHost);
    double sum = 0;
    for (int i = 0; i < sms; ++i) sum += (double)host[i];
    delete[] host;
    cudaFree(out);
    cudaFree(clocks);
    const double per_warp = sum / sms / groups;
    printf("fir_group: %-28s %2d warps an SM: %7.2f clocks a group of one warp, "
           "%6.2f SM clocks for 24 FFMA of a warp\n", name, warps, per_warp,
           per_warp / warps / kR);
    return 0;
}

int main() {
    cudaDeviceProp prop;
    if (cudaGetDeviceProperties(&prop, 0) != cudaSuccess) {
        fprintf(stderr, "no CUDA device\n");
        return 1;
    }
    const int sms = prop.multiProcessorCount;
    int bad = 0;
    for (int warps : {2, 4, 6, 8, 12, 16}) {
        bad |= run<1, 1, 1>("x + taps 16-byte", warps, sms);
        bad |= run<1, 0, 1>("x, taps in registers", warps, sms);
        bad |= run<0, 1, 1>("taps 16-byte alone", warps, sms);
        bad |= run<0, 0, 1>("FFMA alone", warps, sms);
        bad |= run<1, 2, 1>("x + taps 4-byte", warps, sms);
        bad |= run<1, 3, 1>("x + taps __constant__", warps, sms);
        bad |= run<2, 1, 1>("x 16-byte + taps 16-byte", warps, sms);
        bad |= run<1, 1, 2>("two windows: x + taps", warps, sms);
        bad |= run<2, 1, 2>("two windows: x 16-byte", warps, sms);
    }
    return bad;
}
