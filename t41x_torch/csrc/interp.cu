// K3: x2 then x4 output interpolation with the volume folded in.
//
// Replaces the TPU kernel t41x/kernels/interp_pallas.py,
// FusedInterp._kernel: two CMSIS zero-stuff polyphase interpolators
// (t41x.dsp.fir.fir_interpolate semantics, histories at the input rate)
// taking the 256-sample 24 kHz block to 2048 samples at 192 kHz, the
// per-channel DF * volume scale applied at the store, and the stage-2
// history tail as a second output (int1' = audio[-23:] is formed by the
// wrapper).
//
// Layout: one thread block per channel.  The 48 kHz intermediate lives
// only in shared memory; device memory sees 1 KB in and 8 KB out per
// channel.  What bounds it on the card: the 8 KB store per channel
// (~8 MB per block at 1024 channels), plus ~16 FMAs per output sample.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
interp_kernel(const float* __restrict__ audio,   // (C, n)
              const float* __restrict__ int1,    // (C, sub1-1)
              const float* __restrict__ int2,    // (C, sub2-1)
              const float* __restrict__ vol,     // (C,)
              const float* __restrict__ hp1,     // (sub1, L1) reversed phases
              const float* __restrict__ hp2,     // (sub2, L2)
              int n, int sub1, int L1, int sub2, int L2,
              float* __restrict__ y,             // (C, n L1 L2)
              float* __restrict__ nint2)         // (C, sub2-1)
{
    extern __shared__ float sm[];
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    const int n1 = n * L1, n2 = n1 * L2;
    float* xc1 = sm;                      // (sub1-1 + n)  [int1 | audio]
    float* xc2 = xc1 + (sub1 - 1 + n);    // (sub2-1 + n1) [int2 | x2 out]
    float* h1 = xc2 + (sub2 - 1 + n1);    // (sub1 L1)
    float* h2 = h1 + sub1 * L1;           // (sub2 L2)

    for (int i = tid; i < sub1 - 1; i += THREADS)
        xc1[i] = int1[(size_t)c * (sub1 - 1) + i];
    for (int i = tid; i < n; i += THREADS)
        xc1[sub1 - 1 + i] = audio[(size_t)c * n + i];
    for (int i = tid; i < sub2 - 1; i += THREADS)
        xc2[i] = int2[(size_t)c * (sub2 - 1) + i];
    for (int i = tid; i < sub1 * L1; i += THREADS) h1[i] = hp1[i];
    for (int i = tid; i < sub2 * L2; i += THREADS) h2[i] = hp2[i];
    __syncthreads();

    // stage 1 (x L1): y1[m L1 + p] = sum_j hp1[j][p] xc1[m + j]
    for (int o = tid; o < n1; o += THREADS) {
        const int m = o / L1, p = o % L1;
        float acc = 0.f;
        for (int j = 0; j < sub1; ++j) acc += h1[j * L1 + p] * xc1[m + j];
        xc2[sub2 - 1 + o] = acc;
    }
    __syncthreads();

    for (int i = tid; i < sub2 - 1; i += THREADS)
        nint2[(size_t)c * (sub2 - 1) + i] = xc2[n1 + i];

    // stage 2 (x L2), scaled at the store
    const float v = vol[c];
    for (int o = tid; o < n2; o += THREADS) {
        const int m = o / L2, p = o % L2;
        float acc = 0.f;
        for (int j = 0; j < sub2; ++j) acc += h2[j * L2 + p] * xc2[m + j];
        y[(size_t)c * n2 + o] = acc * v;
    }
}

}  // namespace

extern "C" int t41x_interp(
    const void* audio, const void* int1, const void* int2, const void* vol,
    const void* hp1, const void* hp2, int channels, int n, int sub1, int L1,
    int sub2, int L2, void* y, void* nint2, void* stream)
{
    if (channels <= 0) return 0;
    const size_t smem = (size_t)(sub1 - 1 + n + sub2 - 1 + n * L1
                                 + sub1 * L1 + sub2 * L2) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            interp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    interp_kernel<<<channels, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)audio, (const float*)int1, (const float*)int2,
        (const float*)vol, (const float*)hp1, (const float*)hp2, n, sub1, L1,
        sub2, L2, (float*)y, (float*)nint2);
    return (int)cudaGetLastError();
}
