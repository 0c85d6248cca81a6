// K8: the Kim & Ruwisch NR gain recursion for n hops.
//
// Replaces the TPU kernel t41x/kernels/nr_gain_pallas.py, _kernel
// (kim_gains_pallas): for each hop, write the hop's bin powers into the
// 3-slot X ring and their 3-frame mean into the 15-slot E ring (minimum
// statistics), take the minimum over E, apply the psi gain rule, the VAD
// band mask, the alpha time EMA and the 3-bin frequency smoothing.
//
// Layout: one thread block per channel, one thread per bin (128).  Each
// thread holds its bin's 3 + 15 ring slots and time-smoothed gain in
// registers for all hops (predicated stores at the ring slot keep the
// arrays in registers), so X and E are read once and written once per
// launch, whatever the number of hops; the smoothing takes the
// neighbouring bins through shared memory.  The ring slot is channel 0's
// cursor, read from device memory (the lockstep invariant of
// t41x.dsp.nr.kim_nr: every channel advances one hop per call), so no
// host sync.  What bounds it on the card: the ring traffic, 18 floats in
// and out per bin (~19 MB a block at 1024 channels).  The arithmetic is
// elementwise, each operation rounded on its own, plus an exact minimum:
// it matches the plain torch version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int HOP = 128;  // bins, one thread each

struct KimP {
    float psi, alpha, oma, beta, omb;  // oma = 1 - alpha, omb = 1 - 2 beta
    int vad_low, vad_high;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

__device__ __forceinline__ int floor_mod(int v, int m) { return ((v % m) + m) % m; }

__global__ void __launch_bounds__(HOP)
kim_gain_kernel(const float* __restrict__ powers,  // (n_hops, C, HOP)
                const float* __restrict__ X_in,    // (C, 3, HOP)
                const float* __restrict__ E_in,    // (C, 15, HOP)
                const float* __restrict__ G_in,    // (C, HOP)
                const int* __restrict__ idx,       // (C,), idx[0] used
                int channels, int n_hops, KimP p,
                float* __restrict__ gains,         // (n_hops, C, HOP)
                float* __restrict__ X_out, float* __restrict__ E_out,
                float* __restrict__ G_out)
{
    __shared__ float sg[HOP];
    const int c = blockIdx.x, b = threadIdx.x;
    float X[3], E[15];
#pragma unroll
    for (int s = 0; s < 3; ++s) X[s] = X_in[((size_t)c * 3 + s) * HOP + b];
#pragma unroll
    for (int s = 0; s < 15; ++s) E[s] = E_in[((size_t)c * 15 + s) * HOP + b];
    float gts = G_in[(size_t)c * HOP + b];
    const int cursor = idx[0];
    const bool in_band = b >= p.vad_low && b < p.vad_high;

    for (int h = 0; h < n_hops; ++h) {
        const float power = powers[((size_t)h * channels + c) * HOP + b];
        const int s3 = floor_mod(cursor + h, 3), s15 = floor_mod(cursor + h, 15);
#pragma unroll
        for (int s = 0; s < 3; ++s)
            if (s == s3) X[s] = power;
        const float e_new = __fdiv_rn(add(add(X[0], X[1]), X[2]), 3.f);
#pragma unroll
        for (int s = 0; s < 15; ++s)
            if (s == s15) E[s] = e_new;
        float M = E[0];
#pragma unroll
        for (int s = 1; s < 15; ++s) M = fminf(M, E[s]);

        const float T = __fdiv_rn(power, fmaxf(M, 1e-30f));
        const float lam = T > p.psi ? M : e_new;
        float G = fmaxf(__fsub_rn(1.f, __fdiv_rn(lam, fmaxf(e_new, 1e-30f))),
                        0.f);
        G = in_band ? G : 0.f;
        gts = add(mul(p.alpha, gts), mul(p.oma, G));

        // 3-bin smoothing, edge bins replicated
        sg[b] = gts;
        __syncthreads();
        const float left = sg[b > 0 ? b - 1 : 0];
        const float right = sg[b < HOP - 1 ? b + 1 : HOP - 1];
        gains[((size_t)h * channels + c) * HOP + b] =
            add(add(mul(p.beta, left), mul(p.omb, gts)), mul(p.beta, right));
        __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) X_out[((size_t)c * 3 + s) * HOP + b] = X[s];
#pragma unroll
    for (int s = 0; s < 15; ++s) E_out[((size_t)c * 15 + s) * HOP + b] = E[s];
    G_out[(size_t)c * HOP + b] = gts;
}

}  // namespace

// fparams: psi, alpha, 1 - alpha, beta, 1 - 2 beta (host memory)
extern "C" int t41x_kim_gains(
    const void* powers, const void* X, const void* E, const void* Gts,
    const void* idx, int channels, int n_hops, const float* fparams,
    int vad_low, int vad_high, void* gains, void* X_out, void* E_out,
    void* G_out, void* stream)
{
    if (channels <= 0 || n_hops <= 0) return 0;
    KimP p;
    p.psi = fparams[0];
    p.alpha = fparams[1];
    p.oma = fparams[2];
    p.beta = fparams[3];
    p.omb = fparams[4];
    p.vad_low = vad_low;
    p.vad_high = vad_high;
    kim_gain_kernel<<<channels, HOP, 0, (cudaStream_t)stream>>>(
        (const float*)powers, (const float*)X, (const float*)E,
        (const float*)Gts, (const int*)idx, channels, n_hops, p,
        (float*)gains, (float*)X_out, (float*)E_out, (float*)G_out);
    return (int)cudaGetLastError();
}
