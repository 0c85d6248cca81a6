// E1: the 14-band EQ, every band's cascade and the gain-weighted band
// sum, over a block of n samples (n a multiple of 32).
//
// Replaces no TPU kernel: t41x runs the EQ as the lax.scan of
// t41x/dsp/eq.py EQDesign.apply (:110), two dense products a 32-sample
// chunk on [x | 56 states] (every band's outputs, the next states),
// then the signed, gain-weighted sum over the 14 bands.  The port's
// plain version (t41x_torch.dsp.eq EQDesign.apply_plain) runs that
// scan as ~30 launches a 256-sample block and writes the (C, 14, n)
// band tensor to device memory.
//
// The same chunk recurrence from the operators' nonzero blocks
// (EQDesign.kernel_consts, the float32 values of the plain version's
// matrices): band b's chunk output is L_b x + R_b s_b with L_b the
// Toeplitz matrix of its impulse response h_b, and its next state
// G_b^T x + AK_b s_b.  The signed gains g_b fold in before the chunk
// loop: the channel's band sum is sum_b g_b y_b = (sum_b g_b h_b) * x
// + sum_{b,m} R_b[:, m] (g_b s_b[m]), one 32-tap response a channel
// instead of 14, and the band tensor never reaches device memory.
//
// Layout: one warp a channel, four a block; lane k computes the
// chunk's output sample k (its row of R in registers, the effective
// response in registers, the input's earlier samples by shuffles) and
// owns states k and k + 32 (their G columns and AK rows in registers).
// The chunk's input, states and gain-weighted states pass between the
// lanes through the warp's shared memory, read as broadcasts.  What
// bounds it on the card: the operations, ~4.4 k FMAs a chunk and
// channel in this form (the per-sample biquads would need ~2.5 k); its
// bytes, the block in and out and the states, take less.  Full fp32
// FMAs only, no tensor cores; the sums run in another order than the
// plain version's cuBLAS products.

#include <cuda_runtime.h>

namespace {

constexpr int BANDS = 14;
constexpr int K = 32;              // samples a chunk, one lane each
constexpr int NS = 56;             // states: 14 bands x 2 stages x 2
constexpr int SPB = NS / BANDS;    // states a band
constexpr int WARPS = 4;           // channels a block
constexpr unsigned FULL = 0xffffffffu;
// offsets of kernel_consts' parts: h (14, K), R (K, 56), G (56, K),
// AK (56, 4), signs (14,)
constexpr int OFF_H = 0;
constexpr int OFF_R = OFF_H + BANDS * K;
constexpr int OFF_G = OFF_R + K * NS;
constexpr int OFF_AK = OFF_G + NS * K;
constexpr int OFF_SIGN = OFF_AK + NS * SPB;
constexpr int N_CONSTS = OFF_SIGN + BANDS;

__device__ __forceinline__ void warp_sync() { __syncwarp(); }

__device__ __forceinline__ float4 ld4(const float* p)
{
    return __ldg(reinterpret_cast<const float4*>(p));
}

__global__ void __launch_bounds__(WARPS * 32)
eq_kernel(const float* __restrict__ x,        // (C, n)
          const float* __restrict__ state_in, // (C, 56)
          const float* __restrict__ gains,    // (C, 14)
          const float* __restrict__ ops,      // kernel_consts
          int channels, int n_chunks,
          float* __restrict__ y,              // (C, n)
          float* __restrict__ state_out)      // (C, 56)
{
    __shared__ __align__(16) float sh_h[WARPS][K];
    __shared__ __align__(16) float sh_x[WARPS][K];
    __shared__ __align__(16) float sh_s[WARPS][NS];
    __shared__ __align__(16) float sh_gs[WARPS][NS];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int c = blockIdx.x * WARPS + warp;
    if (c >= channels) return;   // the whole warp
    const float* g_c = gains + (size_t)c * BANDS;

    // lane's row of R, and the G columns and AK rows of its two states
    float r[NS];
#pragma unroll
    for (int i = 0; i < NS / 4; ++i) {
        const float4 v = ld4(ops + OFF_R + lane * NS + 4 * i);
        r[4 * i] = v.x; r[4 * i + 1] = v.y; r[4 * i + 2] = v.z; r[4 * i + 3] = v.w;
    }
    const int n0 = lane, n1 = lane + 32;
    const bool has1 = n1 < NS;
    const int n1c = has1 ? n1 : n0;
    const int b0 = n0 / SPB, b1 = n1c / SPB;
    float g0[K], g1[K];
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
        const float4 u = ld4(ops + OFF_G + n0 * K + 4 * i);
        const float4 v = ld4(ops + OFF_G + n1c * K + 4 * i);
        g0[4 * i] = u.x; g0[4 * i + 1] = u.y; g0[4 * i + 2] = u.z; g0[4 * i + 3] = u.w;
        g1[4 * i] = v.x; g1[4 * i + 1] = v.y; g1[4 * i + 2] = v.z; g1[4 * i + 3] = v.w;
    }
    const float4 ak0 = ld4(ops + OFF_AK + n0 * SPB);
    const float4 ak1 = ld4(ops + OFF_AK + n1c * SPB);
    const float sc0 = __fmul_rn(__ldg(ops + OFF_SIGN + b0), g_c[b0]);
    const float sc1 = __fmul_rn(__ldg(ops + OFF_SIGN + b1), g_c[b1]);

    // the channel's effective response: sum_b sign_b gain_b h_b
    float he = 0.f;
#pragma unroll
    for (int b = 0; b < BANDS; ++b)
        he = fmaf(__fmul_rn(__ldg(ops + OFF_SIGN + b), g_c[b]),
                  __ldg(ops + OFF_H + b * K + lane), he);
    sh_h[warp][lane] = he;
    float s0 = state_in[(size_t)c * NS + n0];
    float s1 = state_in[(size_t)c * NS + n1c];
    warp_sync();
    float hr[K];
#pragma unroll
    for (int i = 0; i < K / 4; ++i) {
        const float4 v = reinterpret_cast<const float4*>(sh_h[warp])[i];
        hr[4 * i] = v.x; hr[4 * i + 1] = v.y; hr[4 * i + 2] = v.z; hr[4 * i + 3] = v.w;
    }

    const float* xc = x + (size_t)c * n_chunks * K;
    float* yc = y + (size_t)c * n_chunks * K;
    float xn = xc[lane];
    for (int q = 0; q < n_chunks; ++q) {
        const float xq = xn;
        if (q + 1 < n_chunks) xn = xc[(q + 1) * K + lane];
        sh_x[warp][lane] = xq;
        sh_s[warp][n0] = s0;
        sh_gs[warp][n0] = __fmul_rn(sc0, s0);
        if (has1) {
            sh_s[warp][n1] = s1;
            sh_gs[warp][n1] = __fmul_rn(sc1, s1);
        }
        warp_sync();

        // output sample `lane`: the effective response over the chunk's
        // samples so far, then the gain-weighted states through R
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < K; ++d) {
            const float xd = __shfl_up_sync(FULL, xq, d);
            acc = fmaf(lane >= d ? hr[d] : 0.f, xd, acc);
        }
        float acc2 = 0.f;
#pragma unroll
        for (int i = 0; i < NS / 4; ++i) {
            const float4 v = reinterpret_cast<const float4*>(sh_gs[warp])[i];
            acc2 = fmaf(r[4 * i], v.x, acc2);
            acc2 = fmaf(r[4 * i + 1], v.y, acc2);
            acc2 = fmaf(r[4 * i + 2], v.z, acc2);
            acc2 = fmaf(r[4 * i + 3], v.w, acc2);
        }
        yc[q * K + lane] = acc + acc2;

        // the next states: G^T x + AK s, within each band
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int i = 0; i < K / 4; ++i) {
            const float4 v = reinterpret_cast<const float4*>(sh_x[warp])[i];
            a0 = fmaf(g0[4 * i], v.x, a0);
            a0 = fmaf(g0[4 * i + 1], v.y, a0);
            a0 = fmaf(g0[4 * i + 2], v.z, a0);
            a0 = fmaf(g0[4 * i + 3], v.w, a0);
            a1 = fmaf(g1[4 * i], v.x, a1);
            a1 = fmaf(g1[4 * i + 1], v.y, a1);
            a1 = fmaf(g1[4 * i + 2], v.z, a1);
            a1 = fmaf(g1[4 * i + 3], v.w, a1);
        }
        const float4 t0 = reinterpret_cast<const float4*>(sh_s[warp])[b0];
        const float4 t1 = reinterpret_cast<const float4*>(sh_s[warp])[b1];
        a0 = fmaf(ak0.x, t0.x, fmaf(ak0.y, t0.y, fmaf(ak0.z, t0.z, fmaf(ak0.w, t0.w, a0))));
        a1 = fmaf(ak1.x, t1.x, fmaf(ak1.y, t1.y, fmaf(ak1.z, t1.z, fmaf(ak1.w, t1.w, a1))));
        // every lane has read this chunk's arrays before any overwrites
        warp_sync();
        s0 = a0;
        s1 = a1;
    }
    state_out[(size_t)c * NS + n0] = s0;
    if (has1) state_out[(size_t)c * NS + n1] = s1;
}

}  // namespace

extern "C" int t41x_eq(const void* x, const void* state, const void* gains,
                       const void* ops, int n_consts,
                       int channels, int n, void* y, void* state_out,
                       void* stream)
{
    if (n_consts != N_CONSTS || n % K != 0 || n <= 0) return (int)cudaErrorInvalidValue;
    if (channels <= 0) return 0;
    const int blocks = (channels + WARPS - 1) / WARPS;
    eq_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)state, (const float*)gains,
        (const float*)ops, channels, n / K, (float*)y,
        (float*)state_out);
    return (int)cudaGetLastError();
}
