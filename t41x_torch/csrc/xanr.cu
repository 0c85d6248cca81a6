// K7: the variable-leak LMS (WDSP Xanr) over one block.
//
// Replaces the TPU kernel t41x/kernels/xanr_pallas.py, _kernel
// (xanr_block_pallas): per audio sample, the 64-tap prediction over the
// delayed regressor window, the error, the leak-index update (with the
// reference's lidx quirk, Noise.cpp:353-358), the leak factor and the
// weight update.  Output: the prediction times post_gain (NR mode 3) or
// the error (the automatic notch).
//
// Layout: one warp per channel, 2 taps per lane (taps k = lane and
// lane + 32, oldest-first), the weights in registers for the whole
// block.  The oldest-first [80-sample history | block] regressor buffer
// sits in shared memory, so each step's window is a conflict-free read
// at offset n + 1.  The prediction and the regressor energy are
// butterfly (xor-shuffle) reductions, which leave the same bits on every
// lane, so the scalar leak update runs on all lanes alike and every lane
// updates its own taps.  What bounds it on the card: the serial chain of
// 256 dependent steps, each two 5-level shuffle reductions and a few
// dozen scalar operations; the channel count sets only how many warps
// run side by side.  The sums are taken in another order than
// torch.sum, and the LMS feeds rounding back into its weights, so the
// kernel and the plain version agree closely over a block and drift
// apart over long streams (as the TPU kernel and its scan did).

#include <cuda_runtime.h>

namespace {

constexpr int TAPS = 64;       // 2 per lane
constexpr int WARPS = 4;       // channels per thread block
constexpr unsigned FULL = 0xffffffffu;

struct XanrP {
    float two_mu, gamma, den_mult, lidx_min, lidx_max, lincr, ldecr,
        out_scale;
    int notch;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float warp_sum(float v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__global__ void __launch_bounds__(WARPS * 32)
xanr_kernel(const float* __restrict__ x,      // (C, n)
            const float* __restrict__ hist,   // (C, HD) oldest-first
            const float* __restrict__ w_in,   // (C, TAPS) oldest-first
            const float* __restrict__ lidx_in, const float* __restrict__ ng_in,
            int channels, int n, int hd, XanrP p,
            float* __restrict__ y,            // (C, n)
            float* __restrict__ w_out,        // (C, TAPS) oldest-first
            float* __restrict__ lidx_out, float* __restrict__ ng_out)
{
    extern __shared__ float sm[];
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int c = blockIdx.x * WARPS + warp;
    if (c >= channels) return;  // ragged last block: whole warps only
    float* pad = sm + (size_t)warp * (hd + 2 * n);  // [history | block]
    float* out = pad + hd + n;                       // (n) outputs

    for (int i = lane; i < hd; i += 32) pad[i] = hist[(size_t)c * hd + i];
    for (int i = lane; i < n; i += 32) pad[hd + i] = x[(size_t)c * n + i];
    __syncwarp();

    float w0 = w_in[(size_t)c * TAPS + lane];
    float w1 = w_in[(size_t)c * TAPS + lane + 32];
    float lidx = lidx_in[c], ngamma = ng_in[c];
    for (int t = 0; t < n; ++t) {
        const float xn = pad[hd + t];
        // reg[k] = pad[t + 1 + k]: x[t - D - (TAPS-1) + k], oldest first
        const float r0 = pad[t + 1 + lane], r1 = pad[t + 1 + lane + 32];
        const float yp = warp_sum(add(mul(w0, r0), mul(w1, r1)));
        const float sigma = warp_sum(add(mul(r0, r0), mul(r1, r1)));
        const float inv_sigp = __fdiv_rn(1.f, add(sigma, 1e-10f));
        const float error = sub(xn, yp);
        if (lane == 0) out[t] = p.notch ? error : yp;

        const float nel = fabsf(mul(error, sub(1.f, mul(mul(p.two_mu, sigma),
                                                        inv_sigp))));
        const float nev = fabsf(sub(
            sub(xn, mul(sub(1.f, mul(p.two_mu, ngamma)), yp)),
            mul(mul(mul(p.two_mu, error), sigma), inv_sigp)));
        const bool over = add(lidx, p.lincr) > p.lidx_max;
        const float lidx_new = over ? p.lidx_max
            : fmaxf(sub(add(lidx, p.lincr), p.ldecr), p.lidx_min);
        lidx = nev < nel ? lidx_new : lidx;
        const float l2 = mul(lidx, lidx);
        ngamma = mul(mul(p.gamma, mul(l2, l2)), p.den_mult);

        const float c0 = sub(1.f, mul(p.two_mu, ngamma));
        const float c1 = mul(mul(p.two_mu, error), inv_sigp);
        w0 = add(mul(c0, w0), mul(c1, r0));
        w1 = add(mul(c0, w1), mul(c1, r1));
    }
    __syncwarp();

    w_out[(size_t)c * TAPS + lane] = w0;
    w_out[(size_t)c * TAPS + lane + 32] = w1;
    if (lane == 0) {
        lidx_out[c] = lidx;
        ng_out[c] = ngamma;
    }
    for (int i = lane; i < n; i += 32)
        y[(size_t)c * n + i] = mul(out[i], p.out_scale);
}

}  // namespace

// fparams: two_mu, gamma, den_mult, lidx_min, lidx_max, lincr, ldecr,
// out_scale (host memory)
extern "C" int t41x_xanr_block(
    const void* x, const void* hist, const void* w, const void* lidx,
    const void* ngamma, int channels, int n, int taps, int hd,
    const float* fparams, int notch, void* y, void* w_out, void* lidx_out,
    void* ng_out, void* stream)
{
    if (channels <= 0) return 0;
    if (taps != TAPS || hd < TAPS) return (int)cudaErrorInvalidValue;
    XanrP p;
    p.two_mu = fparams[0];
    p.gamma = fparams[1];
    p.den_mult = fparams[2];
    p.lidx_min = fparams[3];
    p.lidx_max = fparams[4];
    p.lincr = fparams[5];
    p.ldecr = fparams[6];
    p.out_scale = fparams[7];
    p.notch = notch;
    const size_t smem = (size_t)WARPS * (hd + 2 * n) * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            xanr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (channels + WARPS - 1) / WARPS;
    xanr_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)hist, (const float*)w,
        (const float*)lidx, (const float*)ngamma, channels, n, hd, p,
        (float*)y, (float*)w_out, (float*)lidx_out, (float*)ng_out);
    return (int)cudaGetLastError();
}
