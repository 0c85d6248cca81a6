// K7: the variable-leak LMS (WDSP Xanr) over one block.
//
// Replaces the TPU kernel t41x/kernels/xanr_pallas.py, _kernel
// (xanr_block_pallas): per audio sample, the 64-tap prediction over the
// delayed regressor window, the error, the leak-index update (with the
// reference's lidx quirk, Noise.cpp:353-358), the leak factor and the
// weight update.  Output: the prediction times post_gain (NR mode 3) or
// the error (the automatic notch).
//
// What bounds it on the card is not its bytes or operations (~1 us) but
// the chain from one step's weights to the next one's: the prediction's
// reduction over 64 taps, the error, the leak decision and the weight
// update, per sample and channel, whatever the channel count.  So the
// design keeps everything else off that chain:
//
// * The regressor energy sigma, inv_sigp = 1 / (sigma + 1e-10) and nel's
//   factor 1 - (two_mu sigma) inv_sigp depend on the input alone: a warp
//   per channel forms them for every step before the loop, and the loop
//   reads them from shared memory.
// * The leak index takes one of two values a step, both known before the
//   error is: both candidate leak factors are formed off the chain and
//   the decision only selects.
// * The prediction: LANES lanes a channel, 64 / LANES taps a lane (tap k
//   on lane k % LANES), a halving tree in each lane, then a
//   log2(LANES)-level xor butterfly; the next step's regressor window is
//   loaded while this step runs.
// * Staging and store: a warp per channel, 16-byte loads, 8 channels a
//   block (1024 channels fill 128 of the H100's 132 SMs).  The kernel
//   reads the newest-first delay line and weights as t41x stores them and
//   writes them newest-first itself, so the wrapper runs no torch op.
//
// On an H100 at 1024 channels the loop still takes most of the time:
// ~29 of ~35 us, ~223 cycles a step of 92 instructions on one warp a
// scheduler (a warp per channel with two 5-level butterflies a step took
// ~52 us, 380 cycles a step).  Against 8 lanes a channel, 16 measured
// within 3%, 32 and 4 ~11% slower.
//
// Every sum is taken in torch.sum's order on the card (a 32-lane
// reduction over taps (l, l + 32), then halving: the lane tree and the
// butterfly above are that tree, and sigma's pass forms it alike) and
// every product in the plain version's order, each rounded alone, so the
// kernel equals its plain version on the card bit for bit.  Layout: each
// channel's oldest-first [history | block] regressor buffer in shared
// memory, at a pitch that puts a warp's channels on distinct banks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TAPS = 64;
constexpr int LANES = 8;                // lanes a channel
constexpr int TPL = TAPS / LANES;       // taps a lane
constexpr int CB = 8;                   // channels per thread block
constexpr int THREADS = 32 * CB;        // a warp per channel for staging
constexpr int LOOP_THREADS = LANES * CB;
constexpr int R = 4;                    // 16-byte loads a lane keeps in flight
constexpr unsigned FULL = 0xffffffffu;

struct XanrP {
    float two_mu, gamma, den_mult, lidx_min, lidx_max, lincr, ldecr,
        out_scale;
    int notch;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ long long clock_now()
{
    long long t;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");
    return t;
}

__device__ __forceinline__ long long ns_now()
{
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");
    return t;
}

// ngamma for a leak index
__device__ __forceinline__ float leak(const XanrP& p, float lidx)
{
    const float l2 = mul(lidx, lidx);
    return mul(mul(p.gamma, mul(l2, l2)), p.den_mult);
}

// One channel's shared memory: the [history | block] regressor buffer
// pad (hd + n); its squares (hd + n), whose place the outputs (n) take in
// the loop; then per step, 16-byte aligned, what the loop reads besides
// the window: x, sigma, inv_sigp and nel's factor (one float4).  The
// pitch is LANES more than a multiple of 32 floats, so the loop's LANES
// lanes of 32 / LANES channels read distinct banks.
struct Tile {
    float *pad, *out;
    float4* step;
    __device__ Tile(float* base, int hd, int n)
        : pad(base), out(base + hd + n),
          step(reinterpret_cast<float4*>(base + steps_at(hd, n))) {}
    __host__ __device__ static int steps_at(int hd, int n)
    {
        return (2 * (hd + n) + 3) / 4 * 4;
    }
    __host__ __device__ static int pitch(int hd, int n)
    {
        return (steps_at(hd, n) + 4 * n - LANES + 31) / 32 * 32 + LANES;
    }
};

// STAMPS: thread 0 writes the block's clock64 cycles per phase (staging,
// input-only factors, loop, store), its total cycles and its nanoseconds
// to stamps[block * 6 ..].
template <bool STAMPS>
__global__ void __launch_bounds__(THREADS)
xanr_kernel(const float* __restrict__ x,      // (C, n)
            const float* __restrict__ dline,  // (C, hd) newest-first
            const float* __restrict__ w_in,   // (C, TAPS) newest-first
            const float* __restrict__ lidx_in, const float* __restrict__ ng_in,
            int channels, int n, int hd, XanrP p,
            float* __restrict__ y,            // (C, n)
            float* __restrict__ dline_out,    // (C, hd) newest-first
            float* __restrict__ w_out,        // (C, TAPS) newest-first
            float* __restrict__ lidx_out, float* __restrict__ ng_out,
            long long* __restrict__ stamps)
{
    extern __shared__ float sm[];
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int c0 = blockIdx.x * CB;
    const int nc = min(CB, channels - c0);  // ragged last block: mask
    const int L = hd + n, pitch = Tile::pitch(hd, n);
    long long clk[5], ns0 = 0;
    if (STAMPS && tid == 0) {
        clk[0] = clock_now();
        ns0 = ns_now();
    }

    // the loop lanes' weights (oldest-first tap k = j + LANES m on lane j
    // of channel cl) and states, loaded first.  Lanes of a channel past
    // the ragged edge run the loop on the last channel and write nothing,
    // so that every lane of a loop warp takes part in its shuffles.
    const int j = tid % LANES;
    const int cl = min(tid / LANES, nc - 1);
    const bool owner = tid / LANES < nc;
    float wt[TPL];
    float lidx = 0.f, ngamma = 0.f;
    if (tid < LOOP_THREADS) {
        const size_t c = c0 + cl;
#pragma unroll
        for (int m = 0; m < TPL; ++m)
            wt[m] = w_in[c * TAPS + (TAPS - 1 - (j + LANES * m))];
        lidx = lidx_in[c];
        ngamma = ng_in[c];
    }

    // (a) staging, a warp per channel: pad = [dline reversed | x], and
    // its squares into sq (the outputs' place)
    if (w < nc) {
        const size_t c = c0 + w;
        const Tile tl(sm + w * pitch, hd, n);
        float* sq = tl.out;
        const bool vec = n % 4 == 0 && hd % 4 == 0
            && (uintptr_t)(x + c * n) % 16 == 0
            && (uintptr_t)(dline + c * hd) % 16 == 0;
        if (vec) {
            const int gh = hd / 4, g_all = L / 4;
            for (int g0 = lane; g0 < g_all; g0 += 32 * R) {
                float4 v[R];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int g = g0 + 32 * r;
                    if (g < gh)
                        v[r] = reinterpret_cast<const float4*>(
                            dline + c * hd)[g];
                    else if (g < g_all)
                        v[r] = reinterpret_cast<const float4*>(
                            x + c * n)[g - gh];
                }
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int g = g0 + 32 * r;
                    if (g >= g_all) continue;
                    const float e[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        // dline[i] is pad[hd - 1 - i]
                        const int i = g < gh ? hd - 1 - (4 * g + k)
                                             : 4 * g + k;
                        tl.pad[i] = e[k];
                        sq[i] = mul(e[k], e[k]);
                    }
                }
            }
        } else {
            for (int i = lane; i < L; i += 32) {
                const float e = i < hd ? dline[c * hd + (hd - 1 - i)]
                                       : x[c * n + (i - hd)];
                tl.pad[i] = e;
                sq[i] = mul(e, e);
            }
        }
    }
    __syncthreads();
    if (STAMPS && tid == 0) clk[1] = clock_now();

    // (b) the input-only factors, a warp per channel, a lane per step:
    // sigma over the window pad[t+1 .. t+64] as torch.sum reduces it
    // (pairs (l, l + 32), then halving), inv_sigp, nel's factor
    if (w < nc) {
        const Tile tl(sm + w * pitch, hd, n);
        for (int t = lane; t < n; t += 32) {
            const float* s = tl.out + t + 1;  // the squares
            float v[32];
#pragma unroll
            for (int l = 0; l < 32; ++l) v[l] = add(s[l], s[l + 32]);
#pragma unroll
            for (int lv = 4; lv >= 0; --lv) {  // halving: 16, 8, 4, 2, 1
#pragma unroll
                for (int l = 0; l < 16; ++l)
                    if (l < (1 << lv)) v[l] = add(v[l], v[l + (1 << lv)]);
            }
            const float inv_sigp = __fdiv_rn(1.f, add(v[0], 1e-10f));
            tl.step[t] = make_float4(
                tl.pad[hd + t], v[0], inv_sigp,
                sub(1.f, mul(mul(p.two_mu, v[0]), inv_sigp)));
        }
    }
    __syncthreads();
    if (STAMPS && tid == 0) clk[2] = clock_now();

    // (c) the recurrence, LANES lanes a channel
    if (tid < LOOP_THREADS) {
        const Tile tl(sm + cl * pitch, hd, n);
        const float* reg = tl.pad + 1 + j;  // step t's tap j + LANES m
        float c0p = sub(1.f, mul(p.two_mu, ngamma));  // the last step's
        // ngamma and the leak factor if lidx holds, carried from step to
        // step (ngamma_in need not be leak(lidx_in); every later one is)
        float ng_keep = leak(p, lidx);
        float c0_keep = sub(1.f, mul(p.two_mu, ng_keep));
        float r[TPL];
#pragma unroll
        for (int m = 0; m < TPL; ++m) r[m] = reg[LANES * m];
#pragma unroll 2
        for (int t = 0; t < n; ++t) {
            float rn[TPL];  // the next step's window, loaded ahead (the
#pragma unroll              // last step's read stays inside the tile)
            for (int m = 0; m < TPL; ++m) rn[m] = reg[t + 1 + LANES * m];
            // the leak index and its factor if it steps
            const float lidx_new = add(lidx, p.lincr) > p.lidx_max
                ? p.lidx_max : fmaxf(sub(add(lidx, p.lincr), p.ldecr),
                                     p.lidx_min);
            const float ng_new = leak(p, lidx_new);
            const float c0_new = sub(1.f, mul(p.two_mu, ng_new));
            const float4 f = tl.step[t];
            const float xn = f.x, sigma = f.y, inv_sigp = f.z, nelf = f.w;

            float acc[TPL];
#pragma unroll
            for (int m = 0; m < TPL; ++m) acc[m] = mul(wt[m], r[m]);
#pragma unroll
            for (int h = TPL / 2; h > 0; h /= 2) {
#pragma unroll
                for (int m = 0; m < TPL / 2; ++m)
                    if (m < h) acc[m] = add(acc[m], acc[m + h]);
            }
            float yp = acc[0];
#pragma unroll
            for (int o = LANES / 2; o > 0; o >>= 1)
                yp = add(yp, __shfl_xor_sync(FULL, yp, o, LANES));
            const float error = sub(xn, yp);
            if (owner && j == 0) tl.out[t] = p.notch ? error : yp;

            const float mue = mul(p.two_mu, error);
            const float nel = fabsf(mul(error, nelf));
            const float nev = fabsf(sub(sub(xn, mul(c0p, yp)),
                                        mul(mul(mue, sigma), inv_sigp)));
            const bool step = nev < nel;
            lidx = step ? lidx_new : lidx;
            ngamma = ng_keep = step ? ng_new : ng_keep;
            const float c0 = c0_keep = step ? c0_new : c0_keep;
            const float c1 = mul(mue, inv_sigp);
#pragma unroll
            for (int m = 0; m < TPL; ++m) {
                wt[m] = add(mul(c0, wt[m]), mul(c1, r[m]));
                r[m] = rn[m];
            }
            c0p = c0;
        }
        if (owner) {
            const size_t c = c0 + cl;
#pragma unroll
            for (int m = 0; m < TPL; ++m)
                w_out[c * TAPS + (TAPS - 1 - (j + LANES * m))] = wt[m];
            if (j == 0) {
                lidx_out[c] = lidx;
                ng_out[c] = ngamma;
            }
        }
    }
    __syncthreads();
    if (STAMPS && tid == 0) clk[3] = clock_now();

    // (d) store, a warp per channel: y, and the new delay line newest
    // first, dline_out[i] = pad[L - 1 - i]
    if (w < nc) {
        const size_t c = c0 + w;
        const Tile tl(sm + w * pitch, hd, n);
        for (int i = lane; i < n; i += 32)
            y[c * n + i] = mul(tl.out[i], p.out_scale);
        for (int i = lane; i < hd; i += 32)
            dline_out[c * hd + i] = tl.pad[L - 1 - i];
    }
    if (STAMPS) {
        __syncthreads();
        if (tid == 0) {
            clk[4] = clock_now();
            long long* o = stamps + blockIdx.x * 6;
            for (int k = 0; k < 4; ++k) o[k] = clk[k + 1] - clk[k];
            o[4] = clk[4] - clk[0];
            o[5] = ns_now() - ns0;
        }
    }
}

template <bool STAMPS>
int xanr_block(const void* x, const void* dline, const void* w,
               const void* lidx, const void* ngamma, int channels, int n,
               int taps, int hd, const float* fparams, int notch, void* y,
               void* dline_out, void* w_out, void* lidx_out, void* ng_out,
               void* stamps, void* stream)
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
    const size_t smem = (size_t)CB * Tile::pitch(hd, n) * sizeof(float);
    auto kernel = xanr_kernel<STAMPS>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (channels + CB - 1) / CB;
    kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)dline, (const float*)w,
        (const float*)lidx, (const float*)ngamma, channels, n, hd, p,
        (float*)y, (float*)dline_out, (float*)w_out, (float*)lidx_out,
        (float*)ng_out, (long long*)stamps);
    return (int)cudaGetLastError();
}

}  // namespace

// dline and w newest-first, as t41x stores them; fparams: two_mu, gamma,
// den_mult, lidx_min, lidx_max, lincr, ldecr, out_scale (host memory)
extern "C" int t41x_xanr_block(
    const void* x, const void* dline, const void* w, const void* lidx,
    const void* ngamma, int channels, int n, int taps, int hd,
    const float* fparams, int notch, void* y, void* dline_out, void* w_out,
    void* lidx_out, void* ng_out, void* stream)
{
    return xanr_block<false>(x, dline, w, lidx, ngamma, channels, n, taps,
                             hd, fparams, notch, y, dline_out, w_out,
                             lidx_out, ng_out, nullptr, stream);
}

// t41x_xanr_block with the phase split: stamps (blocks, 6) int64
extern "C" int t41x_xanr_block_phases(
    const void* x, const void* dline, const void* w, const void* lidx,
    const void* ngamma, int channels, int n, int taps, int hd,
    const float* fparams, int notch, void* y, void* dline_out, void* w_out,
    void* lidx_out, void* ng_out, void* stamps, void* stream)
{
    return xanr_block<true>(x, dline, w, lidx, ngamma, channels, n, taps,
                            hd, fparams, notch, y, dline_out, w_out,
                            lidx_out, ng_out, stamps, stream);
}
