// C1: the SSB exciter's mic compressor for a block: the level in dB, the
// attack/release envelope and the gain.
//
// Replaces no TPU kernel: t41x runs this stage as a lax.scan
// (t41x/chain/compressor.py:64, compress).  On the card its plain
// version, a torch loop over the samples, launches ~5 small ops a
// sample; this kernel does the block in one launch.
//
// Layout: CH channels a thread block, the block's samples in chunks of T.
// For each chunk, (1) every thread computes levels, coalesced along the
// samples, into shared memory; (2) one thread a channel runs the
// envelope recurrence over the chunk, overwriting each level with the
// envelope (rows padded to T + 1 floats, so the CH serial lanes read
// distinct banks); (3) every thread turns envelopes into gains and
// writes the output, coalesced.  What bounds it: not the bytes (x read,
// y written: 16.8 MB at 1024 channels x 2048, ~5 us at 3.35 TB/s) but
// the recurrence, 2048 dependent steps a channel.  Both candidate
// envelopes (attack and release) are computed from the carried one and
// the comparison only selects, so a step's chain is a product, a sum
// and a select.  Every operation is rounded on its own, in the plain
// version's order, with log10f and powf as torch calls them: the kernel
// matches t41x_torch.chain.compressor.compress_plain on the card.
//
// t41x_compress_phases is the same kernel with clock64 stamps: thread 0
// sums each phase's cycles over the chunks, so the envelope phase is the
// measured time of the serial recurrence a block.

#include <cuda_runtime.h>

namespace {

constexpr int CH = 8;          // channels a block
constexpr int T = 256;         // samples a chunk
constexpr int THREADS = 256;
constexpr int LD = T + 1;      // padded row of the shared chunk

struct CompP {
    float a, r;          // attack and release coefficients
    float oma, omr;      // 1 - a, 1 - r
    float thresh, slope, makeup;  // knee, 1 - 1/ratio, makeup gain
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

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

// STAMPS: thread 0 writes the block's row of stamps (5 int64): the cycles
// of the levels, the envelope and the gain phases, summed over the
// chunks, then the block's total cycles and nanoseconds.
template <bool STAMPS>
__global__ void __launch_bounds__(THREADS)
compress_kernel(const float* __restrict__ x,       // (C, n)
                const float* __restrict__ env_in,  // (C,)
                int channels, int n, CompP p,
                float* __restrict__ y,             // (C, n)
                float* __restrict__ env_out,       // (C,)
                long long* __restrict__ stamps)    // (blocks, 5) or null
{
    __shared__ float s[CH * LD];
    __shared__ float carry[CH];
    const int c0 = blockIdx.x * CH, tid = threadIdx.x;
    const bool lane = tid < CH && c0 + tid < channels;
    long long clk[3] = {0, 0, 0}, t_start = 0, ns0 = 0, t_mark = 0;
    if (STAMPS && tid == 0) {
        ns0 = ns_now();
        t_start = t_mark = clock_now();
    }
    auto stamp = [&](int k) {
        if (STAMPS && tid == 0) {
            const long long u = clock_now();
            clk[k] += u - t_mark;
            t_mark = u;
        }
    };
    if (lane) carry[tid] = env_in[c0 + tid];

    for (int t0 = 0; t0 < n; t0 += T) {
        const int len = min(T, n - t0);
        // 1. the level in dB
        for (int i = tid; i < CH * T; i += THREADS) {
            const int c = i / T, t = i % T;
            if (t < len && c0 + c < channels) {
                const float v = x[(size_t)(c0 + c) * n + t0 + t];
                s[c * LD + t] = mul(20.f, log10f(fmaxf(fabsf(v), 1e-9f)));
            }
        }
        __syncthreads();
        stamp(0);
        // 2. the envelope, one thread a channel
        if (lane) {
            float env = carry[tid];
            float* row = s + tid * LD;
            for (int t = 0; t < len; ++t) {
                const float ldb = row[t];
                const float up = add(mul(p.a, env), mul(p.oma, ldb));
                const float down = add(mul(p.r, env), mul(p.omr, ldb));
                env = ldb > env ? up : down;
                row[t] = env;
            }
            carry[tid] = env;
        }
        __syncthreads();
        stamp(1);
        // 3. the gain and the output
        for (int i = tid; i < CH * T; i += THREADS) {
            const int c = i / T, t = i % T;
            if (t < len && c0 + c < channels) {
                const size_t k = (size_t)(c0 + c) * n + t0 + t;
                const float over = fmaxf(__fsub_rn(s[c * LD + t], p.thresh), 0.f);
                const float gain_db = add(mul(-over, p.slope), p.makeup);
                y[k] = mul(x[k], powf(10.f, __fdiv_rn(gain_db, 20.f)));
            }
        }
        __syncthreads();
        stamp(2);
    }
    if (lane) env_out[c0 + tid] = carry[tid];
    if (STAMPS && tid == 0) {
        long long* o = stamps + blockIdx.x * 5;
        for (int k = 0; k < 3; ++k) o[k] = clk[k];
        o[3] = clock_now() - t_start;
        o[4] = ns_now() - ns0;
    }
}

template <bool STAMPS>
int compress(const void* x, const void* env_in, int channels, int n,
             const float* fparams, void* y, void* env_out, void* stamps,
             void* stream)
{
    if (channels <= 0) return 0;
    CompP p;
    p.a = fparams[0];
    p.r = fparams[1];
    p.oma = fparams[2];
    p.omr = fparams[3];
    p.thresh = fparams[4];
    p.slope = fparams[5];
    p.makeup = fparams[6];
    const int blocks = (channels + CH - 1) / CH;
    compress_kernel<STAMPS><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)env_in, channels, n, p, (float*)y,
        (float*)env_out, (long long*)stamps);
    return (int)cudaGetLastError();
}

}  // namespace

// fparams: a, r, 1 - a, 1 - r, knee, 1 - 1/ratio, makeup (host memory)
extern "C" int t41x_compress(const void* x, const void* env_in, int channels,
                             int n, const float* fparams, void* y,
                             void* env_out, void* stream)
{
    return compress<false>(x, env_in, channels, n, fparams, y, env_out,
                           nullptr, stream);
}

// t41x_compress with the phase split: stamps (blocks, 5) int64
extern "C" int t41x_compress_phases(const void* x, const void* env_in,
                                    int channels, int n,
                                    const float* fparams, void* y,
                                    void* env_out, void* stamps,
                                    void* stream)
{
    return compress<true>(x, env_in, channels, n, fparams, y, env_out,
                          stamps, stream);
}
