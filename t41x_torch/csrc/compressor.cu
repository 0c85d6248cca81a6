// C1: the SSB exciter's mic compressor for a block: the level in dB, the
// attack/release envelope and the gain.
//
// Replaces no TPU kernel: t41x runs this stage as a lax.scan
// (t41x/chain/compressor.py:64, compress).  On the card its plain
// version, a torch loop over the samples, launches ~5 small ops a
// sample; this kernel does the block in one launch.
//
// What bounds it: not the bytes (x read, y written: 16.8 MB at 1024
// channels x 2048, ~5 us at 3.35 TB/s) but the recurrence, 2048
// dependent steps a channel.  Every operation is rounded on its own, in
// the plain version's order, with log10f and powf as torch calls them, so
// no step can fold into an FMA: the kernel matches t41x_torch.chain.
// compressor.compress_plain on the card bit for bit.  Both candidate
// envelopes (attack and release) are computed from the carried one, and a
// mask of the comparison selects them bitwise: a step's chain is FMUL ->
// FADD -> LOP3, with FSETP -> SEL (the mask) beside the products.  On the
// H100 that step takes ~22 cycles: a predicated FADD in place of the LOP3
// took ~23, a mask from the sign of env - ldb (FADD -> SHF) ~24.
//
// The design keeps that chain alone on the critical path, by warp role.
// A block holds CH channels:
//   - the envelope warp (warp 0) runs the recurrence, one lane a channel,
//     with the envelope in a register.  It reads the levels WIN at a time
//     as float4 into registers, the next window's loads issued before the
//     current window's steps, and writes the envelopes behind as float4:
//     no shared-memory load waits on the chain;
//   - CH worker warps, one a channel, 4 samples a lane, take the samples
//     in chunks of T through a ring of NS slots in shared memory.  For
//     chunk j they copy x with cp.async (issued one chunk ahead), compute
//     its levels into the slot, and then, LAG chunks behind, turn chunk
//     j - LAG's envelopes into gains and write y, reading x back from the
//     slot: x leaves device memory once.
//   - warps 4, 8, ... stay idle: warp i issues from the SM's scheduler
//     i % 4, so no worker shares the envelope warp's.
// The two roles meet at named barriers a slot, FULL (levels written;
// the workers arrive, the envelope warp waits) and ENV (envelopes
// written; the envelope warp arrives, the workers wait).  No block-wide
// barrier sits in the chunk loop: the envelope warp waits only when the
// workers fall behind, and the levels and gains run under the chain.
// A worker lane reads back only the x it copied itself, so cp.async's
// own wait covers it.  Rows of the envelope ring are padded to LD = T + 4
// floats, so the envelope warp's 8 float4 reads hit distinct banks.
//
// t41x_compress_phases is the same kernel with clock64 stamps: the
// envelope lane 0 sums its recurrence and its waits on the ring, worker
// lane 0 its levels (with its copy's wait), its gains and its waits; the
// envelope row is the measured time of the serial recurrence a block.

#include <cuda_runtime.h>

namespace {

constexpr int CH = 8;                  // channels a block
constexpr int T = 128;                 // samples a chunk: 4 a worker lane
constexpr int NS = 4;                  // ring slots
constexpr int LAG = 2;                 // chunks between levels and gains
constexpr int WIN = 16;                // envelope steps a register window
// the envelope warp, CH workers and the idle warps 4, 8, ... among them
constexpr int WARPS = 1 + CH + (CH - 1) / 3;
constexpr int THREADS = 32 * WARPS;    // launched
constexpr int ROLES = 32 * (1 + CH);   // at each named barrier
constexpr int LD = T + 4;              // padded envelope row
constexpr int BAR_FULL = 1;            // named barriers 1..NS
constexpr int BAR_ENV = 1 + NS;        // named barriers NS+1..2NS
static_assert(T == 4 * 32, "a worker lane takes 4 samples of a chunk");
static_assert(T % WIN == 0 && WIN % 4 == 0, "whole float4 windows");
// the copy of chunk j + 1 lands in the slot of chunk j + 1 - NS, whose
// gains were taken at j + 1 - NS + LAG: before iteration j
static_assert(LAG >= 1 && LAG <= NS - 2, "ring too short for the lag");
static_assert(BAR_ENV + NS <= 16, "16 hardware barriers a block");

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

// the two roles' named barriers: every thread of the two roles takes
// part in each, the envelope warp on one side and the workers on the other
__device__ __forceinline__ void named_bar_sync(int id)
{
    asm volatile("barrier.sync %0, %1;" :: "r"(id), "n"(ROLES) : "memory");
}

__device__ __forceinline__ void named_bar_arrive(int id)
{
    asm volatile("barrier.arrive %0, %1;" :: "r"(id), "n"(ROLES)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
}


__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// all but the newest group done: the chunk copied one iteration ago
__device__ __forceinline__ void cp_async_wait_prev()
{
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// one envelope step: ldb > env ? attack : release, each rounded alone,
// selected bitwise by the comparison's mask (lop3 0xE4: mask ? up :
// down); the asm keeps the compiler from folding the select into a
// predicated sum
__device__ __forceinline__ float env_step(const CompP& p, float env,
                                          float ldb)
{
    const float up = add(mul(p.a, env), mul(p.oma, ldb));
    const float down = add(mul(p.r, env), mul(p.omr, ldb));
    unsigned m, r;
    asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(m) : "f"(ldb), "f"(env));
    asm("lop3.b32 %0, %1, %2, %3, 0xE4;" : "=r"(r)
        : "r"(__float_as_uint(up)), "r"(__float_as_uint(down)), "r"(m));
    return __uint_as_float(r);
}

__device__ __forceinline__ float level_db(float v)
{
    return mul(20.f, log10f(fmaxf(fabsf(v), 1e-9f)));
}

__device__ __forceinline__ float gain_out(const CompP& p, float x, float e)
{
    const float over = fmaxf(__fsub_rn(e, p.thresh), 0.f);
    const float gain_db = add(mul(-over, p.slope), p.makeup);
    return mul(x, powf(10.f, __fdiv_rn(gain_db, 20.f)));
}

// The envelope over one chunk's row (len samples), in place: levels in,
// envelopes out.  A whole chunk runs WIN steps a window from registers.
__device__ __forceinline__ float envelope_row(const CompP& p, float* row,
                                              int len, float env)
{
    if (len < T) {   // the block's last, short chunk
        for (int t = 0; t < len; ++t) {
            env = env_step(p, env, row[t]);
            row[t] = env;
        }
        return env;
    }
    float4 cur[WIN / 4];
#pragma unroll
    for (int q = 0; q < WIN / 4; ++q)
        cur[q] = reinterpret_cast<const float4*>(row)[q];
#pragma unroll 1
    for (int t = 0; t < T; t += WIN) {
        float4 nxt[WIN / 4];
#pragma unroll
        for (int q = 0; q < WIN / 4; ++q)
            nxt[q] = cur[q];
        if (t + WIN < T) {
#pragma unroll
            for (int q = 0; q < WIN / 4; ++q)
                nxt[q] = reinterpret_cast<const float4*>(row + t + WIN)[q];
        }
#pragma unroll
        for (int q = 0; q < WIN / 4; ++q) {
            float4 o;
            o.x = env = env_step(p, env, cur[q].x);
            o.y = env = env_step(p, env, cur[q].y);
            o.z = env = env_step(p, env, cur[q].z);
            o.w = env = env_step(p, env, cur[q].w);
            reinterpret_cast<float4*>(row + t)[q] = o;
        }
#pragma unroll
        for (int q = 0; q < WIN / 4; ++q)
            cur[q] = nxt[q];
    }
    return env;
}

// STAMPS: the block's row of stamps (7 int64): the cycles of the levels,
// the envelope, the envelope warp's waits, the gains and the workers'
// waits, each summed over the chunks, then the block's total cycles and
// nanoseconds.  vec: x and y 16-byte aligned and n a multiple of 4.
template <bool STAMPS>
__global__ void __launch_bounds__(THREADS)
compress_kernel(const float* __restrict__ x,       // (C, n)
                const float* __restrict__ env_in,  // (C,)
                int channels, int n, int vec, CompP p,
                float* __restrict__ y,             // (C, n)
                float* __restrict__ env_out,       // (C,)
                long long* __restrict__ stamps)    // (blocks, 7) or null
{
    __shared__ __align__(16) float sx[NS][CH][T];   // x, a worker lane's own
    __shared__ __align__(16) float lev[NS][CH][LD]; // levels, then envelopes
    const int c0 = blockIdx.x * CH, tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int nch = (n + T - 1) / T;
    long long t_start = 0, ns0 = 0;
    if (STAMPS && tid == 0) {
        ns0 = ns_now();
        t_start = clock_now();
    }

    if (warp == 0) {
        // the envelope warp
        const bool live = lane < CH && c0 + lane < channels;
        float env = live ? env_in[c0 + lane] : 0.f;
        long long busy = 0, wait = 0;
        for (int k = 0; k < nch; ++k) {
            const int s = k % NS;
            const long long u0 = STAMPS ? clock_now() : 0;
            named_bar_sync(BAR_FULL + s);
            const long long u1 = STAMPS ? clock_now() : 0;
            if (live)
                env = envelope_row(p, &lev[s][lane][0], min(T, n - k * T),
                                   env);
            __syncwarp();
            if (STAMPS) {
                const long long u2 = clock_now();
                wait += u1 - u0;
                busy += u2 - u1;
            }
            named_bar_arrive(BAR_ENV + s);
        }
        if (live) env_out[c0 + lane] = env;
        if (STAMPS && tid == 0) {
            stamps[blockIdx.x * 7 + 1] = busy;
            stamps[blockIdx.x * 7 + 2] = wait;
        }
    } else if (warp % 4 != 0) {
        // worker warp w: channel c, samples 4 lane .. 4 lane + 3 a chunk
        const int w = warp - 1 - warp / 4, c = c0 + w, t4 = 4 * lane;
        const bool live = c < channels;
        const float* xr = x + (size_t)c * n;
        float* yr = y + (size_t)c * n;
        long long lev_c = 0, gain_c = 0, wait_c = 0;
        auto copy = [&](int k) {   // chunk k's x into its slot
            const int t0 = k * T, len = min(T, n - t0);
            float* d = &sx[k % NS][w][t4];
            if (!live || t4 >= len) return;
            if (vec) {
                cp_async16(d, xr + t0 + t4);
            } else {
                for (int e = 0; e < 4 && t4 + e < len; ++e)
                    cp_async4(d + e, xr + t0 + t4 + e);
            }
        };
        if (nch > 0) copy(0);
        cp_async_commit();
        for (int j = 0; j < nch + LAG; ++j) {
            if (j < nch) {
                const long long u0 = STAMPS ? clock_now() : 0;
                const int s = j % NS, len = min(T, n - j * T);
                if (j + 1 < nch) copy(j + 1);
                cp_async_commit();
                cp_async_wait_prev();
                if (live && t4 < len) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        &sx[s][w][t4]);
                    float4 l;
                    l.x = level_db(v.x);
                    l.y = level_db(v.y);
                    l.z = level_db(v.z);
                    l.w = level_db(v.w);
                    *reinterpret_cast<float4*>(&lev[s][w][t4]) = l;
                }
                if (STAMPS) lev_c += clock_now() - u0;
                named_bar_arrive(BAR_FULL + s);
            }
            if (j >= LAG) {
                const int k = j - LAG, s = k % NS, t0 = k * T;
                const int len = min(T, n - t0);
                const long long u0 = STAMPS ? clock_now() : 0;
                named_bar_sync(BAR_ENV + s);
                const long long u1 = STAMPS ? clock_now() : 0;
                if (live && t4 < len) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        &sx[s][w][t4]);
                    const float4 e = *reinterpret_cast<const float4*>(
                        &lev[s][w][t4]);
                    float4 o;
                    o.x = gain_out(p, v.x, e.x);
                    o.y = gain_out(p, v.y, e.y);
                    o.z = gain_out(p, v.z, e.z);
                    o.w = gain_out(p, v.w, e.w);
                    if (vec) {
                        *reinterpret_cast<float4*>(yr + t0 + t4) = o;
                    } else {
                        float* d = yr + t0 + t4;
                        d[0] = o.x;
                        if (t4 + 1 < len) d[1] = o.y;
                        if (t4 + 2 < len) d[2] = o.z;
                        if (t4 + 3 < len) d[3] = o.w;
                    }
                }
                if (STAMPS) {
                    wait_c += u1 - u0;
                    gain_c += clock_now() - u1;
                }
            }
        }
        if (STAMPS && tid == 32) {
            stamps[blockIdx.x * 7 + 0] = lev_c;
            stamps[blockIdx.x * 7 + 3] = gain_c;
            stamps[blockIdx.x * 7 + 4] = wait_c;
        }
    }
    if (STAMPS) {
        __syncthreads();
        if (tid == 0) {
            stamps[blockIdx.x * 7 + 5] = clock_now() - t_start;
            stamps[blockIdx.x * 7 + 6] = ns_now() - ns0;
        }
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
    const int vec = n % 4 == 0 && (size_t)x % 16 == 0 && (size_t)y % 16 == 0;
    const int blocks = (channels + CH - 1) / CH;
    compress_kernel<STAMPS><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)env_in, channels, n, vec, p,
        (float*)y, (float*)env_out, (long long*)stamps);
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

// t41x_compress with the phase split: stamps (blocks, 7) int64
extern "C" int t41x_compress_phases(const void* x, const void* env_in,
                                    int channels, int n,
                                    const float* fparams, void* y,
                                    void* env_out, void* stamps,
                                    void* stream)
{
    return compress<true>(x, env_in, channels, n, fparams, y, env_out,
                          stamps, stream);
}
