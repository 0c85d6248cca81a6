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
// G_b^T x + AK_b s_b.  The signed gains g_b fold in first: the
// channel's band sum is sum_b g_b y_b = (sum_b g_b h_b) * x
// + sum_{b,m} R_b[:, m] (g_b s_b[m]), one 32-tap response he a channel
// instead of 14, and the band tensor never reaches device memory.
//
// What bounds it on the card: the operations, ~39 k FMAs a 256-sample
// block and channel in this form (about what the per-sample biquads
// would need); its bytes, the block in and out, take less.  In this
// form each lane's own rows of R, G and he are read from shared memory
// (a 16-byte read feeds one chunk's sums of each of the warp's chunks),
// so the shared-memory pipe, not the FMA rate, sets the floor of (a) and
// (c) below.  Only the state recursion is serial, a 4 x 4 product a band
// and chunk, so each pass of up to SEG chunks runs in three steps
// between barriers:
//   (a) u_q = G^T x_q for every chunk q at once: a lane two states, a
//       register sum a chunk, four samples of the input (a broadcast
//       16-byte read) against four of each state's G row a step;
//   (b) the scan s_{q+1} = AK s_q + u_q: a lane a band, its band's AK,
//       four states and the pass's eight u in registers, each row two
//       chains of two FMAs; it leaves g_b s_q in place of u_q.  On the
//       first pass the group's second warp builds he meanwhile;
//   (c) y_q = he * x_q + R (g s_q) for every chunk at once: a lane an
//       output sample, a register sum a chunk; four taps of he a step
//       from four shifted copies of the zero-padded response (so each
//       lane's read is one aligned 16-byte vector) and four of its R row.
// The chunks of a pass are split over the W warps of a channel's group:
// W = W_MANY above FEW channels (4 channels a block of 8 warps, 2 blocks
// an SM: a warp's 4 chunks share each operand read), W = 8 at up to FEW
// (a channel a block, a warp a chunk, partial sums for more independent
// chains), where one channel's dependent chains bound, as at one channel
// (Radio.transmit_ssb); only (b) walks the chunks in turn.  The prologue
// puts R, G, h, the signs and the block's gains in shared memory with
// every load in flight at once (loaded where the response's FMA chain
// uses them, its 42 loads go out a few at a time, one round trip to
// memory each).  Full fp32 FMAs only, no tensor cores; the sums run in
// another order than the plain version's cuBLAS products.
//
// t41x_eq_phases is the same kernel with clock64 stamps: thread 0
// writes its block's row of N_PHASES phase cycles (the prologue: the
// constants and the first pass's input; then summed over the passes
// (a), (b) with he, (c); the later passes' input staging with the
// state's store), then the block's total cycles and nanoseconds.

#include <cuda_runtime.h>

namespace {

constexpr int BANDS = 14;
constexpr int K = 32;              // samples a chunk
constexpr int NS = 56;             // states: 14 bands x 2 stages x 2
constexpr int SPB = NS / BANDS;    // states a band
constexpr int WARPS = 8;           // a block
constexpr int SEG = 8;             // chunks a pass
constexpr int FEW = 132;           // channels up to which a channel takes a block
constexpr int W_MANY = 2;          // warps a channel above FEW
constexpr int N_PHASES = 5;        // stamped phases a block
// offsets of kernel_consts' parts: h (14, K), R (K, 56), G (56, K),
// AK (56, 4), signs (14,)
constexpr int OFF_H = 0;
constexpr int OFF_R = OFF_H + BANDS * K;
constexpr int OFF_G = OFF_R + K * NS;
constexpr int OFF_AK = OFF_G + NS * K;
constexpr int OFF_SIGN = OFF_AK + NS * SPB;
constexpr int N_CONSTS = OFF_SIGN + BANDS;
// shared memory, in floats: R and G with padded rows (so that 8 lanes'
// 16-byte reads of 8 rows fall in distinct banks), h, the signs and
// the block's gains; a channel's pass input xs[q][j]; u, then g s in
// its place, ug[q][m]; four shifted copies of [32 zeros | he] (copy r at
// i holds element i + r)
constexpr int R_ROW = NS + 4;
constexpr int G_ROW = K + 4;
constexpr int HZ = 2 * K;
constexpr int HR_COPY = HZ + 8;
constexpr int S_R = 0;
constexpr int S_G = S_R + K * R_ROW;
constexpr int S_H = S_G + NS * G_ROW;       // h (14, K)
constexpr int S_SIGN = S_H + BANDS * K;     // signs, padded to 16
constexpr int CH_FLOATS = SEG * K + SEG * NS + 4 * HR_COPY;
constexpr int X_OFF = 0, UG_OFF = SEG * K, HR_OFF = SEG * K + SEG * NS;

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

// with STAMPS, ph[i] gets the cycles since `last`, and `last` moves on
template <bool STAMPS>
__device__ __forceinline__ void mark(long long (&ph)[N_PHASES], int i,
                                     long long& last)
{
    if (STAMPS) {
        const long long u = clock_now();
        ph[i] += u - last;
        last = u;
    }
}

__device__ __forceinline__ float4 ld4(const float* p)
{
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 lds4(const float* p)
{
    return *reinterpret_cast<const float4*>(p);
}

// the P partial sums of a 4-term dot product: acc[0] alone (P = 1) or a
// term each (P = 4), so that a warp of one chunk still has independent
// FMA chains
template <int P>
__device__ __forceinline__ void dot4p(float (&acc)[P], float4 a, float4 b)
{
    static_assert(P == 1 || P == 4, "one sum or four");
    if (P == 1) {
        acc[0] = fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, acc[0]))));
    } else {
        acc[0] = fmaf(a.x, b.x, acc[0]);
        acc[1 % P] = fmaf(a.y, b.y, acc[1 % P]);
        acc[2 % P] = fmaf(a.z, b.z, acc[2 % P]);
        acc[3 % P] = fmaf(a.w, b.w, acc[3 % P]);
    }
}

template <int P>
__device__ __forceinline__ float total(const float (&acc)[P])
{
    if (P == 1) return acc[0];
    return (acc[0] + acc[1 % P]) + (acc[2 % P] + acc[3 % P]);
}

template <int W, bool STAMPS>
__global__ void __launch_bounds__(WARPS * 32)
eq_kernel(const float* __restrict__ x,        // (C, n)
          const float* __restrict__ state_in, // (C, 56)
          const float* __restrict__ gains,    // (C, 14)
          const float* __restrict__ ops,      // kernel_consts
          int channels, int n_chunks,
          float* __restrict__ y,              // (C, n)
          float* __restrict__ state_out,      // (C, 56)
          long long* __restrict__ stamps)     // (blocks, N_PHASES + 2)
{
    static_assert(W >= 2, "a group's second warp builds he during the scan");
    constexpr int CH = WARPS / W;       // channels a block
    constexpr int NQ = SEG / W;         // chunks a warp and pass
    constexpr int P = NQ == 1 ? 4 : 1;  // partial sums a chunk
    constexpr int XF = SEG * K / 4;              // a pass's input float4s
    constexpr int X4 = (XF + 32 * W - 1) / (32 * W);   // ... a thread
    constexpr int S_GAIN = S_SIGN + 16;          // (CH, 16): a channel's gains
    constexpr int S_CHS = S_GAIN + 16 * CH;
    __shared__ __align__(16) float sm[S_CHS + CH * CH_FLOATS];
    long long ph[N_PHASES] = {}, ns0 = 0, c0c = 0, last = 0;
    if (STAMPS) {
        ns0 = ns_now();
        last = c0c = clock_now();
    }
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int cb = warp / W, sub = warp % W, gt = sub * 32 + lane;
    const int c0 = blockIdx.x * CH, c = c0 + cb;
    const bool live = c < channels;      // the whole group
    const int n = n_chunks * K;
    float* const chs = sm + S_CHS + cb * CH_FLOATS;
    float* const xs = chs + X_OFF;
    float* const ug = chs + UG_OFF;
    float* const hr = chs + HR_OFF;
    const int n_seg = (n_chunks + SEG - 1) / SEG;

    // every load of the prologue in flight at once: the first pass's
    // input; R, G, h and the signs; the block's gains; the scan lanes'
    // AK rows and states
    float4 xr[X4];
#pragma unroll
    for (int i = 0; i < X4; ++i) {
        const int f = gt + i * 32 * W, q = f / (K / 4);
        xr[i] = live && f < XF && q < n_chunks ? ld4(x + (size_t)c * n + 4 * f)
                                               : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    constexpr int RGH4 = (2 * K * NS + BANDS * K) / 4;
    constexpr int RGH_IT = (RGH4 + WARPS * 32 - 1) / (WARPS * 32);
    float4 rg[RGH_IT];
#pragma unroll
    for (int i = 0; i < RGH_IT; ++i) {
        const int f = tid + i * WARPS * 32;
        if (f < RGH4) rg[i] = ld4(ops + OFF_H + 4 * f);   // h, R, G in turn
    }
    float sg = 0.f;
    if (tid < BANDS) sg = __ldg(ops + OFF_SIGN + tid);
    const int gc = tid / BANDS, gb = tid - gc * BANDS;
    float gn = 0.f;
    if (gc < CH && c0 + gc < channels) gn = __ldg(gains + (size_t)(c0 + gc) * BANDS + gb);
    const bool scanning = live && sub == 0 && lane < BANDS;
    float ak[SPB][SPB], s[SPB];
    if (scanning) {
#pragma unroll
        for (int i = 0; i < SPB; ++i) {
            const float4 v = ld4(ops + OFF_AK + (lane * SPB + i) * SPB);
            ak[i][0] = v.x; ak[i][1] = v.y; ak[i][2] = v.z; ak[i][3] = v.w;
        }
        const float4 v = ld4(state_in + (size_t)c * NS + lane * SPB);
        s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
    }

    // into shared memory: h, R and G in their padded rows, the signs,
    // the gains, the first pass's input
#pragma unroll
    for (int i = 0; i < RGH_IT; ++i) {
        const int f = tid + i * WARPS * 32;
        float* dst = nullptr;
        if (f < BANDS * K / 4) {
            dst = sm + S_H + 4 * f;
        } else if (f < (BANDS * K + K * NS) / 4) {
            const int g = f - BANDS * K / 4;
            dst = sm + S_R + (g / (NS / 4)) * R_ROW + 4 * (g % (NS / 4));
        } else if (f < RGH4) {
            const int g = f - (BANDS * K + K * NS) / 4;
            dst = sm + S_G + (g / (K / 4)) * G_ROW + 4 * (g % (K / 4));
        }
        if (dst != nullptr) *reinterpret_cast<float4*>(dst) = rg[i];
    }
    if (tid < BANDS) sm[S_SIGN + tid] = sg;
    if (gc < CH) sm[S_GAIN + 16 * gc + gb] = gn;
#pragma unroll
    for (int i = 0; i < X4; ++i)
        if (gt + i * 32 * W < XF)
            *reinterpret_cast<float4*>(xs + 4 * (gt + i * 32 * W)) = xr[i];
    if (n_seg > 1) {
#pragma unroll
        for (int i = 0; i < X4; ++i) {
            const int f = gt + i * 32 * W, q = SEG + f / (K / 4);
            xr[i] = live && f < XF && q < n_chunks
                ? ld4(x + (size_t)c * n + SEG * K + 4 * f)
                : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
    __syncthreads();

    // the scan lanes' signed gains
    const float* const g_c = sm + S_GAIN + 16 * cb;
    const float scale = scanning ? __fmul_rn(sm[S_SIGN + lane], g_c[lane]) : 0.f;
    mark<STAMPS>(ph, 0, last);

    // the warp's chunks of a pass: sub + W i; its states in (a): lane
    // and lane + 32; its copy of he in (c)
    const int m0 = lane, m1 = lane + 32;
    const bool has1 = m1 < NS;
    const int m1c = has1 ? m1 : m0;
    const int rk = (lane + 1) & 3;
    const float* const hk = hr + rk * HR_COPY + K + lane - 3 - rk;
    for (int seg = 0; seg < n_seg; ++seg) {
        const int nq = min(SEG, n_chunks - seg * SEG);
        if (seg > 0) {
#pragma unroll
            for (int i = 0; i < X4; ++i)
                if (gt + i * 32 * W < XF)
                    *reinterpret_cast<float4*>(xs + 4 * (gt + i * 32 * W)) = xr[i];
            if (seg + 1 < n_seg) {
#pragma unroll
                for (int i = 0; i < X4; ++i) {
                    const int f = gt + i * 32 * W, q = (seg + 1) * SEG + f / (K / 4);
                    xr[i] = live && f < XF && q < n_chunks
                        ? ld4(x + (size_t)c * n + (size_t)(seg + 1) * SEG * K + 4 * f)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
                }
            }
            __syncthreads();
            mark<STAMPS>(ph, 4, last);
        }

        // (a) u_q = G^T x_q, states m0 and m1 of the warp's chunks
        if (live) {
            float a0[NQ][P], a1[NQ][P];
#pragma unroll
            for (int i = 0; i < NQ; ++i)
#pragma unroll
                for (int t = 0; t < P; ++t) a0[i][t] = a1[i][t] = 0.f;
#pragma unroll
            for (int j4 = 0; j4 < K / 4; ++j4) {
                const float4 g0 = lds4(sm + S_G + m0 * G_ROW + 4 * j4);
                const float4 g1 = lds4(sm + S_G + m1c * G_ROW + 4 * j4);
#pragma unroll
                for (int i = 0; i < NQ; ++i) {
                    const float4 xv = lds4(xs + (sub + W * i) * K + 4 * j4);
                    dot4p(a0[i], g0, xv);
                    dot4p(a1[i], g1, xv);
                }
            }
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
                ug[(sub + W * i) * NS + m0] = total(a0[i]);
                if (has1) ug[(sub + W * i) * NS + m1] = total(a1[i]);
            }
        }
        __syncthreads();
        mark<STAMPS>(ph, 1, last);

        // (b) the scan over the pass's chunks, g s_q in place of u_q;
        // meanwhile, on the first pass, the group's second warp builds
        // the channel's effective response he = sum_b sign_b gain_b h_b
        // at k = lane into its four shifted copies, for (c)
        if (seg == 0 && sub == 1) {
            float he = 0.f;
#pragma unroll
            for (int b = 0; b < BANDS; ++b)
                he = fmaf(__fmul_rn(sm[S_SIGN + b], g_c[b]), sm[S_H + b * K + lane], he);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                hr[r * HR_COPY + (lane < K - r ? lane : K + lane)] = 0.f;
                hr[r * HR_COPY + K + lane - r] = he;
            }
        }
        if (scanning) {
            float4 v[SEG];
#pragma unroll
            for (int q = 0; q < SEG; ++q) v[q] = lds4(ug + q * NS + lane * SPB);
#pragma unroll
            for (int q = 0; q < SEG; ++q) {
                if (q < nq) {
                    *reinterpret_cast<float4*>(ug + q * NS + lane * SPB) = make_float4(
                        __fmul_rn(scale, s[0]), __fmul_rn(scale, s[1]),
                        __fmul_rn(scale, s[2]), __fmul_rn(scale, s[3]));
                    // s' = u + AK s, each row as two chains of two
                    const float u[SPB] = {v[q].x, v[q].y, v[q].z, v[q].w};
                    float t[SPB];
#pragma unroll
                    for (int i = 0; i < SPB; ++i)
                        t[i] = fmaf(ak[i][1], s[1], fmaf(ak[i][0], s[0], u[i]))
                               + fmaf(ak[i][3], s[3], ak[i][2] * s[2]);
#pragma unroll
                    for (int i = 0; i < SPB; ++i) s[i] = t[i];
                }
            }
        }
        __syncthreads();
        mark<STAMPS>(ph, 2, last);

        // (c) y_q = he * x_q + R (g s_q), sample `lane` of the warp's
        // chunks: taps j = 4 j4 .. 4 j4 + 3 are he[lane - j], the copy
        // at K + lane - 3 - 4 j4 read as (he[lane-j-3], ..., he[lane-j])
        if (live) {
            float acc[NQ][P];
#pragma unroll
            for (int i = 0; i < NQ; ++i)
#pragma unroll
                for (int t = 0; t < P; ++t) acc[i][t] = 0.f;
#pragma unroll
            for (int j4 = 0; j4 < K / 4; ++j4) {
                const float4 h = lds4(hk - 4 * j4);
                const float4 hrev = make_float4(h.w, h.z, h.y, h.x);
#pragma unroll
                for (int i = 0; i < NQ; ++i)
                    dot4p(acc[i], hrev, lds4(xs + (sub + W * i) * K + 4 * j4));
            }
#pragma unroll
            for (int m4 = 0; m4 < NS / 4; ++m4) {
                const float4 rv = lds4(sm + S_R + lane * R_ROW + 4 * m4);
#pragma unroll
                for (int i = 0; i < NQ; ++i)
                    dot4p(acc[i], rv, lds4(ug + (sub + W * i) * NS + 4 * m4));
            }
            float* const yc = y + (size_t)c * n + (size_t)seg * SEG * K + lane;
#pragma unroll
            for (int i = 0; i < NQ; ++i)
                if (sub + W * i < nq) yc[(sub + W * i) * K] = total(acc[i]);
        }
        __syncthreads();
        mark<STAMPS>(ph, 3, last);
    }
    if (scanning)
        *reinterpret_cast<float4*>(state_out + (size_t)c * NS + lane * SPB) =
            make_float4(s[0], s[1], s[2], s[3]);
    if (STAMPS && tid == 0) {
        mark<STAMPS>(ph, 4, last);
        long long* row = stamps + (size_t)blockIdx.x * (N_PHASES + 2);
        for (int i = 0; i < N_PHASES; ++i) row[i] = ph[i];
        row[N_PHASES] = clock_now() - c0c;
        row[N_PHASES + 1] = ns_now() - ns0;
    }
}

template <bool STAMPS>
int run(const void* x, const void* state, const void* gains,
        const void* ops, int n_consts, int channels, int n, void* y,
        void* state_out, void* stamps, void* stream)
{
    if (n_consts != N_CONSTS || n % K != 0 || n <= 0) return (int)cudaErrorInvalidValue;
    if (channels <= 0) return 0;
    const auto args = [&](auto kernel, int ch) {
        kernel<<<(channels + ch - 1) / ch, WARPS * 32, 0, (cudaStream_t)stream>>>(
            (const float*)x, (const float*)state, (const float*)gains,
            (const float*)ops, channels, n / K, (float*)y, (float*)state_out,
            (long long*)stamps);
    };
    if (channels <= FEW) args(eq_kernel<WARPS, STAMPS>, 1);
    else args(eq_kernel<W_MANY, STAMPS>, WARPS / W_MANY);
    return (int)cudaGetLastError();
}

}  // namespace

// x, y: (C, n) float32, n a positive multiple of 32; state, state_out:
// (C, 56); gains (C, 14); ops: kernel_consts.  x, state and the outputs
// 16-byte aligned.
extern "C" int t41x_eq(const void* x, const void* state, const void* gains,
                       const void* ops, int n_consts,
                       int channels, int n, void* y, void* state_out,
                       void* stream)
{
    return run<false>(x, state, gains, ops, n_consts, channels, n, y,
                      state_out, nullptr, stream);
}

// the same with stamps: (blocks, N_PHASES + 2) int64, a block a channel
// at up to 132 channels, else a block of 8
extern "C" int t41x_eq_phases(const void* x, const void* state,
                              const void* gains, const void* ops,
                              int n_consts, int channels, int n, void* y,
                              void* state_out, void* stamps, void* stream)
{
    return run<true>(x, state, gains, ops, n_consts, channels, n, y,
                     state_out, stamps, stream);
}
