// K3: x2 then x4 output interpolation with the volume folded in.
//
// Replaces the TPU kernel t41x/kernels/interp_pallas.py,
// FusedInterp._kernel: two CMSIS zero-stuff polyphase interpolators
// (t41x.dsp.fir.fir_interpolate semantics, histories at the input rate)
// taking a block of n 24 kHz samples to 8 n samples at 192 kHz, the
// per-channel DF * volume scale applied at the store, and both stage
// histories as outputs (int1' = the last 23 inputs, int2' = the last 7
// stage-1 outputs).
//
// What bounds it on the card: bytes.  Per channel of the chain (n = 256)
// 1.15 KB in and 8.3 KB out against 28.7k FMAs: 2.89 us of HBM at 1024
// channels, 0.9 us of fp32.  The design keeps the instruction count near
// the FMAs so that the kernel can sit on its stores:
//  - the shapes are compile-time (24 taps a phase at x2, 8 at x4) and the
//    taps are a kernel parameter, so every FMA takes its tap from the
//    constant bank: no tap load, no index arithmetic, unrolled loops;
//  - stage 1 runs on register windows: a thread owns R = 2 consecutive
//    input samples and loads its R + 23 inputs once, with 8-byte shared
//    loads, for 48 R FMAs;
//  - stage 2 runs a thread per 48 kHz sample, so the four x4 phases of a
//    sample go out as one 16-byte store and a warp's stores cover 512
//    contiguous bytes;
//  - the audio is read with 16-byte loads, all in flight together, from
//    a row of any element stride (1 for a real row, 2 for the real part
//    of a complex64 row, so y.real needs no copy), and the kernel writes
//    both histories itself: the wrapper launches nothing else;
//  - a thread block per channel of 4 warps, so that 1024 channels give
//    ~31 warps an SM to hide the load and shared-memory latencies.
// Any n: the block walks its channel in segments of 32 W R samples,
// carrying both histories in shared memory.
//
// Arithmetic: each output is an fmaf chain from 0 over its taps, oldest
// sample first, then one product with the scale, as the plain version's
// cuDNN convolutions (TF32 off) and the Pallas kernel sum: the kernel
// equals the plain version bit for bit on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int L1 = 2, SUB1 = 24;  // x2 stage: 48 taps, 24 a phase
constexpr int L2 = 4, SUB2 = 8;   // x4 stage: 32 taps, 8 a phase
constexpr int H1 = SUB1 - 1;      // stage-1 history (input samples)
constexpr int H2 = SUB2 - 1;      // stage-2 history (48 kHz samples)
constexpr int R = 2;              // input samples a thread in stage 1
constexpr int W = 4;              // warps a channel (= a block)
constexpr int THREADS = 32 * W;
constexpr int SEG = THREADS * R;  // input samples a segment
constexpr int X1 = 24;            // x1[X1 + e]: segment sample e
constexpr int X2 = 8;             // x2[X2 + k]: stage-1 output k
// R even: 8-byte window loads and 16-byte stores of a thread's stage-1
// outputs.  R x W = 4 x 2, 8 x 1, 1 x 8 and 4 x 4 timed within the
// run-to-run spread of 2 x 4 on an H100 (2 x 8 ~8% slower).
static_assert(R % 2 == 0, "R even");

// the phases of each stage, reversed (oldest sample first):
// h1[j][p] = hi1[(SUB1 - 1 - j) L1 + p], h2 likewise
struct Taps {
    float h1[SUB1][L1];
    float h2[SUB2][L2];
};

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

// Stage the segment's ns samples into x1[X1 ..], zeros up to SEG.
// V = 1: 16-byte loads of 4 samples (stride 1); V = 2: 16-byte loads of
// 2 complex samples, real parts kept (stride 2); V = 0: scalar loads of
// any stride.  Every load is issued before the first shared store.
template <int V>
__device__ __forceinline__ void stage(const float* __restrict__ row,
                                      int step, int ns, float* x1, int t)
{
    if (V == 1) {
        constexpr int N = SEG / 4 / THREADS + (SEG / 4 % THREADS != 0);
        float4 v[N];
#pragma unroll
        for (int r = 0; r < N; ++r) {
            const int e = 4 * (t + r * THREADS);
            v[r] = e < ns ? *reinterpret_cast<const float4*>(row + e)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < N; ++r) {
            const int e = 4 * (t + r * THREADS);
            if (e < SEG) *reinterpret_cast<float4*>(x1 + X1 + e) = v[r];
        }
    } else if (V == 2) {
        constexpr int N = SEG / 2 / THREADS + (SEG / 2 % THREADS != 0);
        float4 v[N];
#pragma unroll
        for (int r = 0; r < N; ++r) {
            const int e = 2 * (t + r * THREADS);
            v[r] = e < ns ? *reinterpret_cast<const float4*>(row + 2 * e)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int r = 0; r < N; ++r) {
            const int e = 2 * (t + r * THREADS);
            if (e < SEG)
                *reinterpret_cast<float2*>(x1 + X1 + e) =
                    make_float2(v[r].x, v[r].z);
        }
    } else {
        float v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int e = t + r * THREADS;
            v[r] = e < ns ? row[(long long)e * step] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) x1[X1 + t + r * THREADS] = v[r];
    }
}

// STAMPS: thread 0 writes the block's clock64 cycles per phase (staging,
// stage 1, stage 2 and store), its total cycles and its nanoseconds to
// stamps[block * 5 ..].
template <int V, bool STAMPS>
__global__ void __launch_bounds__(THREADS)
interp_kernel(const float* __restrict__ audio,  // (C, n) at (pitch, step)
              long long pitch, int step,
              const float* __restrict__ int1,   // (C, H1)
              const float* __restrict__ int2,   // (C, H2)
              const float* __restrict__ vol,    // (C,)
              const Taps tp, int n,
              float* __restrict__ y,            // (C, 8 n)
              float* __restrict__ nint1,        // (C, H1)
              float* __restrict__ nint2,        // (C, H2)
              long long* __restrict__ stamps)
{
    // x1[k + 1] = [history | segment][k]; x2[k + 1] = [history | u][k]
    __shared__ __align__(16) float x1[X1 + SEG];
    __shared__ __align__(16) float x2[X2 + L1 * SEG];
    const int t = threadIdx.x;
    const long long c = blockIdx.x;
    const float* row = audio + c * pitch;
    long long clk[4] = {0, 0, 0, 0}, c0 = 0, ns0 = 0;
    if (STAMPS && t == 0) {
        c0 = clock_now();
        ns0 = ns_now();
    }

    // the histories and the scale, in flight with the first segment; the
    // scale goes through shared memory (x2[0]), since a register copy of
    // it would be made uniform, and that waits for the load before any
    // other is issued
    float h1 = 0.f, h2 = 0.f, vs = 0.f;
    if (t < H1) h1 = int1[c * H1 + t];
    if (t < H2) h2 = int2[c * H2 + t];
    if (t == 0) vs = vol[c];

    int ns = 0;
    for (int s0 = 0; s0 < n; s0 += SEG) {
        ns = min(SEG, n - s0);
        long long k0 = STAMPS ? clock_now() : 0;
        stage<V>(row + (long long)s0 * step, step, ns, x1, t);
        if (s0 == 0) {
            if (t < H1) x1[1 + t] = h1;
            if (t < H2) x2[1 + t] = h2;
            if (t == 0) {
                x1[0] = 0.f;  // in thread 0's window, never used
                x2[0] = vs;
            }
        }
        __syncthreads();
        long long k1 = STAMPS ? clock_now() : 0;

        // stage 1: u[2 m + p] = sum_j h1[j][p] xc1[m + j] for the thread's
        // m = R t .. R t + R - 1, from the window w[k] = x1[R t + k]
        {
            float w[R + SUB1];
            const float* src = x1 + R * t;
#pragma unroll
            for (int k = 0; k < R + SUB1; k += 2)
                *reinterpret_cast<float2*>(w + k) =
                    *reinterpret_cast<const float2*>(src + k);
            float u[L1 * R];
#pragma unroll
            for (int i = 0; i < R; ++i) {
#pragma unroll
                for (int p = 0; p < L1; ++p) {
                    float acc = 0.f;
#pragma unroll
                    for (int j = 0; j < SUB1; ++j)
                        acc = fmaf(tp.h1[j][p], w[i + j + 1], acc);
                    u[L1 * i + p] = acc;
                }
            }
            float* dst = x2 + X2 + L1 * R * t;
#pragma unroll
            for (int k = 0; k < L1 * R; k += 4)
                *reinterpret_cast<float4*>(dst + k) =
                    make_float4(u[k], u[k + 1], u[k + 2], u[k + 3]);
        }
        __syncthreads();
        long long k2 = STAMPS ? clock_now() : 0;

        // stage 2: a thread per 48 kHz sample q, its four phases
        // y[4 q + r] = v sum_j h2[j][r] xc2[q + j] as one 16-byte store.
        // The store is an explicit vector store: as a float4 assignment,
        // nvcc split it into four 4-byte stores, and unrolled it did too.
        float* out = y + c * 8 * n + 8LL * s0;
        const float v = x2[0];
#pragma unroll 1
        for (int q = t; q < L1 * ns; q += THREADS) {
            float x[SUB2];
#pragma unroll
            for (int j = 0; j < SUB2; ++j) x[j] = x2[q + 1 + j];
            float a[L2];
#pragma unroll
            for (int r = 0; r < L2; ++r) {
                float acc = 0.f;
#pragma unroll
                for (int j = 0; j < SUB2; ++j)
                    acc = fmaf(tp.h2[j][r], x[j], acc);
                a[r] = acc;
            }
            __stwb(reinterpret_cast<float4*>(out + 4 * q),
                   make_float4(a[0] * v, a[1] * v, a[2] * v, a[3] * v));
        }
        if (STAMPS) {
            __syncthreads();
            const long long k3 = clock_now();
            clk[0] += k1 - k0;
            clk[1] += k2 - k1;
            clk[2] += k3 - k2;
        }

        // the next segment's histories: the tails of this one
        if (s0 + SEG < n) {
            const float a1 = t < H1 ? x1[1 + SEG + t] : 0.f;
            const float a2 = t < H2 ? x2[1 + L1 * SEG + t] : 0.f;
            __syncthreads();
            if (t < H1) x1[1 + t] = a1;
            if (t < H2) x2[1 + t] = a2;
        }
    }

    // int1' = [history | audio][n ..], int2' = [history | u][2 n ..]
    if (t < H1) nint1[c * H1 + t] = x1[1 + ns + t];
    if (t < H2) nint2[c * H2 + t] = x2[1 + L1 * ns + t];

    if (STAMPS && t == 0) {
        long long* o = stamps + blockIdx.x * 5;
        for (int k = 0; k < 3; ++k) o[k] = clk[k];
        o[3] = clock_now() - c0;
        o[4] = ns_now() - ns0;
    }
}

bool aligned(const void* ptr, uintptr_t bytes)
{
    return ((uintptr_t)ptr & (bytes - 1)) == 0;
}

template <int V, bool STAMPS>
int launch(const void* audio, long long pitch, int step, const void* int1,
           const void* int2, const void* vol, const Taps& tp, int channels,
           int n, void* y, void* nint1, void* nint2, void* stamps,
           cudaStream_t stream)
{
    interp_kernel<V, STAMPS><<<channels, THREADS, 0, stream>>>(
        (const float*)audio, pitch, step, (const float*)int1,
        (const float*)int2, (const float*)vol, tp, n, (float*)y,
        (float*)nint1, (float*)nint2, (long long*)stamps);
    return (int)cudaGetLastError();
}

template <bool STAMPS>
int interp(const void* audio, long long pitch, int step, const void* int1,
           const void* int2, const void* vol, const float* hp1,
           const float* hp2, int sub1, int sub2, int channels, int n, void* y,
           void* nint1, void* nint2, void* stamps, void* stream)
{
    if (channels <= 0 || n <= 0) return 0;
    if (sub1 != SUB1 || sub2 != SUB2 || step < 1)
        return (int)cudaErrorInvalidValue;
    Taps tp;
    for (int j = 0; j < SUB1; ++j)
        for (int p = 0; p < L1; ++p) tp.h1[j][p] = hp1[j * L1 + p];
    for (int j = 0; j < SUB2; ++j)
        for (int p = 0; p < L2; ++p) tp.h2[j][p] = hp2[j * L2 + p];
    const cudaStream_t s = (cudaStream_t)stream;
    // 16-byte loads: rows and the segments' starts on 16-byte boundaries
    const bool vec = aligned(audio, 16) && pitch % 4 == 0;
    if (vec && step == 1 && n % 4 == 0)
        return launch<1, STAMPS>(audio, pitch, step, int1, int2, vol, tp,
                                 channels, n, y, nint1, nint2, stamps, s);
    if (vec && step == 2 && n % 2 == 0)
        return launch<2, STAMPS>(audio, pitch, step, int1, int2, vol, tp,
                                 channels, n, y, nint1, nint2, stamps, s);
    return launch<0, STAMPS>(audio, pitch, step, int1, int2, vol, tp,
                             channels, n, y, nint1, nint2, stamps, s);
}

}  // namespace

// audio: (channels, n) float32 at row pitch `pitch` and element stride
// `step` (floats); hp1 (sub1, 2), hp2 (sub2, 4): the reversed phases, in
// host memory, read here; y (channels, 8 n), nint1 (channels, 23), nint2
// (channels, 7) contiguous.  sub1 must be 24 and sub2 8.
extern "C" int t41x_interp(
    const void* audio, long long pitch, int step, const void* int1,
    const void* int2, const void* vol, const float* hp1, const float* hp2,
    int sub1, int sub2, int channels, int n, void* y, void* nint1,
    void* nint2, void* stream)
{
    return interp<false>(audio, pitch, step, int1, int2, vol, hp1, hp2, sub1,
                         sub2, channels, n, y, nint1, nint2, nullptr, stream);
}

// t41x_interp with the phase split: stamps (channels, 5) int64
extern "C" int t41x_interp_phases(
    const void* audio, long long pitch, int step, const void* int1,
    const void* int2, const void* vol, const float* hp1, const float* hp2,
    int sub1, int sub2, int channels, int n, void* y, void* nint1,
    void* nint2, void* stamps, void* stream)
{
    return interp<true>(audio, pitch, step, int1, int2, vol, hp1, hp2, sub1,
                        sub2, channels, n, y, nint1, nint2, stamps, stream);
}
