// K4: the overlap-save band-pass as one complex matrix product.
//
// Replaces the TPU kernel t41x/kernels/os_filter_pallas.py, _kernel
// (os_filter_matmul_pallas): y = [history | x] @ W^T with history, x
// (C, F/2) complex64 and W (F/2, F) complex64 from
// t41x.dsp.osfilter.os_matmul_operator; the new history is x (the
// wrapper returns it).  The concatenation is never formed: the A-tile
// loader reads the history for k < F/2 and x after.
//
// What bounds it on the card: fp32 FMA issue.  The work is
// 8 C (F/2) F flops, 1.07 GFLOP per block at C = 1024, F = 512: 16 us at
// the H100's 67 TFLOP/s.  Its bytes (2 MB history, 2 MB x, 1 MB W, 2 MB
// y) take ~2 us at 3.35 TB/s.  No tensor cores: TF32 keeps ~3 decimal
// digits, and reduced matmul precision cost the TPU chain 48.9 dB of
// audio parity against its 55 dB budget.
//
// Design (M = channels, N = F/2, K = F, all complex):
// * Fill the card and feed the FMAs: 32 x 64 output tiles, a 4 x 4
//   complex register tile a thread (64 FMAs for every 6 shared-memory
//   loads), and the sum over K split between the two thread blocks of a
//   cluster: one takes the history half of [history | x], the other the
//   x half.  At C = 1024 that is 256 blocks of 128 threads, two per SM,
//   8 warps an SM.  The x half's block leaves its partial sums in its
//   shared memory and the history half's block adds them through the
//   cluster's distributed shared memory, in a fixed order (no atomics:
//   the result does not depend on timing).
// * Hide the loads: a 4-stage ring of BK = 16 k-tiles in shared memory,
//   filled by cp.async 16-byte copies, so the next tiles' loads overlap
//   the current tile's FMAs.
// * W is packed once, by the chain when it is built, into k-major real
//   and imaginary planes Wp (2, K, N), so a B row of 64 columns is 256
//   contiguous bytes and a thread reads its 4 columns as one float4.
//   The A tile keeps the device layout (k contiguous per channel) with
//   a row pitch of 36 floats: a warp's reads of its rows hit distinct
//   banks.
// * Each thread's copy offsets are worked out once per block; the k loop
//   is fully unrolled, so it is ~90% FFMAs.
// * The ragged channel edge is zero-filled in the loads (cp.async with
//   a source size of 0) and masked in the store.
// Why this shape (kernel_ab.py on an H100 80GB HBM3 at 700 W): 256
// blocks of 2 x 4 tiles and no split took 36.7 us a call at 1024
// channels, this design 27-29 us, about the plain torch.cat + cuBLAS
// product; 4 x 8 tiles (167 registers) split two or four ways 39-52 us.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 32, BN = 64, BK = 16, TM = 4, TN = 4, STAGES = 4;
constexpr int SPLIT = 2;                        // blocks per cluster
constexpr int CG = TN / 4;                      // float4 column groups
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int APITCH = 2 * BK + 4;              // floats per A row
constexpr int A_FLOATS = BM * APITCH;
constexpr int B_FLOATS = 2 * BK * BN;           // re and im planes
constexpr int STAGE_FLOATS = A_FLOATS + B_FLOATS;
constexpr size_t SMEM = (size_t)STAGES * STAGE_FLOATS * sizeof(float);

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes)
{
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// A thread's share of a k-tile's cp.async copies: A_PER 16-byte pieces
// of A and B_PER of the W planes, their offsets worked out once per
// block (the k-loop then only adds the tile's k offset)
constexpr int A_PER = BM * BK / 2 / THREADS;
constexpr int B_PER = 2 * BK * BN / 4 / THREADS;
static_assert(A_PER * THREADS == BM * BK / 2, "A tile split evenly");
static_assert(B_PER * THREADS == 2 * BK * BN / 4, "B tile split evenly");

struct TileCopies {
    int a_src[A_PER], a_dst[A_PER], a_bytes[A_PER];
    int b_src[B_PER], b_dst[B_PER];
};

__device__ __forceinline__ TileCopies tile_copies(int channels, int half,
                                                  int row0, int col0,
                                                  int tid)
{
    TileCopies t;
    const int K = 2 * half;
#pragma unroll
    for (int j = 0; j < A_PER; ++j) {
        const int e = tid + j * THREADS;
        const int m = e / (BK / 2), q = e % (BK / 2);
        const bool ok = row0 + m < channels;
        t.a_src[j] = ok ? (row0 + m) * half * 2 + 4 * q : 0;  // zero-filled
        t.a_dst[j] = m * APITCH + 4 * q;
        t.a_bytes[j] = ok ? 16 : 0;
    }
#pragma unroll
    for (int j = 0; j < B_PER; ++j) {
        const int e = tid + j * THREADS;
        const int p = e / (BK * BN / 4), r = e % (BK * BN / 4);
        const int kk = r / (BN / 4), q = r % (BN / 4);
        t.b_src[j] = (p * K + kk) * half + col0 + 4 * q;
        t.b_dst[j] = A_FLOATS + (p * BK + kk) * BN + 4 * q;
    }
    return t;
}

// one k-tile: A columns kc.. of `src` (BM rows x BK complex), W^T rows
// k0.. of both planes (BK x BN floats each), into stage buffer `s`
__device__ __forceinline__ void load_tile(
    float* s, const float* __restrict__ src, const float* __restrict__ Wp,
    const TileCopies& t, int half, int kc, int k0)
{
#pragma unroll
    for (int j = 0; j < A_PER; ++j)
        cp_async16(s + t.a_dst[j], src + t.a_src[j] + 2 * kc, t.a_bytes[j]);
#pragma unroll
    for (int j = 0; j < B_PER; ++j)
        cp_async16(s + t.b_dst[j], Wp + t.b_src[j] + (size_t)k0 * half, 16);
}

__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(THREADS)
os_filter_kernel(const float* __restrict__ hist,   // (C, half) complex
                 const float* __restrict__ x,      // (C, half) complex
                 const float* __restrict__ Wp,     // (2, 2 half, half)
                 int channels, int half,
                 float2* __restrict__ y)           // (C, half)
{
    extern __shared__ __align__(16) float sm[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();  // this block's part of K
    const int tid = threadIdx.x;
    const int tr = tid / (BN / TN), tc = tid % (BN / TN);
    const int row0 = blockIdx.y * BM, col0 = (blockIdx.x / SPLIT) * BN;
    const int kpart = 2 * half / SPLIT;
    const int kbase = rank * kpart;              // its rows of W^T
    const float* src = kbase < half ? hist : x;  // [history | x]
    const int kc0 = kbase < half ? kbase : kbase - half;
    const int nk = kpart / BK;
    const TileCopies cp = tile_copies(channels, half, row0, col0, tid);

    float2 acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = make_float2(0.f, 0.f);

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk)
            load_tile(sm + s * STAGE_FLOATS, src, Wp, cp, half,
                      kc0 + s * BK, kbase + s * BK);
        cp_async_commit();
    }

    for (int t = 0; t < nk; ++t) {
        cp_async_wait<STAGES - 2>();   // tile t has landed
        __syncthreads();               // ... for every thread; and the
                                       // buffer refilled below is free
        const int tn = t + STAGES - 1;
        if (tn < nk)
            load_tile(sm + (tn % STAGES) * STAGE_FLOATS, src, Wp, cp, half,
                      kc0 + tn * BK, kbase + tn * BK);
        cp_async_commit();

        const float* As = sm + (t % STAGES) * STAGE_FLOATS
            + tr * TM * APITCH;
        const float* Br = sm + (t % STAGES) * STAGE_FLOATS + A_FLOATS
            + tc * 4;
        const float* Bi = Br + BK * BN;
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float2 a[TM];
#pragma unroll
            for (int i = 0; i < TM; ++i)
                a[i] = *reinterpret_cast<const float2*>(
                    As + i * APITCH + 2 * kk);
            float bre[TN], bim[TN];
#pragma unroll
            for (int g = 0; g < CG; ++g) {
                const float4 br = *reinterpret_cast<const float4*>(
                    Br + kk * BN + g * (BN / CG));
                const float4 bi = *reinterpret_cast<const float4*>(
                    Bi + kk * BN + g * (BN / CG));
                bre[4 * g] = br.x; bre[4 * g + 1] = br.y;
                bre[4 * g + 2] = br.z; bre[4 * g + 3] = br.w;
                bim[4 * g] = bi.x; bim[4 * g + 1] = bi.y;
                bim[4 * g + 2] = bi.z; bim[4 * g + 3] = bi.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    acc[i][j].x = fmaf(a[i].x, bre[j], acc[i][j].x);
                    acc[i][j].x = fmaf(-a[i].y, bim[j], acc[i][j].x);
                    acc[i][j].y = fmaf(a[i].x, bim[j], acc[i][j].y);
                    acc[i][j].y = fmaf(a[i].y, bre[j], acc[i][j].y);
                }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free: it takes the partial sums

    // the other blocks' partial sums, [value][thread], read by block 0
    // of the cluster through distributed shared memory and added in
    // rank order
    float* part = sm;
    if (rank != 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                part[(2 * (i * TN + j)) * THREADS + tid] = acc[i][j].x;
                part[(2 * (i * TN + j) + 1) * THREADS + tid] = acc[i][j].y;
            }
    }
    cluster.sync();
    if (rank == 0) {
#pragma unroll
        for (int r = 1; r < SPLIT; ++r) {
            const float* peer = cluster.map_shared_rank(part, r);
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                    acc[i][j].x += peer[(2 * (i * TN + j)) * THREADS + tid];
                    acc[i][j].y += peer[(2 * (i * TN + j) + 1) * THREADS + tid];
                }
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            const int c = row0 + tr * TM + i;
            if (c >= channels) continue;
#pragma unroll
            for (int g = 0; g < CG; ++g) {
                float4* dst = reinterpret_cast<float4*>(
                    y + (size_t)c * half + col0 + g * (BN / CG) + tc * 4);
                const float2* o = acc[i] + 4 * g;
                dst[0] = make_float4(o[0].x, o[0].y, o[1].x, o[1].y);
                dst[1] = make_float4(o[2].x, o[2].y, o[3].x, o[3].y);
            }
        }
    }
    cluster.sync();  // the other blocks keep their shared memory until read
}

}  // namespace

extern "C" int t41x_os_filter(const void* hist, const void* x,
                              const void* Wp, int channels, int half,
                              void* y, void* stream)
{
    if (channels <= 0) return 0;
    if ((size_t)channels * half * 2 >= (size_t)1 << 31)  // int offsets
        return (int)cudaErrorInvalidValue;
    if (half % BN != 0 || (2 * half / SPLIT) % BK != 0 ||
        half % (2 * half / SPLIT) != 0)
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(
        os_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    // SPLIT blocks (a cluster) per output tile, a part of K each
    const dim3 grid(SPLIT * (half / BN), (channels + BM - 1) / BM);
    os_filter_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
        (const float*)hist, (const float*)x, (const float*)Wp, channels,
        half, (float2*)y);
    return (int)cudaGetLastError();
}
