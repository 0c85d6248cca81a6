// B1: the overlap-save band-pass with the audio-spectrum tap, as one
// fused FFT kernel.
//
// Replaces no TPU kernel.  It replaces the two dense complex products of
// t41x.dsp.osfilter.os_filter_matmul_spectrum (X = [h | x] @ F^T, the
// 512-point DFT as a matrix; y = X @ W2^T) and the elementwise passes
// around them (the concatenation, |X|^2 mask_sq, the SSB level scale
// before them).  t41x wrote the DFT as matrix products only because the
// TPU has no FFT (t41x/kernels/mxu_fft.py); on this card they cost
// 8 C 512 512 + 8 C 256 512 flops, 12.9 GFLOP a block at 4096 channels,
// >= 192 us at the fp32 peak, for a function that needs ~51 kflop a
// channel as FFTs.  For each channel (history h and new samples x, both
// 256 complex64), with W_N = exp(-2 pi i / N):
//
//   xs   = scale * x                      written as the new history
//   X    = FFT512([h | xs])
//   spec = |X|^2 |mask|^2                 (C, 512) float32
//   y    = IFFT512(X mask)[256:]          (C, 256) complex64
//
// What bounds it on the card: its bytes.  A channel reads h and x (2 KB
// each) and writes xs, y and spec (2 KB each): 10 KB, 41.9 MB a block
// at 4096 channels, 12.5 us at 3.35 TB/s (587 MB, 175 us, at 57,344
// channels); its ~0.1 Mflop a channel take ~6 us at 67 TFLOP/s.
//
// Design: everything between the loads and the stores stays on chip.
// * 64 threads a channel, each holding 8 complex points in registers;
//   512 = 8 x 8 x 8, so each transform is three radix-8 passes (an
//   8-point DFT in registers, `dft8`), a twiddle multiply after the first
//   and second, and an exchange through shared memory before the second
//   and the third.  The forward transform leaves thread u holding
//   X[u + 64 m] in register m, so the spectrum is stored straight from
//   the registers, a warp's 32 lanes on 32 neighbouring floats; the
//   inverse starts there with no reordering (its first pass runs over
//   those registers) and ends with thread u holding y[u + 64 q] in
//   register q, of which q >= 4 are stored (the discarded half is never
//   stored, and its last-pass arithmetic is dead code).
// * Loads and stores: lane u of a channel's 64 threads touches element
//   u + 64 j, so each warp access is 256 neighbouring bytes; all 8 loads
//   of a thread are issued before any arithmetic.
// * The exchanges (t41x_torch/kernels/os_spectrum.py EXCHANGES gives
//   their addresses, which the CPU tests drive through a NumPy model of
//   these passes against np.fft) use two padded buffers a channel in
//   turn, so one barrier an exchange suffices; the paddings put every
//   half-warp's 8-byte accesses on distinct banks.  The barrier is a
//   named one of the channel's two warps (bar.sync id, 64), so the 4
//   channels of a block do not wait for each other and a ragged last
//   block simply has fewer of them.
// * Twiddles come from tables designed in float64 and rounded to float32
//   once, by the chain (`tables`): T1[k][t] = W512^(k t) for the first
//   pass of each transform (conjugated in the inverse), read by lane t
//   as 256 neighbouring bytes, and T2[m][t] = W64^(m t) for the second.
//   The mask is stored pre-divided by 512 (exact), which is the inverse
//   transform's scale.  Only dft8's W8 = (1 - i) / sqrt(2) is a literal:
//   sqrt(1/2) rounded to float.  Full fp32 throughout: fmaf, no fast-math
//   intrinsics, no tensor cores.
// Measured (H100 80GB HBM3 at 700 W; device us a call, L2 flushed; 64
// registers, 40 KB shared a block of 4 channels, no spills): 6.10 at
// 1024 channels (bound 3.13), 14.86 at 4096 (12.52: 84%), 197.5 at
// 57,344 (175.3: 89%); the same stage in torch.fft form (osfilter.
// os_filter(..., return_spectrum=True) on the scaled input) 27.4, 70.1
// and 1244, the plain version's GEMMs 92.3 and 302.9.

#include <cuda_runtime.h>

namespace {

constexpr int F = 512, HALF = 256;
constexpr int TPC = 64;                 // threads a channel
constexpr int CPB = 4;                  // channels a block
constexpr int THREADS = TPC * CPB;
// a channel's two exchange buffers, float2 slots (EXCHANGES' sizes)
constexpr int BUF_A = 8 * 72, BUF_B = 8 * 88;
// the tables' layout, float2 slots (os_spectrum.py: T1_AT ... MSQ_AT)
constexpr int T1_AT = 0, T2_AT = 512, MASK_AT = 576, MSQ_AT = 1088;

__device__ __forceinline__ float2 cmul(float2 a, float2 b)
{
    return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

// a times conj(b)
__device__ __forceinline__ float2 cmulc(float2 a, float2 b)
{
    return make_float2(fmaf(a.x, b.x, a.y * b.y), fmaf(a.y, b.x, -a.x * b.y));
}

__device__ __forceinline__ float2 add(float2 a, float2 b)
{
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 sub(float2 a, float2 b)
{
    return make_float2(a.x - b.x, a.y - b.y);
}

// the 4-point DFT of z into v[h], v[2 + h], v[4 + h], v[6 + h] (INV: the
// unscaled inverse)
template <bool INV>
__device__ __forceinline__ void dft4(const float2 (&z)[4], float2 (&v)[8],
                                     int h)
{
    const float2 s0 = add(z[0], z[2]), d0 = sub(z[0], z[2]);
    const float2 s1 = add(z[1], z[3]), d1 = sub(z[1], z[3]);
    // -+ i d1 (forward: - i)
    const float2 id1 = INV ? make_float2(-d1.y, d1.x)
                           : make_float2(d1.y, -d1.x);
    v[h] = add(s0, s1);
    v[4 + h] = sub(s0, s1);
    v[2 + h] = add(d0, id1);
    v[6 + h] = sub(d0, id1);
}

// the 8-point DFT of v in place (INV: the unscaled inverse): a radix-2
// step, x_j + x_{j+4} and (x_j - x_{j+4}) W8^(+-j), then a 4-point DFT of
// each half; the sums give the even outputs, the differences the odd
template <bool INV>
__device__ __forceinline__ void dft8(float2 (&v)[8])
{
    constexpr float S = 0.707106781186547524f;   // sqrt(1/2)
    float2 a[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        a[j] = add(v[j], v[j + 4]);
        b[j] = sub(v[j], v[j + 4]);
    }
    // b1 W8^(-+1), b2 W8^(-+2) = -+i, b3 W8^(-+3) (forward: the minus)
    if (INV) {
        b[1] = make_float2((b[1].x - b[1].y) * S, (b[1].x + b[1].y) * S);
        b[2] = make_float2(-b[2].y, b[2].x);
        b[3] = make_float2(-(b[3].x + b[3].y) * S, (b[3].x - b[3].y) * S);
    } else {
        b[1] = make_float2((b[1].x + b[1].y) * S, (b[1].y - b[1].x) * S);
        b[2] = make_float2(b[2].y, -b[2].x);
        b[3] = make_float2((b[3].y - b[3].x) * S, -(b[3].x + b[3].y) * S);
    }
    dft4<INV>(a, v, 0);
    dft4<INV>(b, v, 1);
}

// the barrier of one channel's two warps
__device__ __forceinline__ void named_bar_sync(int id)
{
    asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(TPC) : "memory");
}

__global__ void __launch_bounds__(THREADS, 4)
os_spectrum_kernel(const float2* __restrict__ hist,   // (C, 256)
                   const float2* __restrict__ x,      // (C, 256)
                   const float2* __restrict__ tab,    // `tables`
                   float scale, int channels,
                   float2* __restrict__ new_hist,     // (C, 256)
                   float2* __restrict__ y,            // (C, 256)
                   float* __restrict__ spec)          // (C, 512)
{
    __shared__ float2 smem[CPB][BUF_A + BUF_B];
    const int g = threadIdx.x / TPC;     // the block's channel
    const int u = threadIdx.x % TPC;     // the thread in its channel
    const int lo = u % 8, hi = u / 8;
    const long long c = (long long)blockIdx.x * CPB + g;
    if (c >= channels) return;           // no other channel waits on it
    float2* sa = smem[g];
    float2* sb = smem[g] + BUF_A;
    const float2* T1 = tab + T1_AT;
    const float2* T2 = tab + T2_AT;
    const float2* mask = tab + MASK_AT;
    const float* mask_sq = reinterpret_cast<const float*>(tab + MSQ_AT);
    const int bar = 1 + g;               // 0 is __syncthreads'

    // thread u holds [h | scale x][u + 64 j] in register j
    float2 v[8];
    const float2* hc = hist + c * HALF;
    const float2* xc = x + c * HALF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        v[j] = hc[u + 64 * j];
        v[4 + j] = xc[u + 64 * j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        v[4 + j] = make_float2(v[4 + j].x * scale, v[4 + j].y * scale);
        new_hist[c * HALF + u + 64 * j] = v[4 + j];
    }

    // forward pass 1: over j (thread t = u), twiddle W512^(k1 t)
    dft8<false>(v);
#pragma unroll
    for (int i = 1; i < 8; ++i) v[i] = cmul(v[i], T1[i * 64 + u]);
#pragma unroll
    for (int i = 0; i < 8; ++i) sa[i * 72 + u] = v[i];
    named_bar_sync(bar);
    // pass 2: thread (k1 = hi, t1 = lo) over t2, twiddle W64^(m1 t1)
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = sa[hi * 72 + lo + 8 * i];
    dft8<false>(v);
#pragma unroll
    for (int i = 1; i < 8; ++i) v[i] = cmul(v[i], T2[i * 8 + lo]);
#pragma unroll
    for (int i = 0; i < 8; ++i) sb[i * 88 + lo * 10 + hi] = v[i];
    named_bar_sync(bar);
    // pass 3: thread (k1 = lo, m1 = hi) over t1: X[u + 64 m2] in v[m2]
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = sb[hi * 88 + i * 10 + lo];
    dft8<false>(v);

    // the spectrum tap and the mask (with the inverse's 1/512)
    float* sc = spec + c * F;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int k = u + 64 * i;
        sc[k] = fmaf(v[i].x, v[i].x, v[i].y * v[i].y) * mask_sq[k];
        v[i] = cmul(v[i], mask[k]);
    }

    // inverse pass 1: thread k' = u over m2, twiddle W512^-(p1 k')
    dft8<true>(v);
#pragma unroll
    for (int i = 1; i < 8; ++i) v[i] = cmulc(v[i], T1[i * 64 + u]);
#pragma unroll
    for (int i = 0; i < 8; ++i) sa[i * 72 + u] = v[i];
    named_bar_sync(bar);
    // pass 2: thread (k1 = lo, p1 = hi) over m1, twiddle W64^-(q1 k1)
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = sa[hi * 72 + i * 8 + lo];
    dft8<true>(v);
#pragma unroll
    for (int i = 1; i < 8; ++i) v[i] = cmulc(v[i], T2[i * 8 + lo]);
#pragma unroll
    for (int i = 0; i < 8; ++i) sb[lo * 66 + hi + 8 * i] = v[i];
    named_bar_sync(bar);
    // pass 3: thread (p1 = lo, q1 = hi) over k1: y[u + 64 q2] in v[q2]
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = sb[i * 66 + u];
    dft8<true>(v);
    float2* yc = y + c * HALF;
#pragma unroll
    for (int i = 4; i < 8; ++i) yc[u + 64 * (i - 4)] = v[i];
}

}  // namespace

extern "C" int t41x_os_spectrum(const void* hist, const void* x,
                                const void* tab, float scale, int channels,
                                void* new_hist, void* y, void* spec,
                                void* stream)
{
    if (channels <= 0) return 0;
    const int blocks = (channels + CPB - 1) / CPB;
    os_spectrum_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const float2*)hist, (const float2*)x, (const float2*)tab, scale,
        channels, (float2*)new_hist, (float2*)y, (float*)spec);
    return (int)cudaGetLastError();
}
