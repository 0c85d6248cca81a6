// K1: the whole RF front end of one receive block, fused.
//
// Replaces the TPU kernel t41x/kernels/frontend_pallas.py,
// FusedFrontEnd._kernel, in all its variants: zoom None, 0 and 1..7
// (K1z), complex64 and q15 input.
// Per channel: RF gain (q15 folds its 1/32768 into the gain), the
// DC-block biquad as the K=128 chunk operator of t41x.dsp.iir
// (y = b0 x + s R^T + x L^T, s' = s AK^T + x G, normal-form state
// coordinates, so state moves between this kernel, the plain torch path
// and t41x unchanged), IQ amplitude/phase correction, the exact j^n
// Fs/4 shift times the NCO phasor (per-sample sincosf of
// theta = phi0 + w (n+1), the closed form of t41x.dsp.nco.nco_mix), and
// the x4 then x2 polyphase decimators with carried histories (CMSIS
// newest-sample phase, t41x.dsp.fir.fir_decimate).  zoom 0 also stores
// the first seg_len IQ-corrected samples, taken before the Fs/4 shift.
//
// What bounds it on the card: its bytes.  At 1024 channels a block moves
// ~23 MB (16.8 MB of c64 input, 2 MB out, 4 MB of zoom-x1 segment):
// ~6.9 us at 3.35 TB/s.  The function's own arithmetic (the DC biquad's
// 5 FMAs a sample and stream, the IQ correction, the NCO, the 28- and
// 46-tap decimators) is ~0.18 GFLOP, ~2.6 us at 67 TFLOP/s.  The chunk-
// parallel form below does ~4x that work (its DC particular solution
// alone is 2 x 8128 FMAs per 128-sample chunk and stream), ~10 us: the
// price of running the recurrence in parallel.
//
// Design: one thread block per channel, 256 threads, everything staged
// in shared memory (23 KB; 53 KB with the zoom tap).
// * The DC particular solution is a 128-tap convolution: L is Toeplitz,
//   L[n, j] = h[n-1-j], so the wrapper passes the 127 taps h and the
//   kernel takes them as kernel parameters (the constant bank: a fully
//   unrolled loop feeds them to the FMAs as operands, no load at all).
//   The block's samples are 32 rows (I and Q x 16 chunks) of a padded
//   shared array, row pitch 137 (odd: the 32 rows of a warp's load hit
//   32 banks) with 8 zeros before each chunk.  Lane l of every warp owns
//   row l; warp w computes the outputs 8w..8w+7 and 120-8w..127-8w of
//   its chunk (17 tap blocks a warp, balanced), each run of 8 outputs
//   from a 15-value sliding register window: 15 loads feed 64 FMAs.
// * The I and Q of a sample meet through one shuffle (lanes l and
//   l^16); each lane then does IQ correction, the shift, sincosf and the
//   NCO for 4 of the run's 8 samples.
// * The decimators' inputs are stored split by polyphase phase (mod 4
//   for x4, mod 2 for x2, with a 2-word pad every 32 for the chunk-
//   strided stores), so a warp's reads are free of bank conflicts; the
//   taps are kernel parameters as well.
// * The mixed stream overwrites the staged samples once the DC pass has
//   consumed them.  Warp 0 runs the serial 2-state recursion over the
//   chunks while the other warps start the convolution.
//
// K1z, zoom 1..7: the panadapter's zoom tap, taken after the Fs/4 shift
// and before the NCO.  Its 8-pole elliptic anti-alias IIR, 4-tap FIR and
// decimation by zf = 2^z are one S = 11 state linear system, composed at
// design time (t41x_torch.dsp.chunk_ops.zoom_chunk_ops) into per-chunk
// operators on [x_k | s_k]: Ws (K+S, S) gives the next state, Wy
// (K+S, K/zf) the chunk's decimated outputs.  I and Q run as two real
// streams.  The tap's input keeps the sample rows' layout; its operators
// are staged in shared memory with the block.  Wy's x part is Toeplitz
// too (Wy[i, r] = hz[(r+1) zf - 1 - i]), so the kernel holds its 128
// taps hz and its state part Rz = Wy[K:].T.  The state drives x_k Ws[:K]
// of all 16 chunks are summed in parallel (8 warps over 16 samples
// each), one warp runs the S-state recursion over the chunks (a lane per
// state element, in a register; the fixed-order sum of the drives and
// the state product through shuffles), and the outputs follow from each
// chunk's start state: 16 tasks (a run of 8 decimated outputs, a phase
// m = zf t + e), each from sliding windows as in the DC pass, paired so
// every warp has the same work, their partial sums added in order.  Full
// fp32 FMA, no tensor cores: the composed system has poles within ~1e-3
// of the unit circle at zoom 7, and reduced-precision products cost the
// TPU kernel 6.4 dB of displayed-spectrum error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 128;          // DC-biquad chunk length (t41x _K)
constexpr int N = 2048;         // block length
constexpr int NCH = N / K;      // 16 chunks
constexpr int T1 = 28, T2 = 46; // decimator taps
constexpr int DF1 = 4, DF2 = 2;
constexpr int N1 = N / DF1, N2 = N1 / DF2;
constexpr int HL1 = T1 - 1, HL2 = T2 - 1;
constexpr int THREADS = 256;
constexpr int PITCH = 137;      // sample-row pitch: 8 zeros + 128 + 1
constexpr int PAD = 8;
constexpr int ROWS = 2 * NCH;   // 32: (I, Q) x chunks
constexpr int X_SZ = ROWS * PITCH;
constexpr int PH1 = 552;        // x4 input: a phase array, padded
constexpr int B1_SZ = 2 * 4 * PH1;
constexpr int PH2 = 304;        // x2 input: a phase array (= 16 mod 32)
constexpr int B2_SZ = 2 * 2 * PH2;
constexpr int ZS = 12;          // zoom state, padded (S <= 12)
constexpr int A_SZ = X_SZ > B1_SZ ? X_SZ : B1_SZ;
constexpr int SMALL = 4 * ROWS; // DC drives, chunk start states
constexpr int ZTASKS = 16;      // zoom output tasks: (run of 8, phase)
// the zoom tap's own region: its input rows, the chunk start states,
// and its operators Ws[:K], Ws[K:], hz, Rz (K/zf <= 64 rows)
constexpr int ZOOM_SZ = X_SZ + 2 * (NCH + 1) * ZS + K * ZS + ZS * ZS + K
    + (K / 2) * ZS;

static_assert(8 * ROWS * ZS <= A_SZ, "zoom drive partials fit region A");
static_assert(ZTASKS * 8 * 32 <= A_SZ, "zoom task partials fit region A");
static_assert(8 * ROWS * 2 <= B2_SZ, "DC drive partials fit region B");

// every constant of the DC stage and the decimators, passed by value:
// the constant bank, read by the FMAs directly
struct FeConst {
    float hdc[K];    // hdc[0] = 0, hdc[m] = h[m-1]: p[r] = sum hdc[m] x[r-m]
    float R[2 * K];  // (K, 2)
    float G[2 * K];  // (K, 2)
    float AK[4];     // (2, 2)
    float b0;
    float h1r[T1];   // x4 taps, reversed
    float h2r[T2];   // x2 taps, reversed
};

__device__ __forceinline__ int b1_at(int i)  // x4 input index -> offset
{
    const int q = i >> 2;
    return (i & 3) * PH1 + q + 2 * (q >> 5);
}

__device__ __forceinline__ int b2_at(int i)  // x2 input index -> offset
{
    return (i & 1) * PH2 + (i >> 1);
}

// the DC particular solution of outputs 8lr..8lr+7 of one sample row
__device__ __forceinline__ void dc_run(const float* __restrict__ xrow,
                                       int lr, const FeConst& c,
                                       float acc[8])
{
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    const float* xb = xrow + 8 * lr;
#pragma unroll
    for (int blk = 0; blk < NCH; ++blk) {
        if (blk > lr) break;
        float w[15];  // w[d] = x[8 lr - 8 blk + d - 7]
#pragma unroll
        for (int d = 0; d < 15; ++d) w[d] = xb[d - 7 - 8 * blk];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            const float h = c.hdc[8 * blk + t];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i] = fmaf(h, w[i - t + 7], acc[i]);
        }
    }
}

// Zoom outputs, one task: phase e of the run of 8 decimated outputs
// r0..r0+7 of row `urow` (zf = ZF), the taps m = ZF t + e:
// acc[i] = sum_t hz[ZF t + e] u[ZF (r0 + i + 1 - t) - 1 - e], from
// 15-value sliding windows over blocks of 8 t.  Samples before the
// chunk (the last block only) read as 0.
template <int ZF>
__device__ __forceinline__ void zoom_task(const float* __restrict__ urow,
                                          const float* __restrict__ hzs,
                                          int t, float acc[8])
{
    const int ri = t / ZF, e = t % ZF, r0 = 8 * ri;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    for (int b = 0; b <= ri; ++b) {
        const int base = ZF * (r0 - 6 - 8 * b) - 1 - e;
        const bool edge = b == ri;
        float wv[15];
#pragma unroll
        for (int d = 0; d < 15; ++d) {
            const int idx = base + ZF * d;
            wv[d] = (!edge || idx >= 0) ? urow[idx] : 0.f;
        }
        const float* hb = hzs + ZF * 8 * b + e;
#pragma unroll
        for (int tt = 0; tt < 8; ++tt) {
            const float h = hb[ZF * tt];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                acc[i] = fmaf(h, wv[i - tt + 7], acc[i]);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
frontend_kernel(const __grid_constant__ FeConst cst,
                const float2* __restrict__ iq,       // (C, N) or null
                const int16_t* __restrict__ iq_i,    // (C, N) q15 or null
                const int16_t* __restrict__ iq_q,
                const float* __restrict__ pp,        // (C, 5) g amp ph w ph0
                const float* __restrict__ dcs,       // (C, 4) s1I s2I s1Q s2Q
                const float2* __restrict__ dec1,     // (C, T1-1)
                const float2* __restrict__ dec2,     // (C, T2-1)
                float nco_gain,
                float2* __restrict__ y,              // (C, N2)
                float* __restrict__ ndcs,            // (C, 4)
                float* __restrict__ nph,             // (C,)
                float2* __restrict__ ndec1,          // (C, T1-1)
                float2* __restrict__ ndec2,          // (C, T2-1)
                float2* __restrict__ seg, int seg_len,  // (C, seg_len) or null
                const float* __restrict__ hz,        // (K) zoom taps
                const float* __restrict__ Rz,        // (K/zf, S) = Wy[K:].T
                const float* __restrict__ Ws,        // (K+S, S)
                const float* __restrict__ zs,        // (C, 2S) state [I | Q]
                int S, int zf,                       // S = 0: no zoom tap
                float2* __restrict__ zdec,           // (C, N/zf)
                float* __restrict__ nzs)             // (C, 2S)
{
    extern __shared__ __align__(16) float sm[];
    const int c = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int s = lane >> 4, k = lane & 15;   // this lane's row: (s, k)

    float* X = sm;                        // A: sample rows, then the
    float* b1re = sm;                     //    x4 input by phase
    float* b1im = sm + 4 * PH1;
    float* Bq = sm + A_SZ;                // B: the x2 input by phase
    float* b2re = Bq;
    float* b2im = Bq + 2 * PH2;
    float* drive = Bq + B2_SZ;            // (ROWS, 2)
    float* sstart = drive + 2 * ROWS;     // (ROWS, 2)
    float* U = sstart + 2 * ROWS;         // zoom input rows (S > 0 only)
    float* zst = U + X_SZ;                // (2, NCH+1, ZS) start states
    float* Wsx = zst + 2 * (NCH + 1) * ZS;  // (K, ZS) = Ws[:K], padded
    float* Wss = Wsx + K * ZS;            // (ZS, ZS) = Ws[K:], padded
    float* hzs = Wss + ZS * ZS;           // (K) zoom taps
    float* Rzs = hzs + K;                 // (K/zf, ZS) = Wy[K:].T, padded
    const int kout = S > 0 ? K / zf : 0, nz = S > 0 ? N / zf : 0;

    const float g = pp[c * 5 + 0];
    const float amp = pp[c * 5 + 1];
    const float ph = pp[c * 5 + 2];
    const float w = pp[c * 5 + 3];
    const float ph0 = pp[c * 5 + 4];

    // ---- stage the block as 32 padded rows ------------------------------
    const size_t row = (size_t)c * N;
    for (int e = tid; e < N / 2; e += THREADS) {
        float r0, i0, r1, i1;
        if (iq != nullptr) {
            const float4 v = reinterpret_cast<const float4*>(iq + row)[e];
            r0 = v.x; i0 = v.y; r1 = v.z; i1 = v.w;
        } else {
            const short2 a = reinterpret_cast<const short2*>(iq_i + row)[e];
            const short2 b = reinterpret_cast<const short2*>(iq_q + row)[e];
            r0 = (float)a.x; r1 = (float)a.y; i0 = (float)b.x; i1 = (float)b.y;
        }
        const int n = 2 * e, kk = n / K, j = PAD + n % K;
        X[kk * PITCH + j] = r0 * g;
        X[kk * PITCH + j + 1] = r1 * g;
        X[(NCH + kk) * PITCH + j] = i0 * g;
        X[(NCH + kk) * PITCH + j + 1] = i1 * g;
    }
    for (int e = tid; e < ROWS * PAD; e += THREADS)
        X[(e / PAD) * PITCH + e % PAD] = 0.f;
    if (S > 0) {  // the zoom tap's operators and start state
        for (int e = tid; e < K * ZS; e += THREADS) {
            const int i = e / ZS, j = e % ZS;
            Wsx[e] = j < S ? Ws[i * S + j] : 0.f;
        }
        for (int e = tid; e < ZS * ZS; e += THREADS) {
            const int l = e / ZS, j = e % ZS;
            Wss[e] = (l < S && j < S) ? Ws[(K + l) * S + j] : 0.f;
        }
        for (int e = tid; e < K; e += THREADS) hzs[e] = hz[e];
        for (int e = tid; e < kout * ZS; e += THREADS) {
            const int r = e / ZS, l = e % ZS;
            Rzs[e] = l < S ? Rz[r * S + l] : 0.f;
        }
        for (int e = tid; e < 2 * ZS; e += THREADS) {
            const int st = e / ZS, j = e % ZS;
            zst[st * (NCH + 1) * ZS + j] =
                j < S ? zs[(size_t)c * 2 * S + st * S + j] : 0.f;
        }
    }
    __syncthreads();

    // ---- DC biquad, state drive of every chunk: x_k @ G -----------------
    {   // warp w sums samples 16w..16w+15 of row `lane`
        const float* xr = X + lane * PITCH + PAD + 16 * warp;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int jj = 16 * warp + j;
            a0 = fmaf(xr[j], cst.G[2 * jj], a0);
            a1 = fmaf(xr[j], cst.G[2 * jj + 1], a1);
        }
        Bq[(warp * ROWS + lane) * 2] = a0;
        Bq[(warp * ROWS + lane) * 2 + 1] = a1;
    }
    __syncthreads();

    // ---- the serial part, in warp 0 while the others start the DC pass:
    // the drives summed in a fixed order, then the 2-element state over
    // the chunks (lane 0: I stream, lane 1: Q stream)
    if (warp == 0) {
        for (int d = lane; d < 2 * ROWS; d += 32) {
            float a = 0.f;
            for (int v = 0; v < THREADS / 32; ++v) a += Bq[v * 2 * ROWS + d];
            drive[d] = a;
        }
        __syncwarp();
        if (lane < 2) {
            float s1 = dcs[c * 4 + 2 * lane], s2 = dcs[c * 4 + 2 * lane + 1];
            for (int kk = 0; kk < NCH; ++kk) {
                const int r = lane * NCH + kk;
                sstart[2 * r] = s1;
                sstart[2 * r + 1] = s2;
                const float u1 = cst.AK[0] * s1 + cst.AK[1] * s2
                    + drive[2 * r];
                const float u2 = cst.AK[2] * s1 + cst.AK[3] * s2
                    + drive[2 * r + 1];
                s1 = u1;
                s2 = u2;
            }
            ndcs[c * 4 + 2 * lane] = s1;
            ndcs[c * 4 + 2 * lane + 1] = s2;
        }
    }

    // ---- DC output: particular solution + b0 x, two runs a lane ---------
    const int lrs[2] = {warp, NCH - 1 - warp};
    float v[2][8];
    {
        const float* xrow = X + lane * PITCH + PAD;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            dc_run(xrow, lrs[u], cst, v[u]);
#pragma unroll
            for (int i = 0; i < 8; ++i)
                v[u][i] += cst.b0 * xrow[8 * lrs[u] + i];
        }
    }
    __syncthreads();  // every row consumed: region A takes the x4 input;
                      // the chunk start states are in
    {   // + s R
        const float sa = sstart[2 * lane], sb = sstart[2 * lane + 1];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int r = 8 * lrs[u] + i;
                v[u][i] += sa * cst.R[2 * r] + sb * cst.R[2 * r + 1];
            }
    }

    // the decimators' carried histories
    for (int i = tid; i < HL1; i += THREADS) {
        const float2 d = dec1[(size_t)c * HL1 + i];
        b1re[b1_at(i)] = d.x;
        b1im[b1_at(i)] = d.y;
    }
    for (int i = tid; i < HL2; i += THREADS) {
        const float2 d = dec2[(size_t)c * HL2 + i];
        b2re[b2_at(i)] = d.x;
        b2im[b2_at(i)] = d.y;
    }

    // ---- IQ correction, Fs/4 x NCO, per sample --------------------------
#pragma unroll
    for (int u = 0; u < 2; ++u) {
        float send[4], recv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            send[j] = s ? v[u][j] : v[u][4 + j];
            recv[j] = __shfl_xor_sync(0xffffffffu, send[j], 16);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float ip = s ? recv[j] : v[u][j];
            const float qp = s ? v[u][4 + j] : recv[j];
            const int n = k * K + 8 * lrs[u] + 4 * s + j;

            // IQ amplitude/phase correction (Utility.cpp:178-187)
            float ic, qc;
            if (ph >= 0.f) {
                ic = ip * amp + ph * qp;
                qc = qp;
            } else {
                ic = ip * amp;
                qc = qp + ph * ic;
            }
            if (seg != nullptr && n < seg_len)
                seg[(size_t)c * seg_len + n] = make_float2(ic, qc);

            // exact j^n (Fs/4; n & 3 == j), then gain * exp(-i theta)
            float zr, zi;
            switch (j) {
                case 0: zr = ic;  zi = qc;  break;
                case 1: zr = -qc; zi = ic;  break;
                case 2: zr = -ic; zi = -qc; break;
                default: zr = qc; zi = -ic; break;
            }
            if (S > 0) {  // the zoom tap takes the Fs/4-shifted signal
                U[k * PITCH + PAD + n % K] = zr;
                U[(NCH + k) * PITCH + PAD + n % K] = zi;
            }
            zr = nco_gain * zr;
            zi = nco_gain * zi;
            const float th = __fadd_rn(ph0, __fmul_rn(w, (float)(n + 1)));
            float sn, cs;
            sincosf(th, &sn, &cs);
            b1re[b1_at(HL1 + n)] = zr * cs + zi * sn;
            b1im[b1_at(HL1 + n)] = zi * cs - zr * sn;
        }
    }
    __syncthreads();

    // ---- x4 decimator (newest-sample phase) + its new history ------------
    for (int i = tid; i < HL1; i += THREADS)
        ndec1[(size_t)c * HL1 + i] = make_float2(b1re[b1_at(N + i)],
                                                 b1im[b1_at(N + i)]);
    for (int m = tid; m < N1; m += THREADS) {
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int kk = 0; kk < T1; ++kk) {
            const int a = b1_at(DF1 * m + DF1 - 1 + kk);
            ar = fmaf(cst.h1r[kk], b1re[a], ar);
            ai = fmaf(cst.h1r[kk], b1im[a], ai);
        }
        b2re[b2_at(HL2 + m)] = ar;
        b2im[b2_at(HL2 + m)] = ai;
    }
    __syncthreads();

    // ---- x2 decimator + its new history ----------------------------------
    for (int i = tid; i < HL2; i += THREADS)
        ndec2[(size_t)c * HL2 + i] = make_float2(b2re[b2_at(N1 + i)],
                                                 b2im[b2_at(N1 + i)]);
    for (int m = tid; m < N2; m += THREADS) {
        float ar = 0.f, ai = 0.f;
#pragma unroll
        for (int kk = 0; kk < T2; ++kk) {
            const int a = b2_at(DF2 * m + DF2 - 1 + kk);
            ar = fmaf(cst.h2r[kk], b2re[a], ar);
            ai = fmaf(cst.h2r[kk], b2im[a], ai);
        }
        y[(size_t)c * N2 + m] = make_float2(ar, ai);
    }

    // ---- carried NCO phase: remainder(phi0 + w n, 2 pi) ------------------
    if (tid == 0) {
        const float two_pi = 6.28318530717958647692f;
        float a = __fadd_rn(ph0, __fmul_rn(w, (float)N));
        float mod = fmodf(a, two_pi);
        if (mod != 0.f && mod < 0.f) mod += two_pi;
        nph[c] = mod;
    }
    if (S == 0) return;

    // ---- zoom 2^z tap ----------------------------------------------------
    __syncthreads();  // region A is free
    float* part = sm;  // (8, ROWS, ZS) drive partials, then task partials
    {   // the state drive x_k Ws[:K]: warp w over samples 16w..16w+15
        const float* ur = U + lane * PITCH + PAD + 16 * warp;
        float a[ZS];
#pragma unroll
        for (int j = 0; j < ZS; ++j) a[j] = 0.f;
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
            const float x = ur[i];
            const float4* wr = reinterpret_cast<const float4*>(
                Wsx + (16 * warp + i) * ZS);
#pragma unroll
            for (int q = 0; q < ZS / 4; ++q) {
                const float4 w4 = wr[q];
                a[4 * q] = fmaf(x, w4.x, a[4 * q]);
                a[4 * q + 1] = fmaf(x, w4.y, a[4 * q + 1]);
                a[4 * q + 2] = fmaf(x, w4.z, a[4 * q + 2]);
                a[4 * q + 3] = fmaf(x, w4.w, a[4 * q + 3]);
            }
        }
#pragma unroll
        for (int j = 0; j < ZS; ++j) part[(warp * ROWS + lane) * ZS + j] = a[j];
    }
    __syncthreads();
    if (warp == 0) {
        // the serial part: lanes 0-15 carry I, 16-31 Q, a lane per state
        // element in a register; each chunk's drive is the warps'
        // partials summed in a fixed order, the state product goes
        // through shuffles
        const int j = k;
        const bool jv = j < ZS;
        float wcol[ZS];
#pragma unroll
        for (int l = 0; l < ZS; ++l) wcol[l] = jv ? Wss[l * ZS + j] : 0.f;
        float* st = zst + s * (NCH + 1) * ZS;
        float x = jv ? st[j] : 0.f;
        for (int kk = 0; kk < NCH; ++kk) {
            float a = 0.f;
            for (int v8 = 0; v8 < THREADS / 32; ++v8)
                a += jv ? part[(v8 * ROWS + s * NCH + kk) * ZS + j] : 0.f;
#pragma unroll
            for (int l = 0; l < ZS; ++l)
                a += __shfl_sync(0xffffffffu, x, (s << 4) + l) * wcol[l];
            x = a;
            if (jv) st[(kk + 1) * ZS + j] = x;
        }
        if (j < S) nzs[(size_t)c * 2 * S + s * S + j] = x;
    }
    __syncthreads();

    // every chunk's decimated outputs from its start state: lane `lane`
    // owns row (s, k); y[r] = sum_m hz[m] u[(r+1) zf - 1 - m] + Rz[r] st_k
    const float* urow = U + lane * PITCH + PAD;
    const float* stk = zst + (s * (NCH + 1) + k) * ZS;
    if (kout >= 8) {
        // 16 tasks (a run of 8 outputs, a phase), tasks w and 15 - w a
        // warp: their costs (blocks of 8 taps) add to the same for every
        // warp.  Each task's partial sums go to shared memory.
#pragma unroll
        for (int u = 0; u < 2; ++u) {
            const int t = u ? ZTASKS - 1 - warp : warp;
            float acc[8];
            switch (zf) {
                case 2: zoom_task<2>(urow, hzs, t, acc); break;
                case 4: zoom_task<4>(urow, hzs, t, acc); break;
                case 8: zoom_task<8>(urow, hzs, t, acc); break;
                default: zoom_task<16>(urow, hzs, t, acc); break;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) part[(t * 8 + i) * 32 + lane] = acc[i];
        }
        __syncthreads();
        if (8 * warp < kout) {  // run `warp`: its phases, in order
            float acc[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float a = 0.f;
                for (int e = 0; e < zf; ++e)
                    a += part[((warp * zf + e) * 8 + i) * 32 + lane];
                for (int l = 0; l < ZS; ++l)
                    a = fmaf(Rzs[(8 * warp + i) * ZS + l], stk[l], a);
                acc[i] = a;
            }
            float send[4], recv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                send[j] = s ? acc[j] : acc[4 + j];
                recv[j] = __shfl_xor_sync(0xffffffffu, send[j], 16);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int r = 8 * warp + 4 * s + j;
                zdec[(size_t)c * nz + k * kout + r] = s
                    ? make_float2(recv[j], acc[4 + j])
                    : make_float2(acc[j], recv[j]);
            }
        }
    } else if (warp < kout) {  // fewer than 8 outputs a chunk: one a warp
        const int r = warp, n = (r + 1) * zf - 1;
        float a = 0.f;
        for (int m = 0; m <= n; ++m) a = fmaf(hzs[m], urow[n - m], a);
        for (int l = 0; l < ZS; ++l) a = fmaf(Rzs[r * ZS + l], stk[l], a);
        const float o = __shfl_xor_sync(0xffffffffu, a, 16);
        if (s == 0) zdec[(size_t)c * nz + k * kout + r] = make_float2(a, o);
    }
}

}  // namespace

extern "C" int t41x_frontend(
    const void* cst, const void* iq, const void* iq_i, const void* iq_q,
    const void* pp, const void* dcs, const void* dec1, const void* dec2,
    int channels, int n, int t1, int t2, int df1, int df2, float nco_gain,
    void* y, void* ndcs, void* nph, void* ndec1, void* ndec2, void* seg,
    int seg_len, const void* hz, const void* Rz, const void* Ws,
    const void* zs, int S, int zf, void* zdec, void* nzs, void* stream)
{
    if (channels <= 0) return 0;
    if (n != N || t1 != T1 || t2 != T2 || df1 != DF1 || df2 != DF2 ||
        S < 0 || S > ZS ||
        (S > 0 && (zf < 2 || zf > K || (zf & (zf - 1)) != 0)))
        return (int)cudaErrorInvalidValue;
    const size_t floats = A_SZ + B2_SZ + SMALL + (S > 0 ? ZOOM_SZ : 0);
    const size_t smem = floats * sizeof(float);
    const cudaError_t e = cudaFuncSetAttribute(
        frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    FeConst k;
    const float* h = (const float*)cst;  // the FeConst fields, in order
    float* dst = reinterpret_cast<float*>(&k);
    for (size_t i = 0; i < sizeof(FeConst) / sizeof(float); ++i) dst[i] = h[i];
    frontend_kernel<<<channels, THREADS, smem, (cudaStream_t)stream>>>(
        k, (const float2*)iq, (const int16_t*)iq_i, (const int16_t*)iq_q,
        (const float*)pp, (const float*)dcs, (const float2*)dec1,
        (const float2*)dec2, nco_gain, (float2*)y, (float*)ndcs,
        (float*)nph, (float2*)ndec1, (float2*)ndec2, (float2*)seg, seg_len,
        (const float*)hz, (const float*)Rz, (const float*)Ws,
        (const float*)zs, S, zf, (float2*)zdec, (float*)nzs);
    return (int)cudaGetLastError();
}
