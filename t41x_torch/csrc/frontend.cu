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
// Layout: one thread block per channel; the block's 2048 I and Q
// samples, the x4 input and the x2 input stay in shared memory (~38 KB),
// so device memory sees the 16 KB block in and 2 KB out per channel.
// What bounds it on the card: the DC particular solution, a 128-wide
// lower-triangular dot per sample (~0.26 MFLOP per channel), read from
// shared memory with the operator L coalesced from L2.  It is simple on
// purpose: no tensor cores (the audio path stays in full fp32).
//
// K1z, zoom 1..7: the panadapter's zoom tap, taken after the Fs/4 shift
// and before the NCO.  Its 8-pole elliptic anti-alias IIR, 4-tap FIR and
// decimation by zf = 2^z are one S = 11 state linear system, composed at
// design time (t41x_torch.dsp.chunk_ops.zoom_chunk_ops) into per-chunk
// operators on [x_k | s_k]: Ws (K+S, S) gives the next state, Wy
// (K+S, K/zf) the chunk's decimated outputs.  I and Q run as two real
// streams.  The state drives x_k Ws[:K] of all 16 chunks are computed in
// parallel, one warp then runs the S-state recursion over the chunks (a
// lane per state element), and every chunk's outputs follow in parallel
// from its start state, the operators read through L1/L2.  Full fp32
// FMA, no tensor cores: the composed system has poles within ~1e-3 of
// the unit circle at zoom 7, and reduced-precision products cost the
// TPU kernel 6.4 dB of displayed-spectrum error.  The tap adds 16 KB of
// shared memory (its input) and ~0.7 MFLOP per channel at zoom 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 128;        // DC-biquad chunk length (t41x _K)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
frontend_kernel(const float2* __restrict__ iq,       // (C, n) or null
                const int16_t* __restrict__ iq_i,    // (C, n) q15 or null
                const int16_t* __restrict__ iq_q,
                const float* __restrict__ pp,        // (C, 5) g amp ph w ph0
                const float* __restrict__ dcs,       // (C, 4) s1I s2I s1Q s2Q
                const float2* __restrict__ dec1,     // (C, t1-1)
                const float2* __restrict__ dec2,     // (C, t2-1)
                const float* __restrict__ Lt,        // (K, K) Lt[j][r] = L[r][j]
                const float* __restrict__ R,         // (K, 2)
                const float* __restrict__ G,         // (K, 2)
                const float* __restrict__ AK,        // (2, 2)
                float b0,
                const float* __restrict__ h1r,       // (t1) taps, reversed
                const float* __restrict__ h2r,       // (t2) taps, reversed
                int n, int t1, int t2, int df1, int df2, float nco_gain,
                float2* __restrict__ y,              // (C, n / (df1 df2))
                float* __restrict__ ndcs,            // (C, 4)
                float* __restrict__ nph,             // (C,)
                float2* __restrict__ ndec1,          // (C, t1-1)
                float2* __restrict__ ndec2,          // (C, t2-1)
                float2* __restrict__ seg, int seg_len,  // (C, seg_len) or null
                const float* __restrict__ Wy,        // (K+S, K/zf) zoom tap
                const float* __restrict__ Ws,        // (K+S, S)
                const float* __restrict__ zs,        // (C, 2S) state [I | Q]
                int S, int zf,                       // S = 0: no zoom tap
                float2* __restrict__ zdec,           // (C, n/zf)
                float* __restrict__ nzs)             // (C, 2S)
{
    extern __shared__ float sm[];
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    const int n1 = n / df1, n2 = n1 / df2, nch = n / K;
    const int hl1 = t1 - 1, hl2 = t2 - 1;

    float* xi = sm;                  // (n) gain-scaled I
    float* xq = xi + n;              // (n) gain-scaled Q
    float* b1r = xq + n;             // (hl1 + n) [dec1 history | mixed]
    float* b1i = b1r + hl1 + n;
    float* b2r = b1i + hl1 + n;      // (hl2 + n1) [dec2 history | x4 out]
    float* b2i = b2r + hl2 + n1;
    float* drive = b2i + hl2 + n1;   // (nch, 4) x_k G for I0 I1 Q0 Q1
    float* sstart = drive + 4 * nch; // (nch, 4) state at each chunk start
    float* sh1 = sstart + 4 * nch;   // (t1)
    float* sh2 = sh1 + t1;           // (t2)
    float* zbr = sh2 + t2;           // (n) zoom tap input, I (S > 0 only)
    float* zbi = zbr + n;            // (n) zoom tap input, Q
    float* zdrv = zbi + n;           // (2, nch, S) x_k Ws[:K] per stream
    float* zst = zdrv + 2 * nch * S; // (2, nch+1, S) state at chunk starts

    const float g = pp[c * 5 + 0];
    const float amp = pp[c * 5 + 1];
    const float ph = pp[c * 5 + 2];
    const float w = pp[c * 5 + 3];
    const float ph0 = pp[c * 5 + 4];

    // ---- stage the block, the histories and the taps -------------------
    const size_t row = (size_t)c * n;
    for (int i = tid; i < n; i += THREADS) {
        float vr, vi;
        if (iq != nullptr) {
            const float2 v = iq[row + i];
            vr = v.x;
            vi = v.y;
        } else {
            vr = (float)iq_i[row + i];
            vi = (float)iq_q[row + i];
        }
        xi[i] = vr * g;
        xq[i] = vi * g;
    }
    for (int i = tid; i < hl1; i += THREADS) {
        const float2 v = dec1[(size_t)c * hl1 + i];
        b1r[i] = v.x;
        b1i[i] = v.y;
    }
    for (int i = tid; i < hl2; i += THREADS) {
        const float2 v = dec2[(size_t)c * hl2 + i];
        b2r[i] = v.x;
        b2i[i] = v.y;
    }
    for (int i = tid; i < t1; i += THREADS) sh1[i] = h1r[i];
    for (int i = tid; i < t2; i += THREADS) sh2[i] = h2r[i];
    __syncthreads();

    // ---- DC biquad, state drive of every chunk: x_k @ G -----------------
    for (int d = tid; d < 4 * nch; d += THREADS) {
        const int k = d >> 2, stream = (d >> 1) & 1, comp = d & 1;
        const float* xs = (stream ? xq : xi) + k * K;
        float acc = 0.f;
        for (int j = 0; j < K; ++j) acc += xs[j] * G[j * 2 + comp];
        drive[d] = acc;
    }
    __syncthreads();

    // ---- the serial part: the 2-element state over the chunks -----------
    if (tid < 2) {  // thread 0: I stream, thread 1: Q stream
        float s1 = dcs[c * 4 + 2 * tid], s2 = dcs[c * 4 + 2 * tid + 1];
        for (int k = 0; k < nch; ++k) {
            sstart[k * 4 + 2 * tid] = s1;
            sstart[k * 4 + 2 * tid + 1] = s2;
            const float u1 = AK[0] * s1 + AK[1] * s2 + drive[k * 4 + 2 * tid];
            const float u2 = AK[2] * s1 + AK[3] * s2 + drive[k * 4 + 2 * tid + 1];
            s1 = u1;
            s2 = u2;
        }
        ndcs[c * 4 + 2 * tid] = s1;
        ndcs[c * 4 + 2 * tid + 1] = s2;
    }
    __syncthreads();

    // ---- DC output, IQ correction, Fs/4 x NCO, per sample --------------
    for (int i = tid; i < n; i += THREADS) {
        const int k = i / K, r = i % K, base = k * K;
        // L is strictly lower triangular: L[r][j] = 0 for j >= r, so the
        // sum may stop at the warp's largest r (warp-uniform bound)
        const int jmax = (r | 31) + 1;
        float pi_ = 0.f, pq_ = 0.f;
        for (int j = 0; j < jmax; ++j) {
            const float l = Lt[j * K + r];
            pi_ += l * xi[base + j];
            pq_ += l * xq[base + j];
        }
        const float* s0 = sstart + k * 4;
        const float ip = b0 * xi[i] + s0[0] * R[r * 2] + s0[1] * R[r * 2 + 1] + pi_;
        const float qp = b0 * xq[i] + s0[2] * R[r * 2] + s0[3] * R[r * 2 + 1] + pq_;

        // IQ amplitude/phase correction (Utility.cpp:178-187)
        float ic, qc;
        if (ph >= 0.f) {
            ic = ip * amp + ph * qp;
            qc = qp;
        } else {
            ic = ip * amp;
            qc = qp + ph * ic;
        }
        if (seg != nullptr && i < seg_len)
            seg[(size_t)c * seg_len + i] = make_float2(ic, qc);

        // exact j^n (Fs/4), then gain * exp(-i theta)
        float zr, zi;
        switch (i & 3) {
            case 0: zr = ic;  zi = qc;  break;
            case 1: zr = -qc; zi = ic;  break;
            case 2: zr = -ic; zi = -qc; break;
            default: zr = qc; zi = -ic; break;
        }
        if (S > 0) {  // the zoom tap takes the Fs/4-shifted signal, no NCO
            zbr[i] = zr;
            zbi[i] = zi;
        }
        zr = nco_gain * zr;
        zi = nco_gain * zi;
        const float th = __fadd_rn(ph0, __fmul_rn(w, (float)(i + 1)));
        float sn, cs;
        sincosf(th, &sn, &cs);
        b1r[hl1 + i] = zr * cs + zi * sn;
        b1i[hl1 + i] = zi * cs - zr * sn;
    }
    __syncthreads();

    if (S > 0) {
        // ---- zoom 2^z tap: [x_k | s_k] Ws -> s_{k+1}, [x_k | s_k] Wy -> y_k
        const int kout = K / zf, nz = n / zf;
        // the state drive of every chunk, x_k Ws[:K], both streams
        for (int d = tid; d < nch * S; d += THREADS) {
            const int k = d / S, j = d % S;
            const float* ur = zbr + k * K;
            const float* uq = zbi + k * K;
            float ar = 0.f, aq = 0.f;
            for (int i = 0; i < K; ++i) {
                const float wt = Ws[i * S + j];
                ar += ur[i] * wt;
                aq += uq[i] * wt;
            }
            zdrv[k * S + j] = ar;
            zdrv[(nch + k) * S + j] = aq;
        }
        __syncthreads();
        // the serial part, one warp: lanes 0-15 carry I, 16-31 Q, a lane
        // per state element
        if (tid < 32) {
            const int strm = tid >> 4, j = tid & 15;
            float* st = zst + strm * (nch + 1) * S;
            const float* dr = zdrv + strm * nch * S;
            if (j < S) st[j] = zs[(size_t)c * 2 * S + strm * S + j];
            __syncwarp();
            for (int k = 0; k < nch; ++k) {
                if (j < S) {
                    float v = dr[k * S + j];
                    for (int l = 0; l < S; ++l)
                        v += st[k * S + l] * Ws[(K + l) * S + j];
                    st[(k + 1) * S + j] = v;
                }
                __syncwarp();
            }
            if (j < S) nzs[(size_t)c * 2 * S + strm * S + j] = st[nch * S + j];
        }
        __syncthreads();
        // every chunk's decimated outputs from its start state, in parallel
        for (int o = tid; o < nz; o += THREADS) {
            const int k = o / kout, r = o % kout;
            const float* ur = zbr + k * K;
            const float* uq = zbi + k * K;
            const float* sr = zst + k * S;
            const float* sq = zst + (nch + 1 + k) * S;
            float yr = 0.f, yq = 0.f;
            for (int i = 0; i < K; ++i) {
                const float wt = Wy[i * kout + r];
                yr += ur[i] * wt;
                yq += uq[i] * wt;
            }
            for (int l = 0; l < S; ++l) {
                const float wt = Wy[(K + l) * kout + r];
                yr += sr[l] * wt;
                yq += sq[l] * wt;
            }
            zdec[(size_t)c * nz + o] = make_float2(yr, yq);
        }
    }

    // ---- x4 decimator (newest-sample phase) + its new history ------------
    for (int i = tid; i < hl1; i += THREADS)
        ndec1[(size_t)c * hl1 + i] = make_float2(b1r[n + i], b1i[n + i]);
    for (int m = tid; m < n1; m += THREADS) {
        const int o = m * df1 + df1 - 1;
        float ar = 0.f, ai = 0.f;
        for (int k = 0; k < t1; ++k) {
            ar += sh1[k] * b1r[o + k];
            ai += sh1[k] * b1i[o + k];
        }
        b2r[hl2 + m] = ar;
        b2i[hl2 + m] = ai;
    }
    __syncthreads();

    // ---- x2 decimator + its new history ----------------------------------
    for (int i = tid; i < hl2; i += THREADS)
        ndec2[(size_t)c * hl2 + i] = make_float2(b2r[n1 + i], b2i[n1 + i]);
    for (int m = tid; m < n2; m += THREADS) {
        const int o = m * df2 + df2 - 1;
        float ar = 0.f, ai = 0.f;
        for (int k = 0; k < t2; ++k) {
            ar += sh2[k] * b2r[o + k];
            ai += sh2[k] * b2i[o + k];
        }
        y[(size_t)c * n2 + m] = make_float2(ar, ai);
    }

    // ---- carried NCO phase: remainder(phi0 + w n, 2 pi) ------------------
    if (tid == 0) {
        const float two_pi = 6.28318530717958647692f;
        float a = __fadd_rn(ph0, __fmul_rn(w, (float)n));
        float mod = fmodf(a, two_pi);
        if (mod != 0.f && mod < 0.f) mod += two_pi;
        nph[c] = mod;
    }
}

}  // namespace

extern "C" int t41x_frontend(
    const void* iq, const void* iq_i, const void* iq_q, const void* pp,
    const void* dcs, const void* dec1, const void* dec2, const void* Lt,
    const void* R, const void* G, const void* AK, float b0, const void* h1r,
    const void* h2r, int channels, int n, int t1, int t2, int df1, int df2,
    float nco_gain, void* y, void* ndcs, void* nph, void* ndec1, void* ndec2,
    void* seg, int seg_len, const void* Wy, const void* Ws, const void* zs,
    int S, int zf, void* zdec, void* nzs, void* stream)
{
    if (channels <= 0) return 0;
    if (S < 0 || S > 16 || (S > 0 && (zf <= 0 || K % zf != 0)))
        return (int)cudaErrorInvalidValue;
    const int n1 = n / df1, nch = n / K;
    const size_t floats = 2 * (size_t)n + 2 * (size_t)(t1 - 1 + n)
        + 2 * (size_t)(t2 - 1 + n1) + 8 * (size_t)nch + t1 + t2
        + (S > 0 ? 2 * (size_t)n + 2 * (size_t)(2 * nch + 1) * S : 0);
    const size_t smem = floats * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    frontend_kernel<<<channels, THREADS, smem, (cudaStream_t)stream>>>(
        (const float2*)iq, (const int16_t*)iq_i, (const int16_t*)iq_q,
        (const float*)pp, (const float*)dcs, (const float2*)dec1,
        (const float2*)dec2, (const float*)Lt, (const float*)R,
        (const float*)G, (const float*)AK, b0, (const float*)h1r,
        (const float*)h2r, n, t1, t2, df1, df2, nco_gain, (float2*)y,
        (float*)ndcs, (float*)nph, (float2*)ndec1, (float2*)ndec2,
        (float2*)seg, seg_len, (const float*)Wy, (const float*)Ws,
        (const float*)zs, S, zf, (float2*)zdec, (float*)nzs);
    return (int)cudaGetLastError();
}
