// K2: one whole AGC block; K5: the gain recurrence alone.
//
// K2 replaces the TPU kernel t41x/kernels/agc_pallas.py, _block_kernel
// (agc_block_pallas): |x|, the look-ahead delay line, the sliding-window
// peak over it, the 5-state WDSP gain recurrence (t41x.dsp.agc.agc_step,
// branch for branch), the log-domain gain curve and the delayed multiply.
//
// Layout: a thread block holds CB = 32 channels.  All its threads stage
// |[abs_ring | x]| time-major in shared memory (global reads coalesced
// along each channel's row) and compute the sliding maximum, any order
// of max being exact.  One warp, a lane per channel, then runs the
// recurrence serially over the block's samples with the seven states in
// registers, writing each sample's gain multiplier back into shared
// memory, and all threads form the delayed output.  What bounds it on
// the card: the serial recurrence, ~256 dependent steps of a few dozen
// instructions each, whatever the channel count; the channel count sets
// only how many SMs run it side by side.  Every multiply and add of the
// recurrence is rounded on its own (__fmul_rn/__fadd_rn, no contraction
// into FMA), as the plain torch version rounds it, so branch decisions
// match.
//
// K5 replaces t41x/kernels/agc_pallas.py, _kernel (agc_scan_pallas):
// the same per-sample step (agc_step below, shared with K2) over
// precomputed ring-max and |out| streams, for AGC blocks shorter than
// the delay line; the prework and the gain curve stay in torch around
// it.  One thread per channel, time-major (n, C) inputs so every step's
// loads coalesce.  What bounds it: the serial chain of n dependent
// steps, whatever the channel count, plus 12 bytes per sample and
// channel of device memory traffic.

#include <cuda_runtime.h>

namespace {

constexpr int CB = 32;        // channels per thread block (one warp)
constexpr int PITCH = CB + 1; // shared-memory row pitch, conflict-free
constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 128;  // K5: one channel a thread

struct AgcP {
    float attack_mult, decay_mult, fast_decay_mult, fast_backmult,
        onemfast_backmult, hang_backmult, onemhang_backmult, hang_decay_mult,
        out_target, min_volts, slope_constant, inv_max_input, hang_level,
        pop_ratio;
    int hang_counter_init, hang_enable;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// One sample of the 5-state attack/decay/hang machine
// (t41x.dsp.agc.agc_step, branch for branch): each state's release
// branch is computed, then selected first-true-wins.  rm is the window
// peak ending at this step's newest sample, ao the delayed |sample|.
__device__ __forceinline__ void agc_step(const AgcP& p, float rm, float ao,
                                         float& volts, float& sv, float& fb,
                                         float& hb, int& hc, int& dt, int& st)
{
    const float fast_back = add(mul(p.fast_backmult, ao),
                                mul(p.onemfast_backmult, fb));
    const float hang_back = add(mul(p.hang_backmult, ao),
                                mul(p.onemhang_backmult, hb));
    const int hcm = max(hc - 1, 0);
    const float diff = __fsub_rn(rm, volts);
    const bool attack = rm >= volts;

    // attack branch (any state -> 0)
    const float att_volts = add(volts, mul(diff, p.attack_mult));
    const float att_save = st >= 2 ? volts : sv;

    // release branches per state
    const bool s0_fast = volts > mul(p.pop_ratio, fast_back);
    const bool s0_hang = (p.hang_enable == 1) && (hang_back > p.hang_level);
    const int s0_state = s0_fast ? 1 : (s0_hang ? 2 : 3);
    const float s0_volts = s0_fast ? add(volts, mul(diff, p.fast_decay_mult))
        : (s0_hang ? volts : add(volts, mul(diff, p.decay_mult)));
    const int s0_hc = (s0_hang && !s0_fast) ? p.hang_counter_init : hcm;
    const int s0_dt = s0_fast ? dt : (s0_hang ? 1 : 0);

    const bool s1_fast = volts > sv;
    const bool s1_hang = hcm > 0;
    const int s1_state = s1_fast ? 1 : (s1_hang ? 2 : (dt == 0 ? 3 : 4));
    const float s1_volts = s1_fast ? add(volts, mul(diff, p.fast_decay_mult))
        : (s1_hang ? volts
           : (dt == 0 ? add(volts, mul(diff, p.decay_mult))
              : add(volts, mul(diff, p.hang_decay_mult))));

    const bool s2_done = hcm == 0;
    const int s2_state = s2_done ? 4 : 2;
    const float s2_volts = s2_done ? add(volts, mul(diff, p.hang_decay_mult))
                                   : volts;
    const float s3_volts = add(volts, mul(mul(diff, p.decay_mult), 0.05f));
    const float s4_volts = add(volts, mul(diff, p.hang_decay_mult));

    // first true wins: state 0, 1, 2, 3, else 4
    const float rel_volts = st == 0 ? s0_volts : st == 1 ? s1_volts
        : st == 2 ? s2_volts : st == 3 ? s3_volts : s4_volts;
    const int rel_state = st == 0 ? s0_state : st == 1 ? s1_state
        : st == 2 ? s2_state : st;
    const int rel_hc = st == 0 ? s0_hc : hcm;
    const int rel_dt = st == 0 ? s0_dt : dt;

    const float nv = attack ? att_volts : rel_volts;
    sv = attack ? att_save : sv;
    hc = attack ? hcm : rel_hc;
    dt = attack ? dt : rel_dt;
    st = attack ? 0 : rel_state;
    volts = fmaxf(nv, p.min_volts);
    fb = fast_back;
    hb = hang_back;
}

__global__ void __launch_bounds__(THREADS)
agc_kernel(const float2* __restrict__ x,         // (C, n)
           const float2* __restrict__ ring,      // (C, b)
           const float* __restrict__ abs_ring,   // (C, b)
           const float* __restrict__ v_in, const float* __restrict__ sv_in,
           const float* __restrict__ fb_in, const float* __restrict__ hb_in,
           const int* __restrict__ hc_in, const int* __restrict__ dt_in,
           const int* __restrict__ st_in,
           int channels, int n, int b, AgcP p,
           float2* __restrict__ y,               // (C, n)
           float* __restrict__ v_out, float* __restrict__ sv_out,
           float* __restrict__ fb_out, float* __restrict__ hb_out,
           int* __restrict__ hc_out, int* __restrict__ dt_out,
           int* __restrict__ st_out)
{
    extern __shared__ float sm[];
    const int L = b + n;
    float* sabs = sm;               // (L, PITCH) |[ring | x]|, time-major
    float* srm = sm + L * PITCH;    // (n, PITCH) ring max, then multiplier
    const int tid = threadIdx.x;
    const int c0 = blockIdx.x * CB;
    const int nc = min(CB, channels - c0);  // ragged last block: mask

    for (int idx = tid; idx < CB * L; idx += THREADS) {
        const int cl = idx / L, t = idx % L;
        float a = 0.f;
        if (cl < nc) {
            const size_t c = c0 + cl;
            if (t < b) {
                a = abs_ring[c * b + t];
            } else {
                const float2 v = x[c * n + (t - b)];
                a = hypotf(v.x, v.y);
            }
        }
        sabs[t * PITCH + cl] = a;
    }
    __syncthreads();

    // ring_max[t] = max(|full|[t+1 .. t+b]): the width-b window ending at
    // the newest sample of step t
    for (int idx = tid; idx < CB * n; idx += THREADS) {
        const int cl = idx % CB, t = idx / CB;
        float m = sabs[(t + 1) * PITCH + cl];
        for (int k = 2; k <= b; ++k) m = fmaxf(m, sabs[(t + k) * PITCH + cl]);
        srm[t * PITCH + cl] = m;
    }
    __syncthreads();

    if (tid < nc) {
        const int c = c0 + tid;
        float volts = v_in[c], sv = sv_in[c], fb = fb_in[c], hb = hb_in[c];
        int hc = hc_in[c], dt = dt_in[c], st = st_in[c];
        for (int t = 0; t < n; ++t) {
            // abs_full[t] = |delayed sample|
            agc_step(p, srm[t * PITCH + tid], sabs[t * PITCH + tid], volts, sv,
                     fb, hb, hc, dt, st);

            // log-domain gain curve (DSP_Fn.cpp:623-627)
            const float lg = fminf(0.f, log10f(mul(p.inv_max_input, volts)));
            srm[t * PITCH + tid] =
                __fdiv_rn(__fsub_rn(p.out_target, mul(p.slope_constant, lg)), volts);
        }
        v_out[c] = volts;
        sv_out[c] = sv;
        fb_out[c] = fb;
        hb_out[c] = hb;
        hc_out[c] = hc;
        dt_out[c] = dt;
        st_out[c] = st;
    }
    __syncthreads();

    // delayed output: y[t] = full[t] * mult[t], full = [ring | x]
    for (int idx = tid; idx < CB * n; idx += THREADS) {
        const int cl = idx / n, t = idx % n;
        if (cl < nc) {
            const size_t c = c0 + cl;
            const float2 d = t < b ? ring[c * b + t] : x[c * n + (t - b)];
            const float m = srm[t * PITCH + cl];
            y[c * n + t] = make_float2(d.x * m, d.y * m);
        }
    }
}

// K5: the gain recurrence alone.  One thread per channel runs agc_step
// over the n samples with its seven states in registers; the inputs are
// time-major (n, C), so each step's loads and the volts store coalesce
// across a warp.
__global__ void __launch_bounds__(SCAN_THREADS)
agc_scan_kernel(const float* __restrict__ rm,      // (n, C) window peaks
                const float* __restrict__ ao,      // (n, C) |delayed|
                const float* __restrict__ v_in, const float* __restrict__ sv_in,
                const float* __restrict__ fb_in, const float* __restrict__ hb_in,
                const int* __restrict__ hc_in, const int* __restrict__ dt_in,
                const int* __restrict__ st_in,
                int channels, int n, AgcP p,
                float* __restrict__ vseq,          // (n, C)
                float* __restrict__ v_out, float* __restrict__ sv_out,
                float* __restrict__ fb_out, float* __restrict__ hb_out,
                int* __restrict__ hc_out, int* __restrict__ dt_out,
                int* __restrict__ st_out)
{
    const int c = blockIdx.x * SCAN_THREADS + threadIdx.x;
    if (c >= channels) return;
    float volts = v_in[c], sv = sv_in[c], fb = fb_in[c], hb = hb_in[c];
    int hc = hc_in[c], dt = dt_in[c], st = st_in[c];
    for (int t = 0; t < n; ++t) {
        const size_t i = (size_t)t * channels + c;
        agc_step(p, rm[i], ao[i], volts, sv, fb, hb, hc, dt, st);
        vseq[i] = volts;
    }
    v_out[c] = volts;
    sv_out[c] = sv;
    fb_out[c] = fb;
    hb_out[c] = hb;
    hc_out[c] = hc;
    dt_out[c] = dt;
    st_out[c] = st;
}

AgcP make_params(const float* fparams, int hang_counter_init, int hang_enable)
{
    AgcP p;
    p.attack_mult = fparams[0];
    p.decay_mult = fparams[1];
    p.fast_decay_mult = fparams[2];
    p.fast_backmult = fparams[3];
    p.onemfast_backmult = fparams[4];
    p.hang_backmult = fparams[5];
    p.onemhang_backmult = fparams[6];
    p.hang_decay_mult = fparams[7];
    p.out_target = fparams[8];
    p.min_volts = fparams[9];
    p.slope_constant = fparams[10];
    p.inv_max_input = fparams[11];
    p.hang_level = fparams[12];
    p.pop_ratio = fparams[13];
    p.hang_counter_init = hang_counter_init;
    p.hang_enable = hang_enable;
    return p;
}

}  // namespace

extern "C" int t41x_agc_block(
    const void* x, const void* ring, const void* abs_ring, const void* v,
    const void* sv, const void* fb, const void* hb, const void* hc,
    const void* dt, const void* st, int channels, int n, int b,
    const float* fparams, int hang_counter_init, int hang_enable, void* y,
    void* v_out, void* sv_out, void* fb_out, void* hb_out, void* hc_out,
    void* dt_out, void* st_out, void* stream)
{
    if (channels <= 0) return 0;
    const AgcP p = make_params(fparams, hang_counter_init, hang_enable);
    const size_t smem = (size_t)(b + 2 * n) * PITCH * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            agc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (channels + CB - 1) / CB;
    agc_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const float2*)x, (const float2*)ring, (const float*)abs_ring,
        (const float*)v, (const float*)sv, (const float*)fb, (const float*)hb,
        (const int*)hc, (const int*)dt, (const int*)st, channels, n, b, p,
        (float2*)y, (float*)v_out, (float*)sv_out, (float*)fb_out,
        (float*)hb_out, (int*)hc_out, (int*)dt_out, (int*)st_out);
    return (int)cudaGetLastError();
}

extern "C" int t41x_agc_scan(
    const void* rm, const void* ao, const void* v, const void* sv,
    const void* fb, const void* hb, const void* hc, const void* dt,
    const void* st, int channels, int n, const float* fparams,
    int hang_counter_init, int hang_enable, void* vseq, void* v_out,
    void* sv_out, void* fb_out, void* hb_out, void* hc_out, void* dt_out,
    void* st_out, void* stream)
{
    if (channels <= 0) return 0;
    const AgcP p = make_params(fparams, hang_counter_init, hang_enable);
    const int blocks = (channels + SCAN_THREADS - 1) / SCAN_THREADS;
    agc_scan_kernel<<<blocks, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rm, (const float*)ao, (const float*)v, (const float*)sv,
        (const float*)fb, (const float*)hb, (const int*)hc, (const int*)dt,
        (const int*)st, channels, n, p, (float*)vseq, (float*)v_out,
        (float*)sv_out, (float*)fb_out, (float*)hb_out, (int*)hc_out,
        (int*)dt_out, (int*)st_out);
    return (int)cudaGetLastError();
}
