// K2: one whole AGC block; K5: the gain recurrence alone.
//
// K2 replaces the TPU kernel t41x/kernels/agc_pallas.py, _block_kernel
// (agc_block_pallas): |x|, the look-ahead delay line, the sliding-window
// peak over it, the 5-state WDSP gain recurrence (t41x.dsp.agc.agc_step,
// branch for branch), the log-domain gain curve and the delayed multiply.
// It also writes the new delay line and its magnitudes.
//
// K5 replaces t41x/kernels/agc_pallas.py, _kernel (agc_scan_pallas): the
// same per-sample step (agc_step below, shared with K2) over precomputed
// ring-max and |out| streams, for AGC blocks shorter than the delay
// line; the prework and the gain curve stay in torch around it.
//
// What bounds both on the card is not their bytes (2 MB for K2, 0.8 MB
// for K5 at 1024 channels: under 1 us) but the serial chain of one
// agc_step per sample and channel, whatever the channel count.  So the
// design keeps everything else off that chain:
//
// * Staging.  Every global load a thread makes is issued before the
//   first is used (16-byte loads or cp.async, several a thread in flight),
//   so a block pays one memory latency, not one a step or an element.
//   A 2-D thread layout (K2: a warp per channel) needs no division.
// * K2's window peak: max over a width-b window as a doubling table
//   (widths 2, 4, ... up to the largest power of two s <= b) and one
//   max of two overlapping width-s windows, as the TPU kernel does:
//   log2(b) parallel passes over the block's (time, channel) tile instead
//   of a b-deep dependent chain per output.  Any order of max is exact.
// * The serial loop runs agc_step alone, one lane per channel, from
//   shared memory, with the next U steps' operands loaded while the
//   current U run; it writes only volts.  agc_step forms the three
//   candidate volts (attack, fast decay, the rest) side by side and
//   selects among them with selp, never a branch.
// * K2's gain curve (log10f, IEEE division) runs afterwards over all
//   (sample, channel) pairs with all threads, fused with the delayed
//   multiply.
// * 8 channels a block for both, so 1024 channels fill 128 of the
//   H100's 132 SMs (4, 16 and 32 measured: K5 within 2%, K2 at 16 and 32
//   3% and 11% slower).
//
// On an H100 at 1024 channels the steps still take most of the time:
// ~12 of K2's ~19 us (256 steps) and ~3.5 of K5's ~5 (64 steps).
//
// Every multiply and add of the recurrence and the gain curve is rounded
// on its own (__fmul_rn/__fadd_rn, no contraction into FMA), as the plain
// torch version rounds it, so branch decisions and outputs match bit for
// bit.  Layouts: K2 keeps a block's CB channels time-major in shared
// memory with an odd row pitch (conflict-free for the serial lanes and
// the flat passes); K5's inputs are time-major in device memory already.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CB = 8;             // K2: channels per thread block
constexpr int PITCH = CB + 1;     // K2: shared-memory row pitch (odd)
constexpr int THREADS = 32 * CB;  // K2: a warp per channel
constexpr int R = 6;              // K2: loads a lane keeps in flight (6 x 32
                                  // covers 256 samples' pairs and the ring)
constexpr int U = 8;              // steps whose operands are loaded ahead

constexpr int SCAN_CB = 8;        // K5: channels per thread block
constexpr int SCAN_THREADS = 128;
constexpr int SCAN_NT = 256;      // K5: steps staged in shared memory at once

struct AgcP {
    float attack_mult, decay_mult, fast_decay_mult, fast_backmult,
        onemfast_backmult, hang_backmult, onemhang_backmult, hang_decay_mult,
        out_target, min_volts, slope_constant, inv_max_input, hang_level,
        pop_ratio;
    int hang_counter_init, hang_enable;
};

struct Carry {
    float volts, sv, fb, hb;
    int hc, dt, st;
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

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// c ? a : b as one select instruction (PTX selp), opaque to the
// compiler, which turned a chain of C++ conditionals on the state into a
// switch of branches (~180 cycles a step on the H100).
__device__ __forceinline__ float fsel(bool c, float a, float b)
{
    float r;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
        "selp.f32 %0, %1, %2, q;\n\t}"
        : "=f"(r) : "f"(a), "f"(b), "r"((int)c));
    return r;
}

__device__ __forceinline__ int isel(bool c, int a, int b)
{
    int r;
    asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\t"
        "selp.b32 %0, %1, %2, q;\n\t}"
        : "=r"(r) : "r"(a), "r"(b), "r"((int)c));
    return r;
}

// One sample of the 5-state attack/decay/hang machine
// (t41x.dsp.agc.agc_step), states 0-4.  rm is the window peak ending at
// this step's newest sample, ao the delayed |sample|.  Every branch moves
// volts by (rm - volts) times a multiplier or holds it, and the
// branches fall into three classes: attack (any state), a fast decay
// (state 0 or 1 above its threshold), and the rest, whose multiplier
// (0 to hold; state 3's is scaled by a further 0.05) and next state
// depend on the state and the counters only.  So the three new volts are
// formed side by side and two selects follow, with no branch.  A hold
// adds (diff * 0) * 1 = +-0 to volts > 0, which is volts; each other
// product and sum is the one the branch forms, rounded alike.  Its ~42
// instructions bound it, not its dependent path: on an H100 one warp
// takes ~90 cycles a step (a form that planned the next step's release
// off the volts chain needed ~60 instructions and ~110 cycles).
__device__ __forceinline__ void agc_step(const AgcP& p, float rm, float ao,
                                         Carry& s)
{
    const float volts = s.volts;
    const int st = s.st;
    const bool is0 = st == 0, is1 = st == 1, is3 = st == 3;
    const float fast_back = add(mul(p.fast_backmult, ao),
                                mul(p.onemfast_backmult, s.fb));
    const float hang_back = add(mul(p.hang_backmult, ao),
                                mul(p.onemhang_backmult, s.hb));
    const int hcm = max(s.hc - 1, 0);

    // the slow release, off the volts chain: state 0 holds on a strong
    // hang average, 1 and 2 while the hang counter runs; state 0, 1 with
    // decay type 0, and 3 decay at decay_mult, the others at hang_decay
    const bool s0_hang = (p.hang_enable == 1) & (hang_back > p.hang_level);
    const bool hold = (is0 & s0_hang) | ((is1 | (st == 2)) & (hcm > 0));
    const bool use_dm = is0 | (is1 & (s.dt == 0)) | is3;
    const float m_slow = fsel(hold, 0.f, fsel(use_dm, p.decay_mult,
                                               p.hang_decay_mult));
    const int st_slow = isel(hold, 2, isel(use_dm, 3, 4));

    const float diff = __fsub_rn(rm, volts);
    const bool attack = rm >= volts;
    const bool s0_fast = volts > mul(p.pop_ratio, fast_back);
    const bool fast = (is0 & s0_fast) | (is1 & (volts > s.sv));
    const float v_att = add(volts, mul(diff, p.attack_mult));
    const float v_fast = add(volts, mul(diff, p.fast_decay_mult));
    const float v_slow = add(volts, mul(mul(diff, m_slow),
                                        fsel(is3, 0.05f, 1.f)));
    const float nv = fsel(attack, v_att, fsel(fast, v_fast, v_slow));

    s.sv = fsel(attack & (st >= 2), volts, s.sv);
    // state 0 entering hang sets the counter and decay type 1; decaying
    // from it, type 0
    const bool s0_rel = !attack & is0 & !s0_fast;
    s.hc = isel(s0_rel & s0_hang, p.hang_counter_init, hcm);
    s.dt = isel(s0_rel, isel(s0_hang, 1, 0), s.dt);
    s.st = isel(attack, 0, isel(fast, 1, st_slow));
    s.volts = fmaxf(nv, p.min_volts);
    s.fb = fast_back;
    s.hb = hang_back;
}

// One channel's recurrence over n steps from shared memory: rm[t * pitch]
// and ao[t * pitch] in, volts to vo[t * pitch].  The next U steps'
// operands are loaded while the current U steps run.
__device__ __forceinline__ void run_steps(const AgcP& p,
                                          const float* rm, const float* ao,
                                          float* vo, int pitch, int n,
                                          Carry& s)
{
    float r[U], a[U];
    if (n >= U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            r[u] = rm[u * pitch];
            a[u] = ao[u * pitch];
        }
    }
    int t = 0;
    for (; t + U <= n; t += U) {
        float rc[U], ac[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            rc[u] = r[u];
            ac[u] = a[u];
        }
        if (t + 2 * U <= n) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
                r[u] = rm[(t + U + u) * pitch];
                a[u] = ao[(t + U + u) * pitch];
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            agc_step(p, rc[u], ac[u], s);
            vo[(t + u) * pitch] = s.volts;
        }
    }
    for (; t < n; ++t) {
        agc_step(p, rm[t * pitch], ao[t * pitch], s);
        vo[t * pitch] = s.volts;
    }
}

// K2's window-peak pass: dst[f] = max(src[f + o1], src[f + o2]) for f in
// [lo, hi), THREADS apart; each thread loads P pairs before it stores
// one (src and dst may not alias, which the compiler cannot know).
constexpr int P = 4;
__device__ __forceinline__ void max_pairs(float* dst, const float* src,
                                          int o1, int o2, int lo, int hi,
                                          int tid)
{
    for (int f0 = lo + tid; f0 < hi; f0 += P * THREADS) {
        float a[P], c[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int f = f0 + i * THREADS;
            if (f < hi) {
                a[i] = src[f + o1];
                c[i] = src[f + o2];
            }
        }
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const int f = f0 + i * THREADS;
            if (f < hi) dst[f] = fmaxf(a[i], c[i]);
        }
    }
}

// log-domain gain multiplier (DSP_Fn.cpp:623-627)
__device__ __forceinline__ float gain_curve(const AgcP& p, float volts)
{
    const float lg = fminf(0.f, log10f(mul(p.inv_max_input, volts)));
    return __fdiv_rn(__fsub_rn(p.out_target, mul(p.slope_constant, lg)),
                     volts);
}

// V complex samples (V = 2: one 16-byte access) and V floats
template <int V> struct CVec;
template <> struct CVec<1> {
    float2 v[1];
    __device__ __forceinline__ void load(const float2* p) { v[0] = *p; }
    __device__ __forceinline__ void store(float2* p) const { *p = v[0]; }
};
template <> struct CVec<2> {
    float2 v[2];
    __device__ __forceinline__ void load(const float2* p)
    {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = make_float2(q.x, q.y);
        v[1] = make_float2(q.z, q.w);
    }
    __device__ __forceinline__ void store(float2* p) const
    {
        *reinterpret_cast<float4*>(p) = make_float4(v[0].x, v[0].y, v[1].x,
                                                    v[1].y);
    }
};
template <int V> struct FVec;
template <> struct FVec<1> {
    float v[1];
    __device__ __forceinline__ void load(const float* p) { v[0] = *p; }
    __device__ __forceinline__ void store(float* p) const { *p = v[0]; }
};
template <> struct FVec<2> {
    float v[2];
    __device__ __forceinline__ void load(const float* p)
    {
        const float2 q = *reinterpret_cast<const float2*>(p);
        v[0] = q.x;
        v[1] = q.y;
    }
    __device__ __forceinline__ void store(float* p) const
    {
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    }
};

// K2.  V = 2 when n and b are even and the rows 16-byte aligned (pairs of
// samples a load), else 1.  STAMPS: thread 0 writes the block's clock64
// cycles per phase (staging, window peak, recurrence, gain curve and
// output), its total cycles and its nanoseconds to stamps[block * 6 ..].
template <int V, bool STAMPS>
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
           float2* __restrict__ ring_out,        // (C, b) x[:, n-b:]
           float* __restrict__ abs_ring_out,     // (C, b) its magnitudes
           float* __restrict__ v_out, float* __restrict__ sv_out,
           float* __restrict__ fb_out, float* __restrict__ hb_out,
           int* __restrict__ hc_out, int* __restrict__ dt_out,
           int* __restrict__ st_out, long long* __restrict__ stamps)
{
    extern __shared__ float sm[];
    const int L = b + n;
    float* sabs = sm;                // (L, PITCH) |[ring | x]|, time-major
    float* tab1 = sm + L * PITCH;    // (L, PITCH) doubling tables,
    float* tab2 = tab1 + L * PITCH;  // in turns; then ring max and volts
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int c0 = blockIdx.x * CB;
    const int nc = min(CB, channels - c0);  // ragged last block: mask
    long long clk[5], ns0 = 0;
    if (STAMPS && tid == 0) {
        clk[0] = clock_now();
        ns0 = ns_now();
    }

    // the serial lanes' states, loaded first: their latency hides under (a)
    Carry s;
    if (tid < nc) {
        const int c = c0 + tid;
        s = Carry{v_in[c], sv_in[c], fb_in[c], hb_in[c], hc_in[c], dt_in[c],
                  st_in[c]};
    }

    // (a) staging, a warp per channel: |ring| and |x| into sabs, and the
    // new delay line x[n-b:] with its magnitudes out.  Each lane issues
    // its R loads, then uses them.
    if (w < nc) {
        const size_t c = c0 + w;
        const int gb = b / V, g_all = (b + n) / V;
        for (int g0 = lane; g0 < g_all; g0 += 32 * R) {
            FVec<V> ar[R];
            CVec<V> xv[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int g = g0 + 32 * r;
                if (g < gb)
                    ar[r].load(abs_ring + c * b + g * V);
                else if (g < g_all)
                    xv[r].load(x + c * n + (g * V - b));
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int g = g0 + 32 * r, t = g * V;
                if (g < gb) {
#pragma unroll
                    for (int i = 0; i < V; ++i)
                        sabs[(t + i) * PITCH + w] = ar[r].v[i];
                } else if (g < g_all) {
                    FVec<V> h;
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        h.v[i] = hypotf(xv[r].v[i].x, xv[r].v[i].y);
                        sabs[(t + i) * PITCH + w] = h.v[i];
                    }
                    if (t >= n) {  // the newest b samples: the next ring
                        xv[r].store(ring_out + c * b + (t - n));
                        h.store(abs_ring_out + c * b + (t - n));
                    }
                }
            }
        }
    }
    __syncthreads();
    if (STAMPS && tid == 0) clk[1] = clock_now();

    // (b) ring_max[t] = max(|full|[t+1 .. t+b]): width-2w tables from
    // width-w ones, over the flat (time, channel) tile
    const float* src = sabs;
    float* dst = tab1;
    int width = 1;
    while (2 * width <= b) {
        max_pairs(dst, src, 0, width * PITCH, PITCH,
                  (L - 2 * width + 1) * PITCH, tid);
        __syncthreads();
        src = dst;
        dst = dst == tab1 ? tab2 : tab1;
        width *= 2;
    }
    float* srm = dst;                        // (n, PITCH) ring max
    float* svo = dst == tab1 ? tab2 : tab1;  // (n, PITCH) volts
    max_pairs(srm, src, PITCH, (1 + b - width) * PITCH, 0, n * PITCH, tid);
    __syncthreads();
    if (STAMPS && tid == 0) clk[2] = clock_now();

    // (c) the recurrence: a lane per channel, agc_step alone
    if (tid < nc) {
        run_steps(p, srm + tid, sabs + tid, svo + tid, PITCH, n, s);
        const int c = c0 + tid;
        v_out[c] = s.volts;
        sv_out[c] = s.sv;
        fb_out[c] = s.fb;
        hb_out[c] = s.hb;
        hc_out[c] = s.hc;
        dt_out[c] = s.dt;
        st_out[c] = s.st;
    }
    __syncthreads();
    if (STAMPS && tid == 0) clk[3] = clock_now();

    // (d) gain curve and delayed output, a warp per channel:
    // y[t] = full[t] * gain_curve(volts[t]), full = [ring | x]
    if (w < nc) {
        const size_t c = c0 + w;
        const int gn = n / V;
        for (int g0 = lane; g0 < gn; g0 += 32 * R) {
            CVec<V> d[R];
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int t = (g0 + 32 * r) * V;
                if (t < n)
                    d[r].load(t < b ? ring + c * b + t : x + c * n + (t - b));
            }
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int t = (g0 + 32 * r) * V;
                if (t < n) {
#pragma unroll
                    for (int i = 0; i < V; ++i) {
                        const float m = gain_curve(p, svo[(t + i) * PITCH + w]);
                        d[r].v[i] = make_float2(d[r].v[i].x * m,
                                                d[r].v[i].y * m);
                    }
                    d[r].store(y + c * n + t);
                }
            }
        }
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

// K5.  A block stages its (steps, SCAN_CB) tiles of rm and ao with every
// copy in flight (cp.async, 16 bytes a copy when the channel count is a
// multiple of 4 and the rows aligned: VEC), runs the recurrence from
// shared memory, a lane per channel, writes volts to shared memory and
// stores them coalesced; SCAN_NT steps at a time.  STAMPS: thread 0
// writes cycles of staging, recurrence and store, total cycles and
// nanoseconds to stamps[block * 5 ..].
template <bool VEC, bool STAMPS>
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
                int* __restrict__ st_out, long long* __restrict__ stamps)
{
    __shared__ __align__(16) float srm[SCAN_NT * SCAN_CB];
    __shared__ __align__(16) float sao[SCAN_NT * SCAN_CB];
    __shared__ __align__(16) float svo[SCAN_NT * SCAN_CB];
    constexpr int Q = SCAN_CB / 4;  // 16-byte pieces a row
    const int tid = threadIdx.x;
    const int c0 = blockIdx.x * SCAN_CB;
    const int nc = min(SCAN_CB, channels - c0);
    long long cyc[3] = {0, 0, 0}, t_all = 0, ns0 = 0, t_mark = 0;
    if (STAMPS && tid == 0) {
        t_all = t_mark = clock_now();
        ns0 = ns_now();
    }

    Carry s;
    if (tid < nc) {
        const int c = c0 + tid;
        s = Carry{v_in[c], sv_in[c], fb_in[c], hb_in[c], hc_in[c], dt_in[c],
                  st_in[c]};
    }

    for (int t0 = 0; t0 < n; t0 += SCAN_NT) {
        const int nt = min(SCAN_NT, n - t0);
        if (VEC) {
            for (int f = tid; f < nt * Q; f += SCAN_THREADS) {
                const int t = f / Q, q = f % Q;
                if (4 * q < nc) {
                    const size_t gi = (size_t)(t0 + t) * channels + c0 + 4 * q;
                    cp_async16(srm + t * SCAN_CB + 4 * q, rm + gi);
                    cp_async16(sao + t * SCAN_CB + 4 * q, ao + gi);
                }
            }
        } else {
            for (int f = tid; f < nt * SCAN_CB; f += SCAN_THREADS) {
                const int t = f / SCAN_CB, cl = f % SCAN_CB;
                if (cl < nc) {
                    const size_t gi = (size_t)(t0 + t) * channels + c0 + cl;
                    cp_async4(srm + f, rm + gi);
                    cp_async4(sao + f, ao + gi);
                }
            }
        }
        cp_async_wait_all();
        __syncthreads();
        if (STAMPS && tid == 0) {
            const long long now = clock_now();
            cyc[0] += now - t_mark;
            t_mark = now;
        }

        if (tid < nc)
            run_steps(p, srm + tid, sao + tid, svo + tid, SCAN_CB, nt, s);
        __syncthreads();
        if (STAMPS && tid == 0) {
            const long long now = clock_now();
            cyc[1] += now - t_mark;
            t_mark = now;
        }

        if (VEC) {
            for (int f = tid; f < nt * Q; f += SCAN_THREADS) {
                const int t = f / Q, q = f % Q;
                if (4 * q < nc)
                    *reinterpret_cast<float4*>(
                        vseq + (size_t)(t0 + t) * channels + c0 + 4 * q) =
                        *reinterpret_cast<const float4*>(
                            svo + t * SCAN_CB + 4 * q);
            }
        } else {
            for (int f = tid; f < nt * SCAN_CB; f += SCAN_THREADS) {
                const int t = f / SCAN_CB, cl = f % SCAN_CB;
                if (cl < nc)
                    vseq[(size_t)(t0 + t) * channels + c0 + cl] = svo[f];
            }
        }
        __syncthreads();  // the next steps' staging reuses the tiles
        if (STAMPS && tid == 0) {
            const long long now = clock_now();
            cyc[2] += now - t_mark;
            t_mark = now;
        }
    }

    if (tid < nc) {
        const int c = c0 + tid;
        v_out[c] = s.volts;
        sv_out[c] = s.sv;
        fb_out[c] = s.fb;
        hb_out[c] = s.hb;
        hc_out[c] = s.hc;
        dt_out[c] = s.dt;
        st_out[c] = s.st;
    }
    if (STAMPS && tid == 0) {
        long long* o = stamps + blockIdx.x * 5;
        o[0] = cyc[0];
        o[1] = cyc[1];
        o[2] = cyc[2];
        o[3] = clock_now() - t_all;
        o[4] = ns_now() - ns0;
    }
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

bool aligned(const void* ptr, uintptr_t bytes)
{
    return ((uintptr_t)ptr & (bytes - 1)) == 0;
}

template <int V, bool STAMPS>
int launch_block(const void* x, const void* ring, const void* abs_ring,
                 const void* const* states, int channels, int n, int b,
                 const AgcP& p, void* y, void* ring_out, void* abs_ring_out,
                 void* const* outs, void* stamps, void* stream)
{
    const size_t smem = (size_t)3 * (b + n) * PITCH * sizeof(float);
    auto kernel = agc_kernel<V, STAMPS>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int blocks = (channels + CB - 1) / CB;
    kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
        (const float2*)x, (const float2*)ring, (const float*)abs_ring,
        (const float*)states[0], (const float*)states[1],
        (const float*)states[2], (const float*)states[3],
        (const int*)states[4], (const int*)states[5], (const int*)states[6],
        channels, n, b, p, (float2*)y, (float2*)ring_out,
        (float*)abs_ring_out, (float*)outs[0], (float*)outs[1],
        (float*)outs[2], (float*)outs[3], (int*)outs[4], (int*)outs[5],
        (int*)outs[6], (long long*)stamps);
    return (int)cudaGetLastError();
}

template <bool STAMPS>
int agc_block(const void* x, const void* ring, const void* abs_ring,
              const void* const* states, int channels, int n, int b,
              const float* fparams, int hang_counter_init, int hang_enable,
              void* y, void* ring_out, void* abs_ring_out, void* const* outs,
              void* stamps, void* stream)
{
    if (channels <= 0) return 0;
    const AgcP p = make_params(fparams, hang_counter_init, hang_enable);
    const bool pairs = n % 2 == 0 && b % 2 == 0 && aligned(x, 16)
        && aligned(ring, 16) && aligned(y, 16) && aligned(ring_out, 16)
        && aligned(abs_ring, 8) && aligned(abs_ring_out, 8);
    return pairs
        ? launch_block<2, STAMPS>(x, ring, abs_ring, states, channels, n, b,
                                  p, y, ring_out, abs_ring_out, outs, stamps,
                                  stream)
        : launch_block<1, STAMPS>(x, ring, abs_ring, states, channels, n, b,
                                  p, y, ring_out, abs_ring_out, outs, stamps,
                                  stream);
}

template <bool STAMPS>
int agc_scan(const void* rm, const void* ao, const void* const* states,
             int channels, int n, const float* fparams,
             int hang_counter_init, int hang_enable, void* vseq,
             void* const* outs, void* stamps, void* stream)
{
    if (channels <= 0) return 0;
    const AgcP p = make_params(fparams, hang_counter_init, hang_enable);
    const bool vec = channels % 4 == 0 && aligned(rm, 16) && aligned(ao, 16)
        && aligned(vseq, 16);
    auto kernel = vec ? agc_scan_kernel<true, STAMPS>
                      : agc_scan_kernel<false, STAMPS>;
    const int blocks = (channels + SCAN_CB - 1) / SCAN_CB;
    kernel<<<blocks, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)rm, (const float*)ao, (const float*)states[0],
        (const float*)states[1], (const float*)states[2],
        (const float*)states[3], (const int*)states[4], (const int*)states[5],
        (const int*)states[6], channels, n, p, (float*)vseq, (float*)outs[0],
        (float*)outs[1], (float*)outs[2], (float*)outs[3], (int*)outs[4],
        (int*)outs[5], (int*)outs[6], (long long*)stamps);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int t41x_agc_block(
    const void* x, const void* ring, const void* abs_ring, const void* v,
    const void* sv, const void* fb, const void* hb, const void* hc,
    const void* dt, const void* st, int channels, int n, int b,
    const float* fparams, int hang_counter_init, int hang_enable, void* y,
    void* ring_out, void* abs_ring_out, void* v_out, void* sv_out,
    void* fb_out, void* hb_out, void* hc_out, void* dt_out, void* st_out,
    void* stream)
{
    const void* states[7] = {v, sv, fb, hb, hc, dt, st};
    void* outs[7] = {v_out, sv_out, fb_out, hb_out, hc_out, dt_out, st_out};
    return agc_block<false>(x, ring, abs_ring, states, channels, n, b,
                            fparams, hang_counter_init, hang_enable, y,
                            ring_out, abs_ring_out, outs, nullptr, stream);
}

// t41x_agc_block with the phase split: stamps (blocks, 6) int64
extern "C" int t41x_agc_block_phases(
    const void* x, const void* ring, const void* abs_ring, const void* v,
    const void* sv, const void* fb, const void* hb, const void* hc,
    const void* dt, const void* st, int channels, int n, int b,
    const float* fparams, int hang_counter_init, int hang_enable, void* y,
    void* ring_out, void* abs_ring_out, void* v_out, void* sv_out,
    void* fb_out, void* hb_out, void* hc_out, void* dt_out, void* st_out,
    void* stamps, void* stream)
{
    const void* states[7] = {v, sv, fb, hb, hc, dt, st};
    void* outs[7] = {v_out, sv_out, fb_out, hb_out, hc_out, dt_out, st_out};
    return agc_block<true>(x, ring, abs_ring, states, channels, n, b,
                           fparams, hang_counter_init, hang_enable, y,
                           ring_out, abs_ring_out, outs, stamps, stream);
}

extern "C" int t41x_agc_scan(
    const void* rm, const void* ao, const void* v, const void* sv,
    const void* fb, const void* hb, const void* hc, const void* dt,
    const void* st, int channels, int n, const float* fparams,
    int hang_counter_init, int hang_enable, void* vseq, void* v_out,
    void* sv_out, void* fb_out, void* hb_out, void* hc_out, void* dt_out,
    void* st_out, void* stream)
{
    const void* states[7] = {v, sv, fb, hb, hc, dt, st};
    void* outs[7] = {v_out, sv_out, fb_out, hb_out, hc_out, dt_out, st_out};
    return agc_scan<false>(rm, ao, states, channels, n, fparams,
                           hang_counter_init, hang_enable, vseq, outs,
                           nullptr, stream);
}

// t41x_agc_scan with the phase split: stamps (blocks, 5) int64
extern "C" int t41x_agc_scan_phases(
    const void* rm, const void* ao, const void* v, const void* sv,
    const void* fb, const void* hb, const void* hc, const void* dt,
    const void* st, int channels, int n, const float* fparams,
    int hang_counter_init, int hang_enable, void* vseq, void* v_out,
    void* sv_out, void* fb_out, void* hb_out, void* hc_out, void* dt_out,
    void* st_out, void* stamps, void* stream)
{
    const void* states[7] = {v, sv, fb, hb, hc, dt, st};
    void* outs[7] = {v_out, sv_out, fb_out, hb_out, hc_out, dt_out, st_out};
    return agc_scan<true>(rm, ao, states, channels, n, fparams,
                          hang_counter_init, hang_enable, vseq, outs, stamps,
                          stream);
}
