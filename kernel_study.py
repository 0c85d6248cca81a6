#!/usr/bin/env python3
"""Measurements for designing a kernel on the card: its SASS, the phase
split of the original K3, and variants of K3's thread shape.

    python3 kernel_study.py sass SOURCE.cu [...]     (needs nvcc)
    python3 kernel_study.py k3-split                 (needs a card)
    python3 kernel_study.py k3-variants ROOT         (needs a card)
    python3 kernel_study.py profiler-loss            (needs a card)
    python3 kernel_study.py e1-s1 ROOT               (needs a card)
    python3 kernel_study.py n1 ROOT [SASS_DIR]       (needs a card)
    python3 kernel_study.py n1-shapes ROOT           (needs a card)

`sass` compiles each CUDA source with the flags of
`t41x_torch/kernels/_build.py` and prints, for every kernel in it, its
instruction count, its most frequent opcodes and the widths of its
global stores (`cuobjdump -sass`).

`k3-split` runs the original K3 (the first port of the TPU kernel, a
256-thread block a channel with its taps and inputs in shared memory,
kept below with `clock64` stamps) at 1024 channels and prints its split per phase, cold (L2 flushed) and warm:
staging, stage 1, stage 2 and its store; and once more with the store
replaced by a register sum, which leaves stage 2's compute alone.

`k3-variants` builds ROOT's K3 at other thread shapes (R input samples
a thread in stage 1 x W warps a channel; a text substitution of the
two constants) and times each, and the tree's own, by CUDA events with
L2 flushed before each launch, in three rounds of alternating order, on
the chain's input (the real part of a complex64 block), with an empty
kernel's time for the events' own overhead.  Every variant is first
held against the plain version bit for bit.

`e1-s1` builds ROOT's kernels (printing ptxas' registers and spills)
and runs ROOT's E1 at 1024 x 256 and 1 x 256 from a random state, and
S1 at 2 and 16 hops at 1024 channels on audio like `chip_smoke.py`
phase 2's (noise at a level of each channel's own, a keyed 700 Hz tone,
every 8th channel silent) past 12 blocks of history: each against its
plain version (E1's SNR; S1's NN choices by `parity.nr_decisions`, its
states bit for bit), its stamped variant against it bit for bit, its
device µs (L2 flushed) and its `clock64` split cold and warm, where
ROOT's wrappers have a stamped variant.

`n1` builds ROOT's kernels (printing ptxas' registers and spills),
prints the SASS summary of ROOT's `nb.cu` (and, with SASS_DIR, writes
its whole listing there as `n1_<ROOT's name>.sass`, where the
predictors' loop can be read), and runs ROOT's N1 on `chip_smoke.py`'s
tone and crowded stimuli (`chip_smoke.nb_stimulus`) at 1024 x 256 and
4096 x 256: each against the plain version (`parity.nb_decisions`),
the stamped variant against it bit for bit, its device µs (L2 flushed)
and its `clock64` split cold and warm with the predictors' cycles a
blanked sample, the frames' duration (median, p99, max: a launch lasts
as long as its slowest frame); then stagebench's `pallas` and
`pallas_nb` variants (a graphed block at 1024 channels without and with
the noise blanker, ROOT's tools) in `chip_smoke.NB_ADD_ROUNDS` rounds in
turns, and the blanker's add with its spread.

`n1-shapes` builds ROOT's N1 with 2, 4 and 8 frames a block (a text
substitution of WARPS) beside the tree's library and times each by CUDA
events, L2 flushed before each launch, in three rounds of alternating
order, on `chip_smoke.nb_stimulus`'s tone and crowded frames at 1024 x
256, each first held against the tree's own N1 bit for bit.

`profiler-loss` runs the whole `chip_smoke.py` and, after each of its
profiler measurements, profiles the same calls once more without the
leading spin kernels, and prints how many of the session's recorded
launches (runtime calls) have no device record, and whether those are
the session's first launches.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_CH, N = 1024, 256
SHAPES = ((4, 2), (8, 1), (2, 2), (2, 8), (4, 4))  # (R, W) besides the tree's

# the original K3 with clock64 stamps: stamps[block] = (staging, stage 1, stage
# 2 and store, total cycles, nanoseconds); STORE false replaces the y
# store by a register sum
ORIGINAL_K3 = r"""
#include <cuda_runtime.h>
namespace {
constexpr int THREADS = 256;
__device__ __forceinline__ long long clock_now()
{ long long t; asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory"); return t; }
__device__ __forceinline__ long long ns_now()
{ long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory"); return t; }
template <bool STORE>
__global__ void __launch_bounds__(THREADS)
interp_kernel(const float* __restrict__ audio, const float* __restrict__ int1,
              const float* __restrict__ int2, const float* __restrict__ vol,
              const float* __restrict__ hp1, const float* __restrict__ hp2,
              int n, int sub1, int L1, int sub2, int L2,
              float* __restrict__ y, float* __restrict__ nint2,
              long long* __restrict__ stamps)
{
    extern __shared__ float sm[];
    const int c = blockIdx.x;
    const int tid = threadIdx.x;
    long long k0 = 0, k1 = 0, k2 = 0, ns0 = 0;
    if (tid == 0) { k0 = clock_now(); ns0 = ns_now(); }
    const int n1 = n * L1, n2 = n1 * L2;
    float* xc1 = sm;
    float* xc2 = xc1 + (sub1 - 1 + n);
    float* h1 = xc2 + (sub2 - 1 + n1);
    float* h2 = h1 + sub1 * L1;
    for (int i = tid; i < sub1 - 1; i += THREADS)
        xc1[i] = int1[(size_t)c * (sub1 - 1) + i];
    for (int i = tid; i < n; i += THREADS)
        xc1[sub1 - 1 + i] = audio[(size_t)c * n + i];
    for (int i = tid; i < sub2 - 1; i += THREADS)
        xc2[i] = int2[(size_t)c * (sub2 - 1) + i];
    for (int i = tid; i < sub1 * L1; i += THREADS) h1[i] = hp1[i];
    for (int i = tid; i < sub2 * L2; i += THREADS) h2[i] = hp2[i];
    __syncthreads();
    if (tid == 0) k1 = clock_now();
    for (int o = tid; o < n1; o += THREADS) {
        const int m = o / L1, p = o % L1;
        float acc = 0.f;
        for (int j = 0; j < sub1; ++j) acc += h1[j * L1 + p] * xc1[m + j];
        xc2[sub2 - 1 + o] = acc;
    }
    __syncthreads();
    if (tid == 0) k2 = clock_now();
    for (int i = tid; i < sub2 - 1; i += THREADS)
        nint2[(size_t)c * (sub2 - 1) + i] = xc2[n1 + i];
    const float v = vol[c];
    float sink = 0.f;
    for (int o = tid; o < n2; o += THREADS) {
        const int m = o / L2, p = o % L2;
        float acc = 0.f;
        for (int j = 0; j < sub2; ++j) acc += h2[j * L2 + p] * xc2[m + j];
        if (STORE) y[(size_t)c * n2 + o] = acc * v;
        else sink += acc * v;
    }
    if (!STORE && sink == 1.2345e-30f) y[(size_t)c * n2] = sink;
    __syncthreads();
    if (tid == 0) {
        const long long k3 = clock_now();
        long long* o = stamps + blockIdx.x * 5;
        o[0] = k1 - k0; o[1] = k2 - k1; o[2] = k3 - k2;
        o[3] = k3 - k0; o[4] = ns_now() - ns0;
    }
}
}  // namespace
extern "C" int k3_original_stamped(int store, const void* audio, const void* int1,
    const void* int2, const void* vol, const void* hp1, const void* hp2,
    int channels, int n, int sub1, int L1, int sub2, int L2, void* y,
    void* nint2, void* stamps, void* stream)
{
    const size_t smem = (size_t)(sub1 - 1 + n + sub2 - 1 + n * L1
                                 + sub1 * L1 + sub2 * L2) * sizeof(float);
    if (store)
        interp_kernel<true><<<channels, THREADS, smem, (cudaStream_t)stream>>>(
            (const float*)audio, (const float*)int1, (const float*)int2,
            (const float*)vol, (const float*)hp1, (const float*)hp2, n, sub1,
            L1, sub2, L2, (float*)y, (float*)nint2, (long long*)stamps);
    else
        interp_kernel<false><<<channels, THREADS, smem, (cudaStream_t)stream>>>(
            (const float*)audio, (const float*)int1, (const float*)int2,
            (const float*)vol, (const float*)hp1, (const float*)hp2, n, sub1,
            L1, sub2, L2, (float*)y, (float*)nint2, (long long*)stamps);
    return (int)cudaGetLastError();
}
"""


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def nvcc_so(source: str, name: str) -> ctypes.CDLL:
    """`source` built as its own shared library beside the kernels'."""
    from t41x_torch.kernels import _build
    src = _build.BUILD_DIR / "study" / f"{name}.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(source)
    return ctypes.CDLL(str(_build.build([src], name)))


def sass(sources: list[str], keep: Path | None = None) -> int:
    """Each source's SASS summary; with `keep`, its listing there too."""
    from t41x_torch.kernels import _build
    cuobjdump = str(Path(_build._nvcc()).with_name("cuobjdump"))
    out_dir = _build.BUILD_DIR / "study"
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(sources):
        obj = out_dir / f"sass_{i}_{Path(f).stem}.o"
        subprocess.run([_build._nvcc(), *_build.FLAGS, "-c", "-o", str(obj),
                        f], check=True)
        text = subprocess.run([cuobjdump, "-sass", str(obj)],
                              capture_output=True, text=True,
                              check=True).stdout
        if keep is not None:
            keep.write_text(text)
            print(f"# SASS listing of {f}: {keep}", flush=True)
        for part in re.split(r"\n\s*Function : ", text)[1:]:
            name = part.split("\n", 1)[0].strip()
            ops = Counter(m.group(2).split(".")[0] for m in re.finditer(
                r"\n\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                part))
            stg = sorted(set(re.findall(r"\b(STG\.E(?:\.\d+)?)\b", part)))
            print(f"# SASS {f} {name[:100]}: {sum(ops.values())} "
                  "instructions; "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common(12))
                  + f"; stores {' '.join(stg)}", flush=True)
    return 0


def k3_inputs():
    import torch

    from t41x_torch.chain import ChainSpec, RxChain
    from t41x_torch.kernels import interp as kint
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(3)
    rx = RxChain(ChainSpec(use_kernels=True, spectrum_zoom=0), device=dev)
    fi = kint.FusedInterp(rx.hi1, rx.hi2)
    z = torch.complex(torch.randn(N_CH, N, generator=g, device=dev),
                      torch.randn(N_CH, N, generator=g, device=dev)) * 0.4
    h1 = torch.randn(N_CH, 23, generator=g, device=dev)
    h2 = torch.randn(N_CH, 7, generator=g, device=dev)
    vol = torch.linspace(0.5, 2.0, N_CH, device=dev)
    return fi, z.real, h1, h2, vol


def k3_split() -> int:
    import torch

    import chip_smoke as cs
    from t41x_torch.kernels import _build
    fi, a, h1, h2, vol = k3_inputs()
    a = a.contiguous()  # the original kernel took a contiguous row
    dev = a.device
    lib = nvcc_so(ORIGINAL_K3, "k3_original_stamped")
    f = lib.k3_original_stamped
    P = ctypes.c_void_p
    f.argtypes = [ctypes.c_int] + [P] * 6 + [ctypes.c_int] * 6 + [P] * 4
    f.restype = ctypes.c_int
    hp1, hp2 = (torch.from_numpy(h).to(dev) for h in (fi.hp1, fi.hp2))
    y = torch.empty(N_CH, 8 * N, device=dev)
    n2 = torch.empty(N_CH, 7, device=dev)
    card = card_line()
    for store, names in ((1, ("staging", "stage 1", "stage 2 and store")),
                         (0, ("staging", "stage 1", "stage 2 alone"))):
        def launch():
            stamps = torch.zeros(N_CH, 5, dtype=torch.int64, device=dev)
            rc = f(store, a.data_ptr(), h1.data_ptr(), h2.data_ptr(),
                   vol.data_ptr(), hp1.data_ptr(), hp2.data_ptr(), N_CH, N,
                   24, 2, 8, 4, y.data_ptr(), n2.data_ptr(),
                   stamps.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"k3_original_stamped: CUDA error {rc}")
            return stamps
        if store:
            launch()
            ref = fi.plain(a, h1, h2, vol)[2]
            torch.cuda.synchronize()
            print(f"# the original K3 vs plain: max |err| "
                  f"{float((y - ref).abs().max()):.3g}", flush=True)
        for temp in ("cold", "warm"):
            launch()
            stamps = []
            for _ in range(10):
                if temp == "cold":
                    cs.l2_flush()
                stamps.append(launch())
            sp = _build.phase_split(torch.cat(stamps), names)
            print(f"# the original K3 phases {temp}, us a block: " + ", ".join(
                f"{k} {sp[k]:.3f}" for k in (*names, "block"))
                + f" at {sp['sm_ghz']:.3f} GHz ({N_CH} channels, {card})",
                flush=True)
    return 0


def k3_variants(root: str) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from t41x_torch.kernels import _build, interp as kint
    fi, a, h1, h2, vol = k3_inputs()
    dev = a.device
    ref = fi.plain(a, h1, h2, vol)
    src = Path(root, "t41x_torch", "csrc", "interp.cu").read_text()
    libs = {"tree": _build.library()}
    for r, w in SHAPES:
        v = src.replace("constexpr int R = 2;", f"constexpr int R = {r};") \
            .replace("constexpr int W = 4;", f"constexpr int W = {w};")
        if v == src:
            raise ValueError("interp.cu: R = 2 and W = 4 not found")
        libs[f"R {r} x W {w}"] = nvcc_so(v, f"interp_R{r}W{w}")
    fp = kint._FLOATS

    def launcher(lib):
        fn = lib.t41x_interp
        fn.argtypes, fn.restype = kint._ARGS, ctypes.c_int
        nint1 = torch.empty(N_CH, 23, device=dev)
        nint2 = torch.empty(N_CH, 7, device=dev)
        y = torch.empty(N_CH, 8 * N, device=dev)
        args = (a.data_ptr(), a.stride(0), a.stride(1), h1.data_ptr(),
                h2.data_ptr(), vol.data_ptr(), fi.hp1.ctypes.data_as(fp),
                fi.hp2.ctypes.data_as(fp), 24, 8, N_CH, N, y.data_ptr(),
                nint1.data_ptr(), nint2.data_ptr(),
                torch.cuda.current_stream().cuda_stream)

        def go():
            if fn(*args):
                raise RuntimeError("t41x_interp: launch failed")
            return nint1, nint2, y
        return go

    def cold(fn, reps=60):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            cs.l2_flush()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            ts.append(s.elapsed_time(e) * 1e3)
        return float(np.median(ts))

    card = card_line()
    cands = [(k, launcher(lib)) for k, lib in libs.items()]
    for k, fn in cands:
        out = fn()
        torch.cuda.synchronize()
        if not all(torch.equal(o, r) for o, r in zip(out, ref)):
            raise AssertionError(f"K3 {k}: not bit for bit with plain")
    times = {}
    for order in (cands, cands[::-1], cands):
        for k, fn in order:
            times.setdefault(k, []).append(cold(fn))
    times["empty kernel"] = [cold(lambda: torch.cuda._sleep(0))]
    for k, v in times.items():
        print(f"# K3 {k:12s} events, L2 flushed: "
              + " / ".join(f"{x:.2f}" for x in v)
              + f" us ({N_CH} channels, y.real, {card})", flush=True)
    return 0


def profiler_loss() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    kernel_us = cs.kernel_us
    cpu = torch.autograd.DeviceType.CPU

    def bare_session(body, n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                body()
            torch.cuda.synchronize()
        evs = prof.profiler.kineto_results.events()
        recorded = {e.correlation_id() for e in evs
                    if e.device_type() != cpu}
        launches = [e.correlation_id() for e in evs if e.name().startswith(
            ("cudaLaunch", "cudaMemsetAsync", "cudaMemcpy"))]
        return launches, [i for i, c in enumerate(launches)
                          if c not in recorded]

    def measured(body, n, check=None):
        out = kernel_us(body, n, check)
        launches, missing = bare_session(body, n)
        first = missing == list(range(len(missing)))
        print(f"# profiler-loss: {n} calls without spins, "
              f"{len(launches)} launches recorded, {len(missing)} without "
              f"a device record"
              + (f" ({'the first ones' if first else 'not the first'})"
                 if missing else ""), flush=True)
        return out

    cs.kernel_us = measured
    return cs.main([])


def e1_s1() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from t41x_torch.dsp import eq as teq, nr as tnr
    from t41x_torch.kernels import _build, eq as keq, spectral_nr as kspec
    from t41x_torch.utils import parity

    card = card_line()
    print(f"# e1-s1: {Path(keq.__file__).parents[2]} ({card})", flush=True)
    _build.library(verbose=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    d = teq.EQDesign()
    for ch in (1024, 1):
        lead = (ch,) if ch > 1 else ()
        x = torch.randn(lead + (256,), generator=g, device=dev)
        gains = torch.rand(lead + (14,), generator=g, device=dev)
        st = 0.1 * torch.randn(lead + (14, 2, 2), generator=g, device=dev)
        k = d.apply(st, x, gains, use_kernels=True)
        p = d.apply_plain(st, x, gains)
        torch.cuda.synchronize()
        print(f"# E1 {ch} x 256 vs plain {parity.snr_db(p[1], k[1]):.1f} dB "
              f"(output), {parity.snr_db(p[0], k[0]):.1f} dB (state); "
              f"device {cs.device_us(lambda: d.apply(st, x, gains, True), 'eq'):.2f}"
              f" us ({card})", flush=True)
        if hasattr(keq, "eq_phases"):
            s = keq.eq_phases(d, st, x, gains)
            print(f"# E1 {ch}: stamped bit for bit "
                  f"{torch.equal(k[0], s[0]) and torch.equal(k[1], s[1])}")
            cs.log_phases(f"E1 {ch} x 256",
                          lambda: keq.eq_phases(d, st, x, gains)[2],
                          keq.E1_PHASES, card, n_ch=ch)
    p = tnr.spectral_params(200.0, 3000.0)
    ch, n_blk = 1024, 20
    t = torch.arange(n_blk * 256, device=dev) / 24000.0
    lvl = 10.0 ** (3.0 * torch.rand(ch, 1, generator=g, device=dev) - 3.0)
    keyed = (torch.rand(ch, n_blk, generator=g, device=dev) < 0.5
             ).repeat_interleave(256, dim=-1)
    amp = lvl * torch.tensor([0.0, 1.0, 10.0, 100.0], device=dev)[
        torch.randint(0, 4, (ch, 1), generator=g, device=dev)]
    aud = lvl * torch.randn(ch, t.numel(), generator=g, device=dev) \
        + amp * keyed * torch.sin(2 * np.pi * 700.0 * t)
    aud[4::8] = 0.0
    aud = aud.reshape(ch, n_blk, 256).movedim(1, 0)
    sst = tnr.spectral_state((ch,), dev)
    window = tnr._window(tnr._sqrt_hann, aud)
    _, frames = tnr._hop_frames(sst.last_sample, aud[:12])
    gst = kspec.spectral_gains_plain(
        p, (sst.xt, sst.pslp, sst.hk_old, sst.frames),
        tnr._half_spectra(frames * window)[2])[0]
    for hops in (2, 16):
        _, frames = tnr._hop_frames(aud[11, ..., 128:],
                                    aud[12: 12 + hops // 2])
        pw = tnr._half_spectra(frames * window)[2].contiguous()
        nn_k = torch.empty(pw.shape[:-1], dtype=torch.int32, device=dev)
        k = kspec.spectral_gains(p, gst, pw, nn_k)
        nn_p, margin = tnr.spectral_decision_margin(p, gst, pw)
        pl = kspec.spectral_gains_plain(p, gst, pw)
        torch.cuda.synchronize()
        rep = parity.nr_decisions(k[1], nn_k, pl[1], nn_p, margin)
        exact = all(torch.equal(a, b) for a, b in zip(k[0], pl[0]))
        us = cs.device_us(lambda: kspec.spectral_gains(p, gst, pw),
                          "spectral")
        print(f"# S1 {hops} hops: {rep}; states bit for bit {exact}; "
              f"device {us:.2f} us ({card})", flush=True)
        if hasattr(kspec, "spectral_gains_phases"):
            s = kspec.spectral_gains_phases(p, gst, pw)
            same = all(torch.equal(a, b) for a, b in zip(
                (*k[0], k[1], k[2]), (*s[0], s[1], s[2])))
            print(f"# S1 {hops}: stamped bit for bit {same}")
            cs.log_phases(f"S1 {hops} hops",
                          lambda: kspec.spectral_gains_phases(p, gst, pw)[3],
                          kspec.S1_PHASES, card, "recursion", hops, n_ch=ch)
    return 0


def n1(sass_dir: str | None) -> int:
    import importlib.util

    import torch

    # this tree's chip_smoke (ROOT's may predate nb_stimulus), ROOT's
    # t41x_torch
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    from t41x_torch.dsp import nb as tnb
    from t41x_torch.kernels import _build, nb as knb
    from t41x_torch.utils import parity

    card = card_line()
    root = Path(knb.__file__).parents[2]
    print(f"# n1: {root} ({card})", flush=True)
    _build.library(verbose=True)
    keep = None
    if sass_dir is not None:
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        keep = Path(sass_dir) / f"n1_{root.name}.sass"
    sass([str(_build.SRC_DIR / "nb.cu")], keep)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    failed = []
    for kind in ("tone", "crowded"):
        for frames in (1024, 4096):
            x = cs.nb_stimulus(kind, frames, 256, gen, dev)
            y_k, m_k = knb.launch_with_mask(x)
            y_p = tnb.noise_blanker_plain(x)
            m_p, margin = tnb.decision_margin(x)
            torch.cuda.synchronize()
            rep = parity.nb_decisions(x, y_k, m_k, y_p, m_p, margin)
            same = ~(m_k ^ m_p).any(dim=-1)
            err = float((y_k[same] - y_p[same]).abs().max())
            us = cs.device_us(lambda: tnb.noise_blanker(x), "nb_kernel")
            print(f"# N1 {kind} {frames} x 256: {rep}; max |err| on equal "
                  f"masks {err:.3g}; device {us:.2f} us ({card})",
                  flush=True)
            stamped = torch.equal(knb.nb_phases(x)[0], y_k)
            print(f"# N1 {kind} {frames}: stamped bit for bit {stamped}",
                  flush=True)
            cs.log_phases(f"N1 {kind} {frames} x 256",
                          lambda: knb.nb_phases(x)[1], knb.N1_PHASES, card,
                          "predict", float(m_p.sum()) / frames,
                          n_ch=frames)
            # a launch lasts as long as its slowest frame
            ns = knb.nb_phases(x)[1][:, -1].double()
            torch.cuda.synchronize()
            print(f"# N1 {kind} {frames}: a frame's ns warm, median "
                  f"{float(ns.median()):.0f}, p99 "
                  f"{float(ns.quantile(0.99)):.0f}, max {float(ns.max()):.0f}",
                  flush=True)
            if not (rep["ok"] and stamped):
                failed.append(f"{kind} {frames}")
    # the noise blanker's add to a graphed block (stagebench `pallas_nb`
    # over `pallas`, ROOT's tools), in turns
    from t41x_torch import constants as C
    from t41x_torch.chain import ChainSpec
    from t41x_torch.tools import bench, stagebench
    floor_s = bench.dispatch_floor(dev)
    iq = bench.make_blocks(ChainSpec(), cs.STAGE_CHANNELS, cs.STAGE_BLOCKS,
                           seed=0, device=dev)
    variants = {"pallas": stagebench.VARIANTS["pallas"],
                "pallas_nb": cs.STAGE_EXTRA["pallas_nb"]}
    adds = []
    for i in range(cs.NB_ADD_ROUNDS):
        us = {k: stagebench.time_variant(
            variants[k], cs.STAGE_CHANNELS, cs.STAGE_BLOCKS, cs.STAGE_MIN_MS,
            dev, floor_s, iq)["us_per_block"]
            for k in list(variants)[::1 if i % 2 == 0 else -1]}
        adds.append(us["pallas_nb"] - us["pallas"])
        print(f"# stagebench round {i + 1}: pallas {us['pallas']:.1f}, "
              f"pallas_nb {us['pallas_nb']:.1f} us/block/"
              f"{cs.STAGE_CHANNELS}ch ({card})", flush=True)
    print(f"# stagebench pallas_nb - pallas: mean "
          f"{sum(adds) / len(adds):.2f}, min {min(adds):.2f}, max "
          f"{max(adds):.2f} us a block of {C.AUDIO_BLOCK} audio samples x "
          f"{cs.STAGE_CHANNELS} ({card})", flush=True)
    if failed:
        print(f"# N1 failed: {', '.join(failed)}", file=sys.stderr)
    return 1 if failed else 0


def n1_shapes() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from t41x_torch.kernels import _build, nb as knb

    src = (_build.SRC_DIR / "nb.cu").read_text()
    m = re.search(r"constexpr int WARPS = (\d+);", src)
    libs = {f"tree ({m.group(1)} frames a block)": _build.library()}
    for w in (2, 4, 8):
        v = src.replace(m.group(0), f"constexpr int WARPS = {w};")
        libs[f"{w} frames a block"] = nvcc_so(v, f"nb_warps{w}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(16)
    card = card_line()
    for kind in ("tone", "crowded"):
        x = cs.nb_stimulus(kind, N_CH, N, gen, dev)

        def launcher(lib):
            fn = lib.t41x_nb
            fn.argtypes, fn.restype = knb._ARGS, ctypes.c_int
            y = torch.empty_like(x)

            def go():
                if fn(x.data_ptr(), N_CH, N, knb.NB_THRESH, y.data_ptr(),
                      None, torch.cuda.current_stream().cuda_stream):
                    raise RuntimeError("t41x_nb: launch failed")
                return y
            return go

        cands = [(k, launcher(lib)) for k, lib in libs.items()]
        ref = cands[0][1]().clone()
        for k, fn in cands:
            if not torch.equal(fn(), ref):
                raise AssertionError(f"N1 {k}: not bit for bit")

        def cold(fn, reps=60):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(reps):
                cs.l2_flush()
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                e.synchronize()
                ts.append(s.elapsed_time(e) * 1e3)
            return float(np.median(ts))

        times = {}
        for order in (cands, cands[::-1], cands):
            for k, fn in order:
                times.setdefault(k, []).append(cold(fn))
        times["empty kernel"] = [cold(lambda: torch.cuda._sleep(0))]
        for k, v in times.items():
            print(f"# N1 {kind} {k:28s} events, L2 flushed: "
                  + " / ".join(f"{t:.2f}" for t in v)
                  + f" us ({N_CH} x {N}, {card})", flush=True)
    return 0


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(HERE))
    if len(argv) >= 2 and argv[0] in ("e1-s1", "n1", "n1-shapes"):
        sys.path.insert(0, str(Path(argv[1]).resolve()))
    if len(argv) >= 2 and argv[0] == "sass":
        return sass(argv[1:])
    if argv not in (["k3-split"], ["profiler-loss"]) and not (
            len(argv) == 2 and argv[0] in ("k3-variants", "e1-s1",
                                            "n1-shapes")) and not (
            len(argv) in (2, 3) and argv[0] == "n1"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_study: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    if argv[0] == "profiler-loss":
        return profiler_loss()
    if argv[0] == "e1-s1":
        return e1_s1()
    if argv[0] == "n1":
        return n1(argv[2] if len(argv) == 3 else None)
    if argv[0] == "n1-shapes":
        return n1_shapes()
    return k3_split() if argv[0] == "k3-split" else k3_variants(argv[1])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
