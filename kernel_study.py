#!/usr/bin/env python3
"""Measurements for designing a kernel on the card: its SASS, the phase
split of the original K3, and variants of K3's thread shape.

    python3 kernel_study.py sass SOURCE.cu [...]     (needs nvcc)
    python3 kernel_study.py k3-split                 (needs a card)
    python3 kernel_study.py k3-variants ROOT         (needs a card)
    python3 kernel_study.py profiler-loss            (needs a card)

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


def sass(sources: list[str]) -> int:
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


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(HERE))
    if len(argv) >= 2 and argv[0] == "sass":
        return sass(argv[1:])
    if argv not in (["k3-split"], ["profiler-loss"]) and not (
            len(argv) == 2 and argv[0] == "k3-variants"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("kernel_study: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    if argv[0] == "profiler-loss":
        return profiler_loss()
    return k3_split() if argv[0] == "k3-split" else k3_variants(argv[1])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
