#!/usr/bin/env python3
"""Every CUDA kernel of t41x_torch under NVIDIA's compute-sanitizer, and
K1z at zoom 7 timed again and again.

    python3 kernel_sanitize.py                      (needs a card)
    python3 kernel_sanitize.py --repeat N
    python3 kernel_sanitize.py --tools [--repeat N]
    python3 kernel_sanitize.py --jitter [--repeat N]

The first form runs each kernel row of `chip_smoke.py` phase 2 once at
small odd channel counts (7 and 33; K1 zoom None/0 in complex64 and
q15, K1z at zoom 1, 3 and 7 and zoom 1 in q15, K2, K3 on a contiguous
row and on the real part of a complex64 row, K4, K5, K6, K7 in NR and
notch form, K8, C1, the transmit chain's compressor of phase 6, N1,
the noise blanker, on sparse and on crowded impulses
(`chip_smoke.nb_stimulus`), S1, spectral NR's gains at 2 and 16 hops, and E1,
the EQ, at every channel, at one, and over 2048 samples: 8 passes),
each twice on the same inputs, and fails unless the two
runs agree bit for bit: a race that changes what a kernel computes
shows there.  No profiler and no plain versions, so that the form is
quick under a sanitizer.

The second runs K1z's zoom-7 row as `chip_smoke.py` phase 2 does, at
1024 channels, N times in one process: each time three streamed blocks
against the plain version (max |err|, within chip_smoke's bounds) and
the kernel's device µs a launch (torch.profiler, L2 flushed before each
launch: `chip_smoke.device_us`).

The third builds the kernels, then runs the first form under each of
compute-sanitizer's tools (memcheck, racecheck, synccheck, initcheck)
with PyTorch's caching allocator off (so that memcheck sees each
tensor's own bounds), prints each tool's summary, and fails if a tool
reports an error or does not run; then, with --repeat, the second form.

    python3 kernel_sanitize.py --jitter [--repeat N]

builds a second library from the same sources in which every warp,
after each `__syncthreads()` and `cluster.sync()` and after each wait
at or arrival on a named barrier (`named_bar_sync`, `named_bar_arrive`:
C1's two warp roles meet there), spins for 0-2047 cycles chosen by its
block, its warp and the call site, and every lane, after each
`warp_sync()` (N1's lanes exchange a frame's scratch there: the run
list, the mask words and the input copies before the walk, the
predictors' outputs after it), for 0-2047 cycles chosen by its block,
warp, lane and the call site (S1 has no site: no shared memory; its
lanes, and N1's outside those two points, meet only in shuffles, which
every lane of the warp reaches together); and holds
every row of the first form, at 7, 33 and 1024 channels, against the
normal library bit for bit.  A phase that
reads what another warp (or lane) writes without a barrier between
them, or overwrites what a slower one still reads, gives another
result once their order is shuffled: a race check that needs no
sanitizer.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHANNELS = (7, 33)
ZOOMS = ((1, "c64"), (3, "c64"), (7, "c64"), (1, "q15"))
TOOLS = ("memcheck", "racecheck", "synccheck", "initcheck")
JITTER_CHANNELS = (7, 33, 1024)
# a call of a kernel's named-barrier helpers (C1's warp roles meet at
# `named_bar_sync(id)` and `named_bar_arrive(id)`), not their definitions
NAMED_BARRIER = re.compile(r"\b(named_bar_(?:sync|arrive)\([^;(){}]*\));")
# a call of N1's warp barrier helper (`warp_sync()`), not its definition
WARP_SYNC = re.compile(r"\bwarp_sync\(\);")
# the spin the jittered build puts after every block or cluster barrier
# and every named-barrier wait or arrival
JITTER = """
static __device__ __forceinline__ void t41x_jitter(unsigned site)
{
    unsigned h = blockIdx.x * 0x9E3779B1u ^ (threadIdx.x >> 5) * 0x85EBCA6Bu
                 ^ site * 0xC2B2AE35u;
    h ^= h >> 15;
    h *= 0x2C1B3C6Du;
    h ^= h >> 12;
    const long long t0 = clock64();
    while (clock64() - t0 < (long long)(h & 2047u)) {
    }
}

static __device__ __forceinline__ void t41x_jitter_lane(unsigned site)
{
    t41x_jitter(site * 0x27D4EB2Fu ^ (threadIdx.x & 31u));
}
"""


def sanitizer() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "compute-sanitizer").exists():
            return str(Path(cand, "bin", "compute-sanitizer"))
    found = shutil.which("compute-sanitizer")
    if found is None:
        raise RuntimeError("compute-sanitizer not found: set CUDA_HOME")
    return found


def leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def kernel_rows(dev, ch: int, gen):
    """(name, call) for each kernel row of chip_smoke.py phase 2 at `ch`
    channels: `call()` launches the kernel once and returns its
    outputs."""
    import torch

    from t41x_torch import constants as C
    from t41x_torch.chain import ChainSpec, RxChain, default_params
    from t41x_torch.demod import sam as sam_mod
    from t41x_torch.dsp import agc as agc_mod, nr as nr_mod
    from t41x_torch.dsp.spectrum import ZoomFFT
    from t41x_torch.chain import compressor as comp_mod
    from t41x_torch.kernels import agc as kagc
    from t41x_torch.kernels import frontend as kfe
    from t41x_torch.kernels import interp as kint
    from t41x_torch.kernels import nr_gain as knr
    from t41x_torch.kernels import os_filter as kos
    from t41x_torch.kernels import sam as ksam
    from t41x_torch.kernels import xanr as kxanr
    from t41x_torch.kernels import spectral_nr as kspec
    from t41x_torch.dsp import eq as eq_mod, nb as nb_mod

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def cnoise(*shape, scale=1.0):
        return torch.complex(randn(*shape), randn(*shape)) * scale

    def q15(iq):
        return tuple(torch.clamp(torch.round(a * 32768.0), -32768, 32767)
                     .to(torch.int16).contiguous() for a in (iq.real, iq.imag))

    rx = RxChain(ChainSpec(use_kernels=True, spectrum_zoom=0), device=dev)
    p = default_params((ch,), device=dev)._replace(
        nco_freq=torch.linspace(-500.0, 700.0, ch, device=dev))
    iq = cnoise(ch, C.BLOCK_SIZE, scale=0.3)
    rows = []
    for zoom in (0, None):
        for fmt in ("c64", "q15"):
            fe = kfe.FusedFrontEnd(rx.h1, rx.h2, rx.dc_b[0], rx.dc_a[0],
                                   zoom=zoom)
            x = q15(iq) if fmt == "q15" else iq
            st = fe.init_state((ch,), dev)
            rows.append((f"K1 frontend zoom={zoom} {fmt}",
                         lambda fe=fe, st=st, x=x: fe.block(p, st, x)))
    for zoom, fmt in ZOOMS:
        zf = ZoomFFT(zoom)
        fe = kfe.FusedFrontEnd(rx.h1, rx.h2, rx.dc_b[0], rx.dc_a[0],
                               zoom=zoom, zoom_sos=(zf.iir_b, zf.iir_a),
                               zoom_h=zf.h)
        zst = zf.init_state((ch,), dev)
        x = q15(iq) if fmt == "q15" else iq
        rows.append((f"K1 frontend zoom={zoom} {fmt}",
                     lambda fe=fe, st=fe.init_state((ch,), dev), x=x,
                     z=(zst.iir, zst.dec): fe.block(p, st, x, z)))

    ap = agc_mod.agc_params(2)
    ast = agc_mod.agc_state(ap, (ch,), dev)
    x2 = cnoise(ch, C.AUDIO_BLOCK, scale=0.3)
    rows.append(("K2 agc_block", lambda: kagc.agc_block(ap, ast, x2)))
    carry = tuple(ast[2:])
    rm = torch.rand(64, ch, generator=gen, device=dev) * 0.3
    ao = torch.rand(64, ch, generator=gen, device=dev) * 0.3
    rows.append(("K5 agc_scan", lambda: kagc.agc_scan(ap, carry, rm, ao)))

    fi = kint.FusedInterp(rx.hi1, rx.hi2)
    vol = torch.linspace(0.5, 2.0, ch, device=dev)
    hist = (randn(ch, fi.sub1 - 1, scale=0.4), randn(ch, fi.sub2 - 1))
    a_real = cnoise(ch, C.AUDIO_BLOCK, scale=0.4).real
    a_row = a_real.contiguous()
    rows.append(("K3 interp", lambda: fi.apply(a_row, *hist, vol)))
    rows.append(("K3 interp y.real", lambda: fi.apply(a_real, *hist, vol)))

    W = rx.tensors["os_W"]
    wp = (rx.tensors["os_Wp"],) if "os_Wp" in rx.tensors else ()
    s4 = cnoise(ch, C.FFT_LENGTH // 2, scale=0.3)
    x4 = cnoise(ch, C.FFT_LENGTH // 2, scale=0.3)
    rows.append(("K4 os_filter",
                 lambda: kos.os_filter_matmul_kernel(s4, x4, W, *wp)))

    sp = sam_mod.sam_params()
    sst = sam_mod.sam_state((ch,), dev)
    t = torch.arange(C.AUDIO_BLOCK, device=dev) / C.AUDIO_RATE
    y6 = torch.polar(torch.ones_like(t), 2 * torch.pi * 120.0 * t) \
        + cnoise(ch, C.AUDIO_BLOCK, scale=0.01)
    rows.append(("K6 sam_block", lambda: ksam.sam_block(sp, sst, y6)))

    for notch in (False, True):
        xp = nr_mod.XanrParams(notch=notch)
        xst = nr_mod.xanr_state(xp, (ch,), dev)
        x7 = randn(ch, C.AUDIO_BLOCK, scale=0.2)
        rows.append((f"K7 xanr {'notch' if notch else 'nr'}",
                     lambda xp=xp, xst=xst, x7=x7:
                     kxanr.xanr_block(xp, xst, x7)))

    kp = nr_mod.kim_params(200.0, 3000.0)
    ks = nr_mod.kim_state((ch,), dev)
    g = (ks.X, ks.E, ks.Gts, ks.idx)
    pw = torch.rand(2, ch, nr_mod.HOP, generator=gen, device=dev)
    rows.append(("K8 kim_gains", lambda: knr.kim_gains(kp, g, pw)))

    cp = comp_mod.compressor_params()
    cst = comp_mod.CompressorState(
        -80.0 + 90.0 * torch.rand(ch, generator=gen, device=dev))
    xc = randn(ch, C.BLOCK_SIZE, scale=0.5)
    rows.append(("C1 compressor", lambda: comp_mod.compress(cp, cst, xc)))

    # N1: noise frames with an impulse every 70 samples, and crowded
    # impulse noise (long walks, groups of runs closer than the
    # predictors' order: chip_smoke.nb_stimulus)
    xn = randn(ch, C.AUDIO_BLOCK, scale=0.1)
    xn[:, 40::70] += 2.0
    rows.append(("N1 nb", lambda: nb_mod.noise_blanker(xn)))
    import chip_smoke
    xc = chip_smoke.nb_stimulus("crowded", ch, C.AUDIO_BLOCK, gen, dev)
    rows.append(("N1 nb crowded", lambda: nb_mod.noise_blanker(xc)))

    # S1: 2 and 16 hops, from a state whose frame counts straddle the
    # init phase's end
    nr_p = nr_mod.spectral_params(200.0, 3000.0)
    nr_st = nr_mod.spectral_state((ch,), dev)
    nr_g = (nr_st.xt, nr_st.pslp, nr_st.hk_old,
            torch.arange(ch, dtype=torch.int32, device=dev) % 40)
    for hops in (2, 16):
        nr_pw = torch.rand(hops, ch, nr_mod.HOP, generator=gen,
                           device=dev) * 4.0
        rows.append((f"S1 spectral_gains {hops} hops",
                     lambda nr_pw=nr_pw: kspec.spectral_gains(nr_p, nr_g,
                                                              nr_pw)))

    # E1: per-channel gains from a random state, and one channel with
    # shared gains (Radio.transmit_ssb)
    eqd = eq_mod.EQDesign()
    xe = randn(ch, C.AUDIO_BLOCK, scale=0.3)
    ge = torch.rand(ch, eq_mod.NUM_BANDS, generator=gen, device=dev)
    se = randn(ch, eq_mod.NUM_BANDS, 2, 2, scale=0.1)
    rows.append(("E1 eq", lambda: eqd.apply(se, xe, ge, use_kernels=True)))
    rows.append(("E1 eq 1 channel",
                 lambda: eqd.apply(se[0], xe[0], ge[0], use_kernels=True)))
    xl = randn(ch, 8 * C.AUDIO_BLOCK, scale=0.3)
    rows.append(("E1 eq 2048",
                 lambda: eqd.apply(se, xl, ge, use_kernels=True)))
    return rows


def launches() -> int:
    from t41x_torch.kernels import agc as kagc
    from t41x_torch.kernels import compressor as kcomp
    from t41x_torch.kernels import frontend as kfe
    from t41x_torch.kernels import interp as kint
    from t41x_torch.kernels import nb as knb
    from t41x_torch.kernels import nr_gain as knr
    from t41x_torch.kernels import os_filter as kos
    from t41x_torch.kernels import sam as ksam
    from t41x_torch.kernels import xanr as kxanr
    from t41x_torch.kernels import eq as keq
    from t41x_torch.kernels import spectral_nr as kspec
    return (kfe.FusedFrontEnd.launches + kagc.agc_block.launches
            + kagc.agc_scan.launches + kint.FusedInterp.launches
            + kos.os_filter_matmul_kernel.launches + ksam.sam_block.launches
            + kxanr.xanr_block.launches + knr.kim_gains.launches
            + kcomp.launch.launches + knb.launch.launches
            + kspec.spectral_gains.launches + keq.eq_block.launches)


def run_rows() -> int:
    """Each row twice at each of CHANNELS; raise unless the two runs of a
    row are equal bit for bit and each launched its kernel."""
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    n = 0
    for ch in CHANNELS:
        for name, call in kernel_rows(dev, ch, gen):
            n0 = launches()
            first = [t.clone() for t in leaves(call())]
            second = leaves(call())
            torch.cuda.synchronize()
            if launches() != n0 + 2:
                raise AssertionError(f"{name} at {ch} channels: "
                                     f"{launches() - n0} launches, not 2")
            for i, (a, b) in enumerate(zip(first, second)):
                if not torch.equal(a, b):
                    raise AssertionError(f"{name} at {ch} channels: output "
                                         f"{i} differs between two runs")
            n += 1
    print(f"kernel_sanitize: {n} rows ran twice, each pair equal bit for "
          f"bit ({' and '.join(map(str, CHANNELS))} channels)", flush=True)
    return n


def repeat_zoom7(times: int) -> None:
    """K1z at zoom 7 as chip_smoke.py phase 2 runs it, `times` times."""
    import torch

    import chip_smoke as cs
    from t41x_torch import constants as C
    from t41x_torch.chain import ChainSpec, RxChain, default_params
    from t41x_torch.dsp.spectrum import ZoomFFT
    from t41x_torch.kernels import frontend as kfe

    dev = torch.device("cuda", 0)
    n_ch = cs.N_CH
    gen = torch.Generator(device=dev).manual_seed(7)
    rx = RxChain(ChainSpec(use_kernels=True, spectrum_zoom=0), device=dev)
    p = default_params((n_ch,), device=dev)
    lin = lambda a, b: torch.linspace(a, b, n_ch, device=dev)  # noqa: E731
    p = p._replace(nco_freq=lin(-500.0, 700.0), rf_gain_db=lin(-3.0, 6.0),
                   iq_amp=lin(0.97, 1.03), iq_phase=lin(-0.02, 0.02))
    zf = ZoomFFT(7)
    fe = kfe.FusedFrontEnd(rx.h1, rx.h2, rx.dc_b[0], rx.dc_a[0], zoom=7,
                           zoom_sos=(zf.iir_b, zf.iir_a), zoom_h=zf.h)
    card = cs.card_line()
    times_us = []
    for i in range(times):
        t = torch.arange(3 * C.BLOCK_SIZE, device=dev,
                         dtype=torch.float64) / C.SAMPLE_RATE
        ph = 2 * torch.pi * (C.SAMPLE_RATE / 4 + 1500.0) * t
        tone = (0.3 * torch.polar(torch.ones_like(ph), ph)).to(
            torch.complex64).reshape(3, 1, C.BLOCK_SIZE)
        noise = torch.complex(
            torch.randn(3, n_ch, C.BLOCK_SIZE, generator=gen, device=dev),
            torch.randn(3, n_ch, C.BLOCK_SIZE, generator=gen, device=dev))
        blocks = (tone + 0.05 * noise).contiguous()
        st_k = st_p = fe.init_state((n_ch,), dev)
        zst = zf.init_state((n_ch,), dev)
        z_k = z_p = (zst.iir, zst.dec)
        err = 0.0
        for b in range(3):
            out_k = fe.block(p, st_k, blocks[b], z_k)
            out_p = fe.plain(p, st_p, blocks[b], z_p)
            st_k, st_p, z_k, z_p = out_k[0], out_p[0], out_k[3:], out_p[3:]
            d = (out_k[1] - out_p[1]).abs()
            if bool((d > 2e-5 + 2e-4 * out_p[1].abs()).any()) or not bool(
                    torch.isfinite(out_k[1]).all()):
                raise AssertionError(f"K1z zoom 7, repeat {i}: out of "
                                     f"tolerance, max |err| {float(d.max())}")
            err = max(err, float(d.max()))
        iq = blocks[0]
        us = cs.device_us(lambda: fe.block(p, st_k, iq, z_k),
                          cs.KERNEL_NAMES["K1"])
        times_us.append(us)
        print(f"# K1z zoom=7 c64 repeat {i + 1}/{times}: {us:.2f} us a "
              f"launch, max |err| {err:.3g} ({n_ch} channels, {card})",
              flush=True)
    print(f"# K1z zoom=7 c64 over {times} repeats: min {min(times_us):.2f}, "
          f"max {max(times_us):.2f} us a launch ({card})", flush=True)


def jittered(source: str):
    """A CUDA source with the spin of JITTER after every block or cluster
    barrier and every named-barrier wait or arrival, and a lane's own
    spin after every `warp_sync()`, and the number of such sites it
    found."""
    sites = source.count("__syncthreads();") + source.count("cluster.sync();")
    out = source.replace("#include <cuda_runtime.h>",
                         "#include <cuda_runtime.h>\n" + JITTER, 1)
    out = out.replace("__syncthreads();",
                      "__syncthreads(); t41x_jitter(__LINE__);")
    out = out.replace("cluster.sync();",
                      "cluster.sync(); t41x_jitter(__LINE__);")
    out, named = NAMED_BARRIER.subn(r"\1; t41x_jitter(__LINE__);", out)
    out, lanes = WARP_SYNC.subn("warp_sync(); t41x_jitter_lane(__LINE__);",
                                out)
    return out, sites + named + lanes


def jitter_library():
    """The kernels built with a spin after every barrier, and the number
    of barrier sites."""
    import ctypes

    from t41x_torch.kernels import _build
    src = _build.BUILD_DIR / "jitter_src"
    src.mkdir(parents=True, exist_ok=True)
    paths, sites = [], 0
    for f in sorted(_build.SRC_DIR.glob("*.cu")):
        text, n = jittered(f.read_text())
        (src / f.name).write_text(text)
        paths.append(src / f.name)
        sites += n
    lib = ctypes.CDLL(str(_build.build(paths, "libt41x_kernels_jitter")))
    return lib, sites


def run_jitter() -> None:
    """Every row with the normal and the jittered library, bit for bit."""
    import torch

    from t41x_torch.kernels import _build
    normal = _build.library()
    jittered, sites = jitter_library()
    dev = torch.device("cuda", 0)
    n = 0
    try:
        for ch in JITTER_CHANNELS:
            gen = torch.Generator(device=dev).manual_seed(9)
            for name, call in kernel_rows(dev, ch, gen):
                _build._lib = normal
                ref = [t.clone() for t in leaves(call())]
                _build._lib = jittered
                got = leaves(call())
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(ref, got)):
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"{name} at {ch} channels: output {i} differs "
                            f"with the warps' order shuffled")
                n += 1
    finally:
        _build._lib = normal
    print(f"kernel_sanitize: {n} rows equal bit for bit with a 0-2047 "
          f"cycle spin a warp after each of {sites} barrier sites "
          f"({', '.join(map(str, JITTER_CHANNELS))} channels)", flush=True)


def run_tools() -> bool:
    """The row form under each compute-sanitizer tool; True if every tool
    ran and reported no error."""
    from t41x_torch.kernels import _build
    _build.library()  # built here, so no tool runs nvcc
    tool = sanitizer()
    version = subprocess.run([tool, "--version"], capture_output=True,
                             text=True, timeout=60).stdout.strip()
    print(f"# {tool}: {version.splitlines()[-1] if version else '?'}",
          flush=True)
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    ok = True
    for name in TOOLS:
        t0 = time.perf_counter()
        out = subprocess.run(
            [tool, "--tool", name, "--error-exitcode", "9",
             sys.executable, str(Path(__file__).resolve())],
            capture_output=True, text=True, env=env, timeout=1800)
        text = out.stdout + out.stderr
        lines = [ln for ln in text.splitlines() if ln.startswith("=====")]
        summary = [ln for ln in lines if "ERROR SUMMARY" in ln
                   or "RACECHECK SUMMARY" in ln]
        rows_ok = any(ln.startswith("kernel_sanitize:")
                      for ln in text.splitlines())
        good = out.returncode == 0 and rows_ok
        ok &= good
        print(f"# compute-sanitizer --tool {name}: exit {out.returncode}, "
              f"{time.perf_counter() - t0:.1f} s, rows "
              f"{'ran' if rows_ok else 'did not run'}; "
              + ("; ".join(s.strip("= ") for s in summary) or "no summary"),
              flush=True)
        if not good:
            errors = [ln for ln in lines if "rror" in ln and "SUMMARY" not in ln]
            print("\n".join((errors or lines or text.splitlines())[:12]),
                  flush=True)
    return ok


def main(argv: list[str]) -> int:
    import torch
    args = list(argv)
    tools, jitter = "--tools" in args, "--jitter" in args
    for flag in ("--tools", "--jitter"):
        if flag in args:
            args.remove(flag)
    times = 0
    if len(args) == 2 and args[0] == "--repeat" and args[1].isdigit():
        times = int(args[1])
    elif args:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_sanitize: no CUDA device visible to torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    ok = True
    if tools:
        ok = run_tools()
    if jitter:
        run_jitter()
    if not (tools or jitter or times):
        run_rows()
    if times:
        repeat_zoom7(times)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
