#!/usr/bin/env python3
"""Drive t41x_torch's receive chain on one CUDA card and check it.

    python3 chip_smoke.py        (from the repository root; needs a card)

Phases, each of which raises on failure (so no result line follows a
failure):

1. build the CUDA kernels of `t41x_torch/csrc/` (nvcc, sm_90a) and time it;
2. hold each kernel against its plain torch version on the card at the
   main path's shapes (1024 channels, 3 streamed blocks): K1 the fused
   front end in its four variants (zoom None/0 x complex64/q15), K2 the
   AGC block, K3 the output interpolation, K4 the overlap-save matmul,
   K6 the SAM PLL, K7 the LMS in NR and notch form, K8 the Kim NR gains;
   and time kernel and plain version (CUDA events, median of 25 runs
   after warm-up);
3. drive the main paths — `RxChain.block` with `use_kernels=True` — at
   1024 channels x 12 blocks: the flagship spec (usb, zoom-x1
   panadapter, audio-spectrum taps, x8 interpolation), the headless
   spec (`spectrum_taps=False`), both with q15 ingest, then am, sam,
   nfm (with and without display taps), Kim, spectral and LMS NR, the
   notch, ft8 and psk31.  Each spec's
   kernel launches are counted in its run (every count is set to 0 just
   before it), and its outputs are held against the same chain with
   plain versions on the card: audio >= 55 dB SNR and displayed spectrum
   <= 0.5 dB, or, for the adaptive stages (SAM PLL, LMS, notch), the
   audio power spectrum of the last 2 blocks within 3 dB and SAM's
   carrier within 0.1 Hz; plus finite values of the expected shapes;
4. time the chain with kernels and with plain versions (complex input
   samples per second): the rx spec at 1024 and 4096 channels, sam and
   Kim and LMS NR at 1024; then, for rx, sam, nr_kim and nr_lms at 1024
   channels, the device time per block of each CUDA kernel under
   `torch.profiler`.

It prints the kernels' JSON line, the card's name and power limit as
`nvidia-smi` gives them, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a card, or outside the repository, it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_CH = 1024
N_BLOCKS = 12       # per spec: >= 12 for the adaptive stages' lock
RATE_CHANNELS = (1024, 4096)
REPS = 25

# (name, source, TPU kernel it replaces)
K1 = ("t41x_torch/csrc/frontend.cu",
      "t41x/kernels/frontend_pallas.py:280")
K2 = ("t41x_torch/csrc/agc.cu", "t41x/kernels/agc_pallas.py:95")
K3 = ("t41x_torch/csrc/interp.cu", "t41x/kernels/interp_pallas.py:61")
K4 = ("t41x_torch/csrc/os_filter.cu", "t41x/kernels/os_filter_pallas.py:32")
K6 = ("t41x_torch/csrc/sam.cu", "t41x/kernels/sam_pallas.py:32")
K7 = ("t41x_torch/csrc/xanr.cu", "t41x/kernels/xanr_pallas.py:35")
K8 = ("t41x_torch/csrc/nr_gain.cu", "t41x/kernels/nr_gain_pallas.py:35")

# the main paths: ChainSpec keywords, parity measure, and the kernels that
# must launch besides K1 and K3
SPECS = {
    "rx": (dict(mode="usb", spectrum_zoom=0), "waveform", ("K2",)),
    "rx_q15": (dict(mode="usb", spectrum_zoom=0, q15_input=True,
                    clip_taps=True), "waveform", ("K2",)),
    "headless": (dict(mode="usb", spectrum_taps=False), "waveform",
                 ("K2", "K4")),
    "headless_q15": (dict(mode="usb", spectrum_taps=False, q15_input=True),
                     "waveform", ("K2", "K4")),
    "am": (dict(mode="am"), "waveform", ("K2",)),
    "sam": (dict(mode="sam", f_lo=-3000.0, f_hi=3000.0), "adaptive",
            ("K2", "K6")),
    "nfm": (dict(mode="nfm"), "waveform", ("K2",)),
    "nfm_headless": (dict(mode="nfm", spectrum_taps=False), "waveform",
                     ("K2", "K4")),
    "nr_kim": (dict(mode="usb", nr_mode=1), "waveform", ("K2", "K8")),
    "nr_spectral": (dict(mode="usb", nr_mode=2), "waveform", ("K2",)),
    "nr_lms": (dict(mode="usb", nr_mode=3), "adaptive", ("K2", "K7")),
    "notch": (dict(mode="usb", notch_on=True), "adaptive", ("K2", "K7")),
    "ft8": (dict(mode="ft8"), "waveform", ("K2",)),
    "psk31": (dict(mode="psk31"), "waveform", ()),
}
TIMED = ("rx", "sam", "nr_kim", "nr_lms")  # the specs phase 4 times


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    try:
        from t41x_torch import constants as C
        from t41x_torch.chain import ChainSpec, RxChain, default_params
        from t41x_torch.demod import sam as sam_mod
        from t41x_torch.dsp import agc as agc_mod, nr as nr_mod
        from t41x_torch.kernels import _build
        from t41x_torch.kernels import agc as kagc
        from t41x_torch.kernels import frontend as kfe
        from t41x_torch.kernels import interp as kint
        from t41x_torch.kernels import nr_gain as knr
        from t41x_torch.kernels import os_filter as kos
        from t41x_torch.kernels import sam as ksam
        from t41x_torch.kernels import xanr as kxanr
        from t41x_torch.utils import parity
    except ImportError as e:
        print(f"chip_smoke: t41x_torch is not importable ({e}); run it "
              "from the repository root", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"# card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- 1. build -------------------------------------------------------
    _build.library()
    log(f"# build: {_build.build_seconds:.1f} s (nvcc sm_90a, "
        f"{len(list(_build.SRC_DIR.glob('*.cu')))} sources)")

    gen = torch.Generator(device=dev).manual_seed(7)

    def cnoise(*shape, scale=1.0):
        re = torch.randn(shape, generator=gen, device=dev)
        im = torch.randn(shape, generator=gen, device=dev)
        return torch.complex(re, im) * scale

    def rf_blocks(n_ch, n_blocks):
        """(n_blocks, n_ch, BLOCK) tone at Fs/4 + 1500 Hz in noise, the
        stimulus of bench.py's parity check."""
        t = torch.arange(n_blocks * C.BLOCK_SIZE, device=dev,
                         dtype=torch.float64) / C.SAMPLE_RATE
        ph = 2 * np.pi * (C.SAMPLE_RATE / 4 + 1500.0) * t
        tone = (0.3 * torch.polar(torch.ones_like(ph), ph)).to(
            torch.complex64)
        iq = tone.reshape(n_blocks, 1, C.BLOCK_SIZE) \
            + cnoise(n_blocks, n_ch, C.BLOCK_SIZE, scale=0.05)
        return iq.contiguous()

    def am_rf_blocks(n_ch, n_blocks):
        """(n_blocks, n_ch, BLOCK) AM carrier 30 Hz above the tuned
        frequency, 30% modulated at 400 Hz, in light noise: the SAM
        stimulus of tools/chipcheck.py (the PLL locks on it)."""
        t = torch.arange(n_blocks * C.BLOCK_SIZE, device=dev,
                         dtype=torch.float64) / C.SAMPLE_RATE
        env = 0.4 * (1.0 + 0.3 * torch.cos(2 * np.pi * 400.0 * t))
        ph = 2 * np.pi * (-C.SAMPLE_RATE / 4 + 30.0) * t
        sig = torch.polar(env, ph).to(torch.complex64)
        iq = sig.reshape(n_blocks, 1, C.BLOCK_SIZE) \
            + cnoise(n_blocks, n_ch, C.BLOCK_SIZE, scale=0.01)
        return iq.contiguous()

    def q15(iq):
        def cv(a):
            return torch.clamp(torch.round(a * 32768.0), -32768,
                               32767).to(torch.int16).contiguous()
        return cv(iq.real), cv(iq.imag)

    def params(n_ch):
        p = default_params((n_ch,), device=dev)
        lin = lambda a, b: torch.linspace(a, b, n_ch, device=dev)  # noqa
        return p._replace(nco_freq=lin(-500.0, 700.0),
                          rf_gain_db=lin(-3.0, 6.0),
                          iq_amp=lin(0.97, 1.03),
                          iq_phase=lin(-0.02, 0.02))

    def time_ms(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    def leaves(tree):
        if isinstance(tree, (tuple, list)):
            return [x for t in tree for x in leaves(t)]
        return [tree]

    def close(name, got, ref, rtol, atol):
        """max |got - ref|; raise unless |got - ref| <= atol + rtol |ref|."""
        got, ref = got.detach(), ref.detach()
        if got.shape != ref.shape or got.dtype != ref.dtype:
            raise AssertionError(f"{name}: {got.dtype} {tuple(got.shape)} "
                                 f"vs {ref.dtype} {tuple(ref.shape)}")
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        d = (got - ref).abs()
        bad = d > atol + rtol * ref.abs()
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: {int(bad.sum())} elements out of tolerance, "
                f"max |err| {float(d.max()):.3g} (rtol {rtol}, atol {atol})")
        return float(d.max())

    def state_close(name, got, ref):
        # the bounds of tests/test_frontend_fused.py::_assert_state_close:
        # the DC-biquad state is a random walk of fp32 rounding noise
        for i, (a, b) in enumerate(zip(leaves(got), leaves(ref))):
            scale = float(b.abs().max()) if b.numel() else 0.0
            close(f"{name} state[{i}]", a, b, 2e-3, max(5e-4, 1e-3 * scale))

    rows = []

    def row(name, src, ms, plain_ms, err, tol):
        rows.append(dict(name=name, route="cuda", source=src[0],
                         replaces=src[1], launches=0, max_abs_err=err,
                         ms=ms, plain_ms=plain_ms))
        log(f"# {name}: max |err| {err:.3g} within rtol {tol[0]}, atol "
            f"{tol[1]}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per "
            f"call ({N_CH} channels, {card})")

    # ---- 2. each kernel against its plain version -------------------------
    rx = RxChain(ChainSpec(use_kernels=True, spectrum_zoom=0), device=dev)
    p = params(N_CH)
    blocks = rf_blocks(N_CH, 3)
    for zoom in (0, None):
        for fmt in ("c64", "q15"):
            fe = kfe.FusedFrontEnd(rx.h1, rx.h2, rx.dc_b[0], rx.dc_a[0],
                                   zoom=zoom)
            st_k = st_p = fe.init_state((N_CH,), dev)
            err = 0.0
            for b in range(3):
                iq = q15(blocks[b]) if fmt == "q15" else blocks[b]
                out_k = fe.block(p, st_k, iq)
                out_p = fe.plain(p, st_p, iq)
                st_k, st_p = out_k[0], out_p[0]
                err = max(err, close("K1 x", out_k[1], out_p[1], 2e-4, 2e-5))
                if zoom == 0:
                    close("K1 seg", out_k[2], out_p[2], 2e-4, 2e-5)
                state_close("K1", st_k, st_p)
            iq = q15(blocks[0]) if fmt == "q15" else blocks[0]
            row(f"K1 frontend zoom={zoom} {fmt}", K1,
                time_ms(lambda: fe.block(p, st_k, iq)),
                time_ms(lambda: fe.plain(p, st_k, iq)), err, (2e-4, 2e-5))

    ap = agc_mod.agc_params(2)
    st_k = st_p = agc_mod.agc_state(ap, (N_CH,), dev)
    err = 0.0
    for b in range(3):  # levels that move the gain through its states
        x = cnoise(N_CH, C.AUDIO_BLOCK, scale=(0.02, 0.5, 0.005)[b])
        st_k, y_k = kagc.agc_block(ap, st_k, x)
        st_p, y_p = kagc.agc_block_plain(ap, st_p, x)
        err = max(err, close("K2 y", y_k, y_p, 1e-6, 1e-7))
        for f in st_p._fields:
            close(f"K2 {f}", getattr(st_k, f), getattr(st_p, f), 1e-6, 1e-7)
    row("K2 agc_block", K2, time_ms(lambda: kagc.agc_block(ap, st_k, x)),
        time_ms(lambda: kagc.agc_block_plain(ap, st_k, x)), err,
        (1e-6, 1e-7))

    fi = kint.FusedInterp(rx.hi1, rx.hi2)
    vol = torch.linspace(0.5, 2.0, N_CH, device=dev)
    hk = hp = (torch.zeros(N_CH, fi.sub1 - 1, device=dev),
               torch.zeros(N_CH, fi.sub2 - 1, device=dev))
    err = 0.0
    for b in range(3):
        a = torch.randn(N_CH, C.AUDIO_BLOCK, generator=gen, device=dev) * 0.4
        *hk, y_k = fi.apply(a, *hk, vol)
        *hp, y_p = fi.plain(a, *hp, vol)
        err = max(err, close("K3 y", y_k, y_p, 2e-5, 2e-6))
        close("K3 int1", hk[0], hp[0], 1e-6, 1e-7)
        close("K3 int2", hk[1], hp[1], 2e-5, 2e-6)
    row("K3 interp", K3, time_ms(lambda: fi.apply(a, *hk, vol)),
        time_ms(lambda: fi.plain(a, *hk, vol)), err, (2e-5, 2e-6))

    W = rx.tensors["os_W"]
    s_k = s_p = torch.zeros(N_CH, C.FFT_LENGTH // 2, dtype=torch.complex64,
                            device=dev)
    err = 0.0
    for b in range(3):
        x = cnoise(N_CH, C.FFT_LENGTH // 2, scale=0.3)
        s_k, y_k = kos.os_filter_matmul_kernel(s_k, x, W)
        s_p, y_p = kos.os_filter_matmul(s_p, x, W)
        err = max(err, close("K4 y", y_k, y_p, 2e-3, 2e-4))
        close("K4 state", s_k, s_p, 0.0, 0.0)
    row("K4 os_filter", K4,
        time_ms(lambda: kos.os_filter_matmul_kernel(s_k, x, W)),
        time_ms(lambda: kos.os_filter_matmul(s_k, x, W)), err, (2e-3, 2e-4))

    # K6: a 120 Hz carrier, AM at 400 Hz, a level per channel, light
    # noise (tests/test_pallas_kernels.py's SAM stimulus).  Every
    # operation is rounded alone on both sides, sinf/cosf alike.
    sp = sam_mod.sam_params()
    st_k = st_p = sam_mod.sam_state((N_CH,), dev)
    level = torch.linspace(0.5, 1.0, N_CH, device=dev)[:, None]
    err = 0.0
    for b in range(3):
        t = (torch.arange(C.AUDIO_BLOCK, device=dev, dtype=torch.float64)
             + b * C.AUDIO_BLOCK) / C.AUDIO_RATE
        env = 1.0 + 0.4 * torch.cos(2 * np.pi * 400.0 * t)
        car = torch.polar(env, 2 * np.pi * 120.0 * t).to(torch.complex64)
        y = car * level + cnoise(N_CH, C.AUDIO_BLOCK, scale=0.01)
        st_k, a_k = ksam.sam_block(sp, st_k, y)
        st_p, a_p = ksam.sam_block_plain(sp, st_p, y)
        err = max(err, close("K6 audio", a_k, a_p, 1e-4, 1e-5))
        for f in st_p._fields:
            close(f"K6 {f}", getattr(st_k, f), getattr(st_p, f), 1e-4, 1e-5)
    row("K6 sam_block", K6, time_ms(lambda: ksam.sam_block(sp, st_k, y)),
        time_ms(lambda: ksam.sam_block_plain(sp, st_k, y)), err,
        (1e-4, 1e-5))

    # K7: noise at the level of the chain's audio; leak indices at the
    # two fixed points of the reference's lidx quirk (120: clamped at the
    # minimum, 200: pinned at the maximum), where rounding cannot move
    # them.  The kernel sums in another order than torch.sum, so it
    # agrees within a tolerance, not bit for bit.
    for notch in (False, True):
        xp = nr_mod.XanrParams(notch=notch)
        lidx0 = torch.where(torch.arange(N_CH, device=dev) % 2 == 0,
                            120.0, 200.0)
        st_k = st_p = nr_mod.xanr_state(xp, (N_CH,), dev)._replace(
            lidx=lidx0)
        err = 0.0
        for b in range(3):
            x = torch.randn(N_CH, C.AUDIO_BLOCK, generator=gen,
                            device=dev) * 0.2
            st_k, y_k = kxanr.xanr_block(xp, st_k, x)
            st_p, y_p = kxanr.xanr_block_plain(xp, st_p, x)
            err = max(err, close("K7 y", y_k, y_p, 1e-4, 1e-5))
            for f in st_p._fields:
                close(f"K7 {f}", getattr(st_k, f), getattr(st_p, f), 1e-4,
                      1e-5)
        row(f"K7 xanr {'notch' if notch else 'nr'}", K7,
            time_ms(lambda: kxanr.xanr_block(xp, st_k, x)),
            time_ms(lambda: kxanr.xanr_block_plain(xp, st_k, x)), err,
            (1e-4, 1e-5))

    # K8: two hops a block, bin powers whose level changes from block to
    # block so the minimum statistics and the psi rule both move.
    # Elementwise arithmetic plus an exact min: bit for bit.
    kp = nr_mod.kim_params(200.0, 3000.0)
    ks = nr_mod.kim_state((N_CH,), dev)
    g_k = g_p = (ks.X, ks.E, ks.Gts, ks.idx)
    err = 0.0
    for b in range(3):
        pw = torch.rand(2, N_CH, nr_mod.HOP, generator=gen, device=dev) \
            * (1.0 + 9.0 * b)
        g_k, y_k = knr.kim_gains(kp, g_k, pw)
        g_p, y_p = knr.kim_gains_plain(kp, g_p, pw)
        err = max(err, close("K8 gains", y_k, y_p, 0.0, 0.0))
        for i, (a, r) in enumerate(zip(g_k, g_p)):
            close(f"K8 state[{i}]", a, r, 0.0, 0.0)
    row("K8 kim_gains", K8, time_ms(lambda: knr.kim_gains(kp, g_k, pw)),
        time_ms(lambda: knr.kim_gains_plain(kp, g_k, pw)), err, (0.0, 0.0))

    # ---- 3. the main path, through the kernels ----------------------------
    counters = {"K1": (kfe.FusedFrontEnd, "launches"),
                "K2": (kagc.agc_block, "launches"),
                "K3": (kint.FusedInterp, "launches"),
                "K4": (kos.os_filter_matmul_kernel, "launches"),
                "K6": (ksam.sam_block, "launches"),
                "K7": (kxanr.xanr_block, "launches"),
                "K8": (knr.kim_gains, "launches")}
    data = rf_blocks(N_CH, N_BLOCKS)
    data_q15 = q15(data)
    am_data = am_rf_blocks(N_CH, N_BLOCKS)

    def stream(chain, src, pr):
        st = chain.init_state((N_CH,))
        outs = []
        for b in range(N_BLOCKS):
            blk = (tuple(a[b] for a in src) if isinstance(src, tuple)
                   else src[b])
            st, out = chain.block(pr, st, blk)
            outs.append(out)
        return st, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    for name, (kw, measure, need) in SPECS.items():
        q = kw.get("q15_input", False)
        taps = kw.get("spectrum_taps", True) and kw["mode"] != "psk31"
        if kw["mode"] == "sam":
            # tools/chipcheck.py's stimulus and default parameters: the
            # carrier sits 30 Hz off and every channel's PLL locks (the
            # spread fine-tune of `params` would put it up to 530 Hz off)
            src, pr = am_data, default_params((N_CH,), device=dev)
        else:
            src, pr = (data_q15 if q else data), p
        chain_k = RxChain(ChainSpec(use_kernels=True, **kw), device=dev)
        chain_p = RxChain(ChainSpec(use_kernels=False, **kw), device=dev)
        for obj, attr in counters.values():
            setattr(obj, attr, 0)
        st_k, out_k = stream(chain_k, src, pr)
        torch.cuda.synchronize()
        counts = {k: getattr(obj, attr) for k, (obj, attr)
                  in counters.items()}
        st_p, out_p = stream(chain_p, src, pr)
        for k in ("K1", "K3") + need:
            if counts[k] == 0:
                raise AssertionError(f"{name}: kernel {k} was not launched")
        # each launch goes to the row of the variant this spec runs
        zoom = 0 if kw.get("spectrum_zoom") == 0 else None
        fed = {"K1": f"K1 frontend zoom={zoom} {'q15' if q else 'c64'}",
               "K7": f"K7 xanr {'notch' if kw.get('notch_on') else 'nr'}"}
        for r in rows:
            k = r["name"][:2]
            if fed.get(k, r["name"]) == r["name"]:
                r["launches"] += counts[k]
        B = N_BLOCKS
        want = {"audio": (B, N_CH, C.BLOCK_SIZE),
                "audio_24k": (B, N_CH, C.AUDIO_BLOCK)}
        if kw.get("spectrum_zoom") == 0:
            want["rf_spectrum"] = (B, N_CH, C.SPECTRUM_RES)
        if taps:
            want["audio_spectrum"] = (B, N_CH, C.FFT_LENGTH)
        if kw["mode"] == "sam":
            want["sam_carrier_hz"] = (B, N_CH)
        if kw["mode"] == "psk31":
            want["iq_baseband"] = (B, N_CH, C.AUDIO_BLOCK)
        report = {}
        for k, shape in want.items():
            got, ref = out_k[k], out_p[k]
            if tuple(got.shape) != shape or not bool(
                    torch.isfinite(got).all()):
                raise AssertionError(f"{name} {k}: shape "
                                     f"{tuple(got.shape)}, finite "
                                     f"{bool(torch.isfinite(got).all())}")
            if k == "sam_carrier_hz":
                d = float((got[-1] - ref[-1]).abs().max())
                report[k + "_err_hz"] = d
                ok = d <= 0.1
            elif k in ("rf_spectrum", "audio_spectrum"):
                # both taps sit before any adaptive stage
                d = parity.spectrum_err_db(ref, got)
                report[k + "_err_db"] = d
                ok = d <= parity.SPECTRUM_ERR_MAX_DB
            elif measure == "adaptive":
                d = parity.psd_err_db(ref, got)
                report[k + "_psd_err_db"] = d
                ok = d <= parity.PSD_ERR_MAX_DB
            else:
                d = parity.snr_db(ref, got)
                report[k + "_snr_db"] = d
                ok = d >= parity.AUDIO_SNR_MIN_DB
            if not ok:
                raise AssertionError(f"{name} {k}: parity {d} out of bound")
        if kw.get("clip_taps"):
            for k in ("adc_half_clip", "adc_quarter_clip"):
                if not torch.equal(out_k[k], out_p[k]):
                    raise AssertionError(f"{name} {k} differs")
        if measure == "waveform":
            state_close(f"{name} chain", st_k, st_p)
        log(f"# main path {name}: {N_CH} ch x {B} blocks, launches "
            f"{counts}, kernels vs plain on the card {report}")

    # ---- 4. rates ----------------------------------------------------------
    def rate(name, kw, n_ch, use_kernels, n_blocks):
        blk = rf_blocks(n_ch, 1)[0]
        pr = params(n_ch)
        chain = RxChain(ChainSpec(use_kernels=use_kernels, **kw), device=dev)
        st = chain.init_state((n_ch,))
        st, _ = chain.block(pr, st, blk)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_blocks):
            st, out = chain.block(pr, st, blk)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        r = n_blocks * n_ch * C.BLOCK_SIZE / dt
        log(f"# rate {name} spec {'kernels' if use_kernels else 'plain'} "
            f"{n_ch} ch: {r:.6g} complex samples/s "
            f"({dt / n_blocks * 1e3:.3f} ms/block, {card})")

    for name in TIMED:
        for n_ch in RATE_CHANNELS if name == "rx" else (N_CH,):
            for use_kernels, n_blocks in ((True, 32), (False, 3)):
                rate(name, SPECS[name][0], n_ch, use_kernels, n_blocks)

    # where the time goes: device time per block of each CUDA kernel,
    # by name, under torch.profiler over 20 blocks after 5 warm-up blocks
    from torch.profiler import ProfilerActivity, profile

    blk, pr = rf_blocks(N_CH, 1)[0], params(N_CH)
    for name in TIMED:
        chain = RxChain(ChainSpec(use_kernels=True, **SPECS[name][0]),
                        device=dev)
        st = chain.init_state((N_CH,))
        for _ in range(5):
            st, _ = chain.block(pr, st, blk)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(20):
                st, _ = chain.block(pr, st, blk)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 20
        dev_us = {}
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                dev_us[ev.key] = ev.device_time_total / 20
        log(f"# profile {name}: {N_CH} ch, device "
            f"{sum(dev_us.values()):.1f} us/block of wall "
            f"{wall * 1e6:.1f} us/block under the profiler ({card})")
        for k, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
            log(f"#   {us:10.1f} us/block  {k[:110]}")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
