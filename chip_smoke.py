#!/usr/bin/env python3
"""Drive t41x_torch's receive chain on one CUDA card and check it.

    python3 chip_smoke.py        (from the repository root; needs a card)
    python3 chip_smoke.py --kernels ROOT
    python3 chip_smoke.py --host

The second form runs phases 1 and 2 alone on the `t41x_torch` package
in ROOT (another checkout, e.g. a parent commit unpacked with `git
archive`), profiles the rx and headless blocks as phase 4 does, and
prints the kernels' JSON line and the card's line; `kernel_ab.py` runs
it for several checkouts in turns.  The third runs phases 1 and 5 and
prints the runner's JSON line and the card's line.

Phases, each of which raises on failure (so no result line follows a
failure):

1. build the CUDA kernels of `t41x_torch/csrc/` (nvcc, sm_90a) and time it;
2. hold each kernel against its plain torch version on the card at the
   main path's shapes (1024 channels, 3 streamed blocks): K1 the fused
   front end in its four variants (zoom None/0 x complex64/q15) and its
   zoom 2^z variant K1z (zoom 1, 3, 7 complex64, zoom 1 q15), K2 the
   AGC block, K3 the output interpolation, K4 the overlap-save matmul,
   K5 the AGC recurrence of 64-sample blocks, K6 the SAM PLL, K7 the LMS
   in NR and notch form, K8 the Kim NR gains; and time each: its device
   time per launch (torch.profiler, 20 launches after 3 warm-up, L2
   flushed before each, so that its inputs come from device memory), its
   wrapper and its plain version (CUDA events, median of 25 runs after
   warm-up, 5 for the plain versions of the per-sample recurrences), the
   plain version's device time for K1, K3 and K4, and for K3 and K4 the
   one PyTorch call that computes the same function (K3: a stride-8
   `conv_transpose1d` with the two stages' composed taps; K4: the cuBLAS
   product on the concatenated input; no other kernel has one).  K3 runs
   on a contiguous row and on the real part of a complex64 row, as the
   chain calls it, and is timed on the latter.  K2, K5, K6, K7 and
   K8 must equal their plain versions bit for bit (K2 and K5 from random
   carried states that reach all five AGC states), and the `clock64`
   split per phase of K2, K3, K5, K6 and K7 (cold and warm) goes to the
   log.  Each kernel's bound is the larger of the operations its
   function needs over the card's fp32 peak (67 TFLOP/s) and its bytes
   (each input read once, each output written once) over its memory
   rate (3.35 TB/s);
3. drive the main paths — `RxChain.block` with `use_kernels=True` — at
   1024 channels x 12 blocks (8 for the slice-1 and -2 waveform specs):
   the flagship spec (usb, zoom-x1 panadapter, audio-spectrum taps, x8
   interpolation), the headless spec (`spectrum_taps=False`), both with
   q15 ingest, then am, sam,
   nfm (with and without display taps), Kim, spectral and LMS NR, the
   notch, ft8, psk31, the zoom 2^z panadapter (zoom 1, 3, 7, zoom 1 with
   q15), the radio's default spec, cw, the receive EQ and the noise
   blanker; and one short-block AGC path (`agc_apply` over 64-sample
   pieces, K5).  Each path's kernel launches are counted in its run
   (every count is set to 0 just before it), and its outputs are held
   against the same path with plain versions on the card: audio >= 55 dB
   SNR and displayed spectrum <= 0.5 dB, or, for the adaptive stages
   (SAM PLL, LMS, notch), the audio power spectrum of the last 2 blocks
   within 3 dB and SAM's carrier within 0.1 Hz; CW keying equal; plus
   finite values of the expected shapes;
4. time the chain with kernels and with plain versions (complex input
   samples per second): the rx spec at 1024 and 4096 channels, the
   headless spec, the radio's default spec, sam, Kim and LMS NR and the
   notch at 1024; then, for the same seven specs at 1024 channels, the
   device time per block of each CUDA kernel under `torch.profiler`, and
   the number of device kernels a block;
5. drive the host layers at 1024 channels (`host_layers`): a `Radio` on
   the card and its `StreamRunner`, which captures one CUDA graph a
   chain spec and replays it, fed through the native `BlockRing`: (a)
   16 blocks, then a band and mode change (a new graph) and 8 more, held
   against the eager `RxChain.block` loop with the radio's parameters
   (audio, last RF spectrum, S-meter, blocks processed; bit for bit
   reported, the North-star bounds required), the kernel launches
   counted; (b) the same stream in batches of 4; (c) a checkpoint saved
   at block 8 and resumed by a fresh runner; (d) K1z's, K2's and (sam)
   K6's kernels found inside 16 replays by `torch.profiler`, with no
   wrapper launched; (e) ms a
   block and the device's idle share over 64 blocks for the default
   spec and sam: the graphed runner, the eager runner and the bare
   `RxChain.block` loop; (f) a mono runner fed by `CaptureStreamer` at
   real time for 3 s with no overrun; (g) `python -m t41x_torch.cli rx`
   in a subprocess against `Radio.receive`, and `cli info`.

It prints the kernels' JSON line (per kernel: its launches and launches
per block on the main paths, max |err|, device ms a launch, the
wrapper's, the plain version's and the library call's times, its flops,
bytes and bound), phase 5's `{"runner": ...}` line, the card's name and
power limit as
`nvidia-smi` gives them, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a card, or outside the repository, it exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_CH = 1024
N_BLOCKS = 12       # per spec: >= 12 for the adaptive stages' lock
N_BLOCKS_SHORT = 8  # the slice-1 and -2 waveform specs (no lock to wait for)
AGC_PIECE = 64      # the short-block AGC path's block length (K5)
RATE_CHANNELS = (1024, 4096)
REPS = 25
REPS_PLAIN = 5      # the per-sample plain recurrences (K2, K5, K6, K7)
#                     take up to ~0.4 s a call

# (name, source, TPU kernel it replaces)
K1 = ("t41x_torch/csrc/frontend.cu",
      "t41x/kernels/frontend_pallas.py:280")
K2 = ("t41x_torch/csrc/agc.cu", "t41x/kernels/agc_pallas.py:95")
K5 = ("t41x_torch/csrc/agc.cu", "t41x/kernels/agc_pallas.py:38")
K3 = ("t41x_torch/csrc/interp.cu", "t41x/kernels/interp_pallas.py:61")
K4 = ("t41x_torch/csrc/os_filter.cu", "t41x/kernels/os_filter_pallas.py:32")
K6 = ("t41x_torch/csrc/sam.cu", "t41x/kernels/sam_pallas.py:32")
K7 = ("t41x_torch/csrc/xanr.cu", "t41x/kernels/xanr_pallas.py:35")
K8 = ("t41x_torch/csrc/nr_gain.cu", "t41x/kernels/nr_gain_pallas.py:35")

# the main paths: ChainSpec keywords, parity measure, and the kernels that
# must launch
SPECS = {
    "rx": (dict(mode="usb", spectrum_zoom=0), "waveform",
           ("K1", "K2", "K3")),
    "rx_q15": (dict(mode="usb", spectrum_zoom=0, q15_input=True,
                    clip_taps=True), "waveform", ("K1", "K2", "K3")),
    "headless": (dict(mode="usb", spectrum_taps=False), "waveform",
                 ("K1", "K2", "K3", "K4")),
    "headless_q15": (dict(mode="usb", spectrum_taps=False, q15_input=True),
                     "waveform", ("K1", "K2", "K3", "K4")),
    "am": (dict(mode="am"), "waveform", ("K1", "K2", "K3")),
    "sam": (dict(mode="sam", f_lo=-3000.0, f_hi=3000.0), "adaptive",
            ("K1", "K2", "K3", "K6")),
    "nfm": (dict(mode="nfm"), "waveform", ("K1", "K2", "K3")),
    "nfm_headless": (dict(mode="nfm", spectrum_taps=False), "waveform",
                     ("K1", "K2", "K3", "K4")),
    "nr_kim": (dict(mode="usb", nr_mode=1), "waveform",
               ("K1", "K2", "K3", "K8")),
    "nr_spectral": (dict(mode="usb", nr_mode=2), "waveform",
                    ("K1", "K2", "K3")),
    "nr_lms": (dict(mode="usb", nr_mode=3), "adaptive",
               ("K1", "K2", "K3", "K7")),
    "notch": (dict(mode="usb", notch_on=True), "adaptive",
              ("K1", "K2", "K3", "K7")),
    "ft8": (dict(mode="ft8"), "waveform", ("K1", "K2", "K3")),
    "psk31": (dict(mode="psk31"), "waveform", ("K1", "K3")),
    "zoom1": (dict(mode="usb", spectrum_zoom=1), "waveform",
              ("K1", "K2", "K3")),
    "zoom3": (dict(mode="usb", spectrum_zoom=3), "waveform",
              ("K1", "K2", "K3")),
    "zoom7": (dict(mode="usb", spectrum_zoom=7), "waveform",
              ("K1", "K2", "K3")),
    # the spec t41x.radio.Radio.chain builds from a default RadioConfig:
    # no output interpolation, so K3 does not run
    "radio_default": (dict(mode="usb", f_lo=200.0, f_hi=3000.0, agc_mode=2,
                           spectrum_zoom=1, interpolate_out=False),
                      "waveform", ("K1", "K2")),
    "zoom1_q15": (dict(mode="usb", spectrum_zoom=1, q15_input=True),
                  "waveform", ("K1", "K2", "K3")),
    "cw": (dict(mode="cw", cw_filter_index=2), "waveform",
           ("K1", "K2", "K3")),
    "eq": (dict(mode="usb", eq_on=True), "waveform", ("K1", "K2", "K3")),
    "nb": (dict(mode="usb", nb_on=True), "waveform", ("K1", "K2", "K3")),
}
# the slice-1 and -2 waveform specs, which run N_BLOCKS_SHORT blocks
SHORT_SPECS = ("rx", "rx_q15", "headless", "headless_q15", "am", "nfm",
               "nfm_headless", "nr_kim", "nr_spectral", "ft8", "psk31")
# the specs phase 4 times and profiles
TIMED = ("rx", "headless", "radio_default", "sam", "nr_kim", "nr_lms",
         "notch")

# the card's published peaks (NVIDIA H100 SXM data sheet, 700 W): fp32
# outside the tensor cores, and HBM3
PEAK_FP32 = 67e12   # flop/s
PEAK_HBM = 3.35e12  # bytes/s

# the kernels' names in the profiler, by row prefix
KERNEL_NAMES = {"K1": "frontend_kernel", "K2": "agc_kernel",
                "K3": "interp_kernel", "K4": "os_filter_kernel",
                "K5": "agc_scan_kernel", "K6": "sam_kernel",
                "K7": "xanr_kernel", "K8": "kim_gain_kernel"}


def k1_flops(n_ch: int, zoom=None, n: int = 2048, t1: int = 28,
             t2: int = 46, zoom_stages: int = 4, zoom_taps: int = 4) -> dict:
    """fp32 operations the fused front end's function needs per block (K1,
    K1z with zoom >= 1), by part; an FMA counts 2.  These are the
    operations of the sample-by-sample recurrences and filters, not of
    the kernel's chunk-parallel form (whose DC particular solution alone,
    a 127-tap convolution, does ~13 times the biquad's work).  `sincosf`
    is not counted."""
    parts = {
        "gain_iq_correction": n * (2 + 3),
        # the DC-block biquad: 5 FMAs a sample, I and Q
        "dc_biquad": n * 2 * 5 * 2,
        # nco_gain scaling (2) and the complex rotation (6) per sample
        "nco": n * 8,
        "decimate_x4": (n // 4) * t1 * 2 * 2,
        "decimate_x2": (n // 8) * t2 * 2 * 2,
    }
    if zoom is not None and zoom >= 1:
        # the anti-alias IIR (biquad sections at the RF rate) and the
        # FIR decimator's outputs, I and Q
        parts["zoom_iir"] = n * 2 * zoom_stages * 5 * 2
        parts["zoom_fir"] = (n >> zoom) * zoom_taps * 2 * 2
    return {k: v * n_ch for k, v in parts.items()}


def k4_flops(n_ch: int, half: int = 256) -> int:
    """fp32 operations of y = [h | x] @ W.T: 4 real FMAs per complex
    multiply-add, (C, half) x (half, 2 half)."""
    return 8 * n_ch * half * 2 * half


def k3_flops(n_ch: int, n: int = 256, t1: int = 48, t2: int = 32) -> int:
    """fp32 operations of the x2 then x4 polyphase interpolation and the
    volume: t/L taps per output of an L-fold stage, an FMA counts 2."""
    return n_ch * (2 * (2 * n * (t1 // 2) + 8 * n * (t2 // 4)) + 8 * n)


def k3_library_taps(h1: np.ndarray, h2: np.ndarray):
    """K3's two stages (x2 with taps h1, then x4 with h2) as one x8
    interpolator: the composed taps h8 = h2 * (h1 zero-stuffed by 4), in
    float64, and the input-rate history that a stride-8 transposed
    convolution needs for them, (len(h8) - 1) // 8 samples."""
    stuffed = np.zeros(4 * (len(h1) - 1) + 1, np.float64)
    stuffed[::4] = h1
    h8 = np.convolve(np.asarray(h2, np.float64), stuffed)
    return h8, (len(h8) - 1) // 8


# per-element operation counts of the other kernels, from their plain
# versions' arithmetic (their bound is their bytes by a wide margin)
OPS_PER_ELEMENT = {
    "K2": 40,      # per complex sample: |x|, ring max, the gain step
    "K5": 30,      # per sample: the gain step alone
    "K6": 60,      # per sample: mix, atan series (15 FMAs), loop filter
    "K7": 4 * 64 + 16,  # per sample: 64-tap prediction and update
    "K8": 40,      # per bin and hop: minimum statistics, Wiener rule
}


def bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the fp32 peak and the bytes (each input read once, each output
    written once) over the HBM rate."""
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_HBM
    by_ops = t_ops >= t_bytes
    return dict(flops=float(flops), bytes=float(nbytes),
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if by_ops else "bytes")


def log(msg: str) -> None:
    print(msg, flush=True)


L2_FLUSH_BYTES = 256 << 20  # five times the card's 50 MB L2
PROFILER_TRIES = 5
_flush = {}  # the flush buffer, and the profiler's names of its kernels


def l2_flush() -> None:
    """Read a buffer five times L2's size (its max), so that what the
    next kernel reads comes from device memory; a read leaves no dirty
    line for that kernel to write back."""
    import torch
    if "buf" not in _flush:
        _flush["buf"] = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8,
                                    device="cuda")
    _flush["buf"].max()


def kernel_us(body, n: int, check=None):
    """Each CUDA kernel `body` launches, by name: (device µs a launch,
    launches a call), over `n` calls under torch.profiler; and the
    seconds the calls took on the host clock, up to the card's end of
    them.  The profiler can miss a session's first kernels, or deliver a
    session's kernels into the next one: so a kernel's time is its mean
    over the launches the session holds, its launches a call the whole
    number m nearest its count over `n`, and a session in which a count
    lies more than a tenth of max(m, 1) n from m n, or that fails
    `check`, is run again.  Counts below n/10 are strays of an earlier
    session."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                body()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        counts = {ev.key: ev.count for ev in evs}
        per = {ev.key: (ev.device_time_total / ev.count,
                        round(ev.count / n))
               for ev in evs if round(ev.count / n) >= 1}
        if per and all(abs(c - round(c / n) * n) <= max(round(c / n), 1)
                       * n / 10 for c in counts.values()) and (
                check is None or check(per)):
            return per, wall
    raise RuntimeError(f"kernel_us: no whole profile in {PROFILER_TRIES} "
                       f"sessions of {n} calls; kernel counts {counts}")


def device_us(fn, match=None, reps: int = 20) -> float:
    """Device time per call of the CUDA kernels `fn` launches whose name
    holds `match` (all of them when None): `reps` calls after 3 warm-up
    calls, with L2 flushed before each, so that what `fn` reads comes
    from device memory as its bound assumes, not from the last call
    (`l2_flush`)."""
    import torch
    if "keys" not in _flush:
        _flush["keys"] = set(kernel_us(l2_flush, reps)[0])
    flush, keys = l2_flush, _flush["keys"]
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def flushed():
        flush()
        fn()

    def whole(per):
        # the flush's kernels once a call (twice would be `fn` launching
        # one of them too), and a kernel of `fn`'s own that holds `match`
        return all(per.get(k, (0, 0))[1] == 1 for k in keys) and any(
            k not in keys and (match is None or match in k) for k in per)

    per, _ = kernel_us(flushed, reps, whole)
    return sum(us * m for k, (us, m) in per.items()
               if k not in keys and (match is None or match in k))


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


HOST_BLOCKS = (16, 8)   # phase 5: blocks before and after the spec change
HOST_BATCH = 4
HOST_TIMED = 64         # blocks a timed run
HOST_PROFILED = 16      # blocks a profiled run
REALTIME_S = 3.0


def host_layers(dev, card: str, n_ch: int, stim, counts) -> dict:
    """Phase 5, the host layers at `n_ch` channels: the live path
    `BlockRing` -> `StreamRunner` (one CUDA graph a chain spec) ->
    display taps, S-meter and audio, held against the eager
    `RxChain.block` loop; batches; a checkpoint round trip; the kernels
    inside the replays (profiler); the runner's times; a real-time run
    fed by `CaptureStreamer`; and the CLI.  `stim(n)` gives n host blocks
    (n_ch, BLOCK) of complex64, `counts` the (reset, read) pair of the
    kernel launch counters.  Raises on any failure; returns the figures.
    On a CPU device (a rehearsal) the runner runs eagerly and the
    profiler and timing parts are left out."""
    import os
    import tempfile

    import torch

    from t41x_torch import constants as C
    from t41x_torch.chain import RxChain
    from t41x_torch.config import RadioConfig
    from t41x_torch.dsp.spectrum import smeter_dbm
    from t41x_torch.io import runtime, wav
    from t41x_torch.radio import Radio
    from t41x_torch.runner import StreamRunner
    from t41x_torch.utils import checkpoint, parity

    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"
    reset_counts, read_counts = counts
    n_first, n_after = HOST_BLOCKS
    blocks = stim(n_first + n_after)
    segments = (blocks[:n_first], blocks[n_first:])
    result = {"card": card, "channels": n_ch}

    def runner_for(radio, batch=1, graphs=True, capacity=n_first + 4):
        ring = runtime.BlockRing(block_floats=2 * C.BLOCK_SIZE * n_ch,
                                 capacity=capacity)
        r = StreamRunner(radio, ring=ring, channels=(n_ch,),
                         batch_blocks=batch, graphs=graphs)
        r.keep_audio = True
        return r

    def feed(runner, seg):
        for blk in seg:
            if not runner.ring.push(blk.view(np.float32).reshape(-1)):
                raise AssertionError("phase 5: the ring refused a block")
        return runner.drain()

    def stream(batch):
        """The two segments through a graphed runner, 20M usb then 40M
        lsb; returns the runner and each segment's (spec, params)."""
        radio = Radio(device=dev)
        runner = runner_for(radio, batch)
        used = []
        for i, seg in enumerate(segments):
            if i == 1:
                radio.set_band("40M")
                radio.set_mode("lsb")
            used.append((radio.chain.spec, radio.params((n_ch,))))
            if feed(runner, seg) != len(seg):
                raise AssertionError(f"phase 5: batch {batch} drained short")
        return runner, used

    def host(out):
        return {k: v.cpu().numpy() for k, v in out.items()}

    def eager(spec, params, seg):
        chain = RxChain(spec, device=dev)
        st = chain.init_state((n_ch,))
        outs = []
        for blk in seg:
            st, out = chain.block(params, st, torch.from_numpy(blk).to(dev))
            outs.append(host(out))
        return st, outs

    def agree(name, want, got, kind):
        """Exact, or within the North-star bound of `kind` (raises
        otherwise); returns the figures: audio SNR in dB, displayed
        spectrum error in dB, S-meter difference in dB."""
        exact = bool(np.array_equal(want, got))
        if kind == "audio":
            d = parity.snr_db(want, got)
            ok = d >= parity.AUDIO_SNR_MIN_DB
        elif kind == "spectrum_db":
            d = parity.spectrum_err_db(10 ** (want / 10), 10 ** (got / 10))
            ok = d <= parity.SPECTRUM_ERR_MAX_DB
        else:  # S-meter, dB
            d = abs(float(want) - float(got))
            ok = d <= 0.01
        if not ok:
            raise AssertionError(f"phase 5 {name}: {kind} parity {d}")
        # an exact match has an infinite SNR, which JSON cannot hold
        return {"bit_for_bit": exact, "err": None if exact else d}

    # (a) the graphed runner against the eager chain, with a spec change
    reset_counts()
    t0 = time.perf_counter()
    run_a, used = stream(1)
    if cuda:
        torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches = read_counts()
    for k in ("K1", "K2") if cuda else ():
        if launches[k] == 0:
            raise AssertionError(f"phase 5: kernel {k} was not launched")
    ref = [eager(spec, pr, seg) for (spec, pr), seg in zip(used, segments)]
    ref_audio = np.concatenate([o["audio_24k"] for _, outs in ref
                                for o in outs])
    last = ref[-1][1][-1]
    if run_a.blocks_processed != n_first + n_after:
        raise AssertionError(f"phase 5: {run_a.blocks_processed} blocks")
    result["a"] = {
        "blocks": run_a.blocks_processed, "wall_s": wall_a,
        "graphs_captured": sorted(run_a._graph_of),
        "launches": launches,
        "audio": agree("audio", ref_audio, run_a.audio, "audio"),
        "rf_spectrum": agree("rf", 10 * np.log10(last["rf_spectrum"]
                                                 + 1e-12),
                             run_a.last_rf_spectrum_db, "spectrum_db"),
        "smeter_dbm": agree("S-meter", float(smeter_dbm(torch.from_numpy(
            last["smeter_avg"][:1]))), run_a.last_smeter_dbm, "smeter"),
        "state": all(bool(torch.equal(a, b)) for (_, a), (_, b) in zip(
            checkpoint.flatten_with_path(run_a.state),
            checkpoint.flatten_with_path(ref[-1][0]), strict=True)),
    }
    log(f"# phase 5 (a) runner vs eager: {result['a']}")

    # (b) the same stream in batches of HOST_BATCH
    run_b, _ = stream(HOST_BATCH)
    result["b"] = {"audio": agree(
        "batched audio", np.concatenate(run_a.audio_chunks, axis=-1),
        np.concatenate(run_b.audio_chunks, axis=-1), "audio"),
        "graphs_captured": sorted(run_b._graph_of),
        "blocks": run_b.blocks_processed}
    if run_b.blocks_processed != run_a.blocks_processed:
        raise AssertionError("phase 5 (b): blocks differ")
    log(f"# phase 5 (b) batches of {HOST_BATCH} vs (a): {result['b']}")
    del run_b

    # (c) a checkpoint at block n_first / 2, resumed by a fresh runner
    half = n_first // 2
    first = runner_for(Radio(device=dev))
    feed(first, segments[0][:half])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        checkpoint.save_state(path, first.state,
                              extra={"blocks": first.blocks_processed})
        resumed = runner_for(Radio(device=dev))
        state, meta = checkpoint.load_state(path, resumed.state)
    resumed.state = state
    resumed.blocks_processed = meta["blocks"]
    feed(resumed, segments[0][half:])
    result["c"] = {"audio": agree(
        "resumed audio", np.concatenate(run_a.audio_chunks[half:n_first]),
        resumed.audio, "audio"), "blocks": resumed.blocks_processed}
    if resumed.blocks_processed != n_first:
        raise AssertionError("phase 5 (c): blocks differ")
    log(f"# phase 5 (c) checkpoint at block {half}: {result['c']}")
    del first, resumed

    def steps(runner):
        """A body that pushes one block and steps, cycling the stream."""
        it = iter(range(10 ** 9))

        def body():
            blk = blocks[next(it) % len(blocks)]
            runner.ring.push(blk.view(np.float32).reshape(-1))
            if runner.step() is None:
                raise AssertionError("phase 5: step found no block")
        return body

    # (d) the hand-written kernels inside the replays
    if cuda:
        result["d"] = {}
        radio = Radio(device=dev)
        runner = runner_for(radio)
        for mode, need in ((None, ("frontend_kernel", "agc_kernel")),
                           ("sam", ("frontend_kernel", "agc_kernel",
                                    "sam_kernel"))):
            if mode:
                radio.set_mode(mode)
            body = steps(runner)
            body()                       # the capture
            torch.cuda.synchronize()
            reset_counts()
            per, _ = kernel_us(body, HOST_PROFILED)
            # no wrapper ran: every kernel the profiler saw was replayed
            python_launches = sum(read_counts().values())
            seen = {n: sum(m for k, (_, m) in per.items() if n in k)
                    for n in need}
            if min(seen.values()) < 1 or python_launches:
                raise AssertionError(
                    f"phase 5 (d) {mode or 'default'}: kernels a replay "
                    f"{seen}, wrapper launches {python_launches}; "
                    f"{list(per)}")
            result["d"][mode or "default"] = {
                "kernels_a_replay": seen,
                "wrapper_launches": python_launches}
        log(f"# phase 5 (d) kernels in {HOST_PROFILED} replays: "
            f"{result['d']}")
        del runner

    # (e) times: the graphed and the eager runner, and the bare chain loop
    if cuda:
        result["e"] = {}
        for name, mode in (("default", None), ("sam", "sam")):
            figures = {}
            for kind in ("graphed", "eager"):
                radio = Radio(device=dev)
                if mode:
                    radio.set_mode(mode)
                runner = runner_for(radio, graphs=kind == "graphed",
                                    capacity=8)
                runner.keep_audio = False
                runner.prime()
                body = steps(runner)
                for _ in range(3):
                    body()
                # the runner's own time: `step` (pop, stage, replay or
                # the eager chain, read back; it ends in a sync), the
                # source's push outside it as a producer thread's is
                t_push = t_step = 0.0
                for b in range(HOST_TIMED):
                    blk = blocks[b % len(blocks)].view(np.float32)
                    t0 = time.perf_counter()
                    runner.ring.push(blk.reshape(-1))
                    t1 = time.perf_counter()
                    runner.step()
                    t_push += t1 - t0
                    t_step += time.perf_counter() - t1
                ms = t_step / HOST_TIMED * 1e3
                per, wall = kernel_us(body, HOST_PROFILED)
                figures[kind] = _busy(per, ms, wall / HOST_PROFILED)
                figures[kind]["push_ms_a_block"] = t_push / HOST_TIMED * 1e3
                figures[kind]["load_percent"] = runner.load.percent
                if kind == "graphed":
                    figures["graphed_step_split_ms"] = _step_split(
                        runner, blocks[0])
                del runner
            spec = Radio(device=dev)
            if mode:
                spec.set_mode(mode)
            chain = RxChain(spec.chain.spec, device=dev)
            pr = spec.params((n_ch,))
            blk = torch.from_numpy(blocks[0]).to(dev)
            st = [chain.init_state((n_ch,))]

            def bare():
                st[0] = chain.block(pr, st[0], blk)[0]
            for _ in range(3):
                bare()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_TIMED):
                bare()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / HOST_TIMED * 1e3
            per, wall = kernel_us(bare, HOST_PROFILED)
            figures["bare_chain_loop"] = _busy(per, ms, wall / HOST_PROFILED)
            result["e"][name] = figures
            log(f"# phase 5 (e) {name}, {n_ch} channels, ms a block and "
                f"device idle share ({card}): {figures}")

    # (f) real time: a mono capture paced at rate_factor 1
    n_rt = int(REALTIME_S * C.SAMPLE_RATE) // C.BLOCK_SIZE
    mono = np.concatenate([b[0] for b in blocks] * (
        -(-n_rt // len(blocks))))[: n_rt * C.BLOCK_SIZE]
    radio = Radio(device=dev)
    runner = StreamRunner(radio)
    runner.prime()
    streamer = runtime.CaptureStreamer(runner.ring, mono, rate_factor=1.0)
    t0 = time.perf_counter()
    try:
        while streamer.running or runner.ring.available():
            if runner.step() is None:
                time.sleep(0.0005)
            if time.perf_counter() - t0 > 4 * REALTIME_S + 10:
                raise AssertionError("phase 5 (f): the stream did not end")
    finally:
        streamer.stop()
    result["f"] = {"blocks": runner.blocks_processed, "expected": n_rt,
                   "overruns": runner.ring.overruns,
                   "load_percent": runner.load.percent,
                   "ring": ("native" if runtime.native_available()
                            else "python"),
                   "wall_s": time.perf_counter() - t0}
    log(f"# phase 5 (f) real time, {REALTIME_S} s at rate_factor 1: "
        f"{result['f']}")
    if runner.ring.overruns or runner.blocks_processed != n_rt:
        raise AssertionError(f"phase 5 (f): {result['f']}")
    del runner, streamer

    # (g) the CLI in a subprocess, against Radio.receive
    root = Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        cap, out = os.path.join(tmp, "cap.wav"), os.path.join(tmp, "out.wav")
        want_wav = os.path.join(tmp, "want.wav")
        iq = mono[: 12 * C.BLOCK_SIZE]
        wav.write_iq_wav(cap, iq, C.SAMPLE_RATE)
        iq, _ = wav.read_iq_wav(cap)
        cmd = [sys.executable, "-m", "t41x_torch.cli", "rx", "--in", cap,
               "--out", out, "--device", str(dev)]
        res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"phase 5 (g): cli rx failed: {res.stderr}")
        audio = Radio(device=dev).receive(iq)["audio_24k"]
        wav.write_wav(want_wav, audio / (1.05 * float(abs(audio).max()
                                                      or 1.0)), 24000)
        got, want = wav.read_wav(out)[0], wav.read_wav(want_wav)[0]
        info = subprocess.run([sys.executable, "-m", "t41x_torch.cli",
                               "info"], cwd=root, capture_output=True,
                              text=True, timeout=600)
        if info.returncode != 0 or json.loads(info.stdout) != \
                RadioConfig().to_dict():
            raise AssertionError(f"phase 5 (g): cli info: {info.stderr}")
    result["g"] = {"rx_audio": agree("cli rx", want, got, "audio"),
                   "rx_stdout": res.stdout.strip().splitlines()[0],
                   "info": "equal to RadioConfig().to_dict()"}
    log(f"# phase 5 (g) cli: {result['g']}")
    result["seconds"] = time.perf_counter() - t_phase
    return result


def _step_split(runner, blk, reps: int = 16) -> dict:
    """Where a graphed `step` spends its time, its parts one by one on
    the runner's own objects (host clock, ms, median of `reps`): the
    ring pop, the copy into the pinned buffer, the host-to-device copy,
    `Radio.params` and their copy into the graph, the replay, the
    read-back of the display taps and the RF tap's dB on the host."""
    import torch

    g = runner._graph_of["block"]
    flat = blk.view(np.float32).reshape(-1)
    sync = torch.cuda.synchronize

    def popped():
        runner.ring.push(flat)
        t0 = time.perf_counter()
        runner.ring.pop_iq()
        return time.perf_counter() - t0

    def params():
        p = runner.radio.params(runner.channels)
        for static, v in zip(g.params, p):
            static.copy_(v)
        sync()

    parts = {"pop": popped,
             "stage": lambda: g.pinned.copy_(torch.from_numpy(blk)),
             "h2d": lambda: (g.iq.copy_(g.pinned, non_blocking=True),
                             sync()),
             "params": params,
             "replay": lambda: (g.graph.replay(), sync()),
             "read_back": lambda: [g.out[k].cpu() for k in (
                 "rf_spectrum", "audio_spectrum", "smeter_avg")
                 if k in g.out],
             # t41x's runner keeps the whole RF tap in dB on the host
             "rf_db": lambda: 10 * np.log10(rf + 1e-12)}
    rf = g.out["rf_spectrum"].cpu().numpy()
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            dt = fn()
            times.append(dt if name == "pop" else time.perf_counter() - t0)
        out[name] = float(np.median(times)) * 1e3
    return out


def _busy(per: dict, ms: float, wall_prof: float) -> dict:
    """A timed run's figures: ms a block on the host clock, and from the
    profiled run (a call: a runner's push and step, or the bare loop's
    block) the device µs a block in kernels and in copies, and the
    device's idle share of the unprofiled block."""
    kern = sum(us * m for k, (us, m) in per.items()
               if not k.startswith(("Memcpy", "Memset")))
    copies = sum(us * m for k, (us, m) in per.items()
                 if k.startswith(("Memcpy", "Memset")))
    return {"ms_a_block": ms, "device_kernel_us_a_block": kern,
            "device_copy_us_a_block": copies,
            "device_kernels_a_block": sum(
                m for k, (_, m) in per.items()
                if not k.startswith(("Memcpy", "Memset"))),
            "device_idle_share": 1.0 - (kern + copies) / (ms * 1e3),
            "ms_a_call_under_profiler": wall_prof * 1e3}


def main(argv: list[str]) -> int:
    import torch
    import torch.nn.functional as F

    root = None  # --kernels ROOT: phases 1 and 2 on ROOT's t41x_torch
    host_only = argv == ["--host"]  # phases 1 and 5
    if len(argv) == 2 and argv[0] == "--kernels":
        root = Path(argv[1]).resolve()
        sys.path.insert(0, str(root))
    elif argv and not host_only:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    try:
        from t41x_torch import constants as C
        from t41x_torch.chain import ChainSpec, RxChain, default_params
        from t41x_torch.demod import sam as sam_mod
        from t41x_torch.dsp import agc as agc_mod, nb as nb_mod, nr as nr_mod
        from t41x_torch.dsp.spectrum import ZoomFFT
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
    import t41x_torch
    if root is not None and not Path(t41x_torch.__file__).resolve(
            ).is_relative_to(root):
        print(f"chip_smoke: imported {t41x_torch.__file__}, not the one "
              f"in {root}", file=sys.stderr)
        return 2

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"# card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- 1. build -------------------------------------------------------
    _build.library()
    log(f"# build: {_build.build_seconds:.1f} s (nvcc sm_90a, "
        f"{len(list(_build.SRC_DIR.glob('*.cu')))} sources)")

    counters = {"K1": (kfe.FusedFrontEnd, "launches"),
                "K2": (kagc.agc_block, "launches"),
                "K3": (kint.FusedInterp, "launches"),
                "K4": (kos.os_filter_matmul_kernel, "launches"),
                "K5": (kagc.agc_scan, "launches"),
                "K6": (ksam.sam_block, "launches"),
                "K7": (kxanr.xanr_block, "launches"),
                "K8": (knr.kim_gains, "launches")}

    def reset_counts():
        for obj, attr in counters.values():
            setattr(obj, attr, 0)

    def read_counts():
        return {k: getattr(obj, attr) for k, (obj, attr) in counters.items()}

    gen = torch.Generator(device=dev).manual_seed(7)

    def cnoise(*shape, scale=1.0, g=gen):
        re = torch.randn(shape, generator=g, device=dev)
        im = torch.randn(shape, generator=g, device=dev)
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

    def stim(n_blocks):
        """Phase 3's stimulus as n_blocks host arrays (N_CH, BLOCK)."""
        return list(rf_blocks(N_CH, n_blocks).cpu().numpy())

    if host_only:
        print(json.dumps({"runner": host_layers(
            dev, card, N_CH, stim, (reset_counts, read_counts))}))
        print(card)
        return 0

    def time_ms(fn, reps=REPS):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
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

    def nbytes(*trees):
        return sum(t.numel() * t.element_size() for tree in trees
                   for t in leaves(tree) if isinstance(t, torch.Tensor))

    rows = []

    def row(name, src, fn_k, fn_p, err, tol, flops, ins, outs,
            plain_reps=REPS, plain_device=False, library=None):
        """One kernel's line: its device time (profiler), the wrapper's
        and the plain version's times (CUDA events), its bound from
        `flops` and the bytes of `ins` and `outs`, and the library
        call's device time where one PyTorch call computes the same."""
        dev_us = device_us(fn_k, KERNEL_NAMES[name[:2]])
        wrapper_ms = time_ms(fn_k)
        plain_ms = time_ms(fn_p, plain_reps)
        plain_dev = device_us(fn_p) / 1e3 if plain_device else None
        lib_ms = device_us(library) / 1e3 if library is not None else None
        b = bound(flops, nbytes(ins, outs))
        rows.append(dict(name=name, route="cuda", source=src[0],
                         replaces=src[1], launches=0, blocks=0,
                         max_abs_err=err, ms=dev_us / 1e3,
                         wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                         plain_device_ms=plain_dev, library_ms=lib_ms, **b))
        log(f"# {name}: max |err| {err:.3g} within rtol {tol[0]}, atol "
            f"{tol[1]}; device {dev_us:.2f} us a launch, bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}; {b['flops']:.4g} "
            f"flop, {b['bytes']:.4g} B); wrapper {wrapper_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms"
            + (f" ({plain_dev * 1e3:.2f} us on the device)"
               if plain_dev is not None else "")
            + (f", library call {lib_ms * 1e3:.2f} us" if lib_ms else "")
            + f" per call ({N_CH} channels, {card})")

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
                lambda: fe.block(p, st_k, iq), lambda: fe.plain(p, st_k, iq),
                err, (2e-4, 2e-5), sum(k1_flops(N_CH, zoom).values()),
                (iq, st_k, p[:5]), fe.block(p, st_k, iq), plain_device=True)

    # K1z: the zoom 2^z tap in the kernel (composed operator) against the
    # per-stage plain version; the 24 kHz output at K1's bounds, the
    # decimated zoom stream and both states at the state bounds
    for zoom, fmt in ((1, "c64"), (3, "c64"), (7, "c64"), (1, "q15")):
        zf = ZoomFFT(zoom)
        fe = kfe.FusedFrontEnd(rx.h1, rx.h2, rx.dc_b[0], rx.dc_a[0],
                               zoom=zoom, zoom_sos=(zf.iir_b, zf.iir_a),
                               zoom_h=zf.h)
        st_k = st_p = fe.init_state((N_CH,), dev)
        zst = zf.init_state((N_CH,), dev)
        z_k = z_p = (zst.iir, zst.dec)
        err = 0.0
        for b in range(3):
            iq = q15(blocks[b]) if fmt == "q15" else blocks[b]
            out_k = fe.block(p, st_k, iq, z_k)
            out_p = fe.plain(p, st_p, iq, z_p)
            st_k, st_p, z_k, z_p = out_k[0], out_p[0], out_k[3:], out_p[3:]
            err = max(err, close("K1z x", out_k[1], out_p[1], 2e-4, 2e-5))
            state_close("K1z zoom stream", out_k[2], out_p[2])
            state_close("K1z", st_k, st_p)
            state_close("K1z zoom state", z_k, z_p)
        iq = q15(blocks[0]) if fmt == "q15" else blocks[0]
        row(f"K1 frontend zoom={zoom} {fmt}", K1,
            lambda: fe.block(p, st_k, iq, z_k),
            lambda: fe.plain(p, st_k, iq, z_k), err, (2e-4, 2e-5),
            sum(k1_flops(N_CH, zoom, zoom_stages=zf.iir_b.shape[0],
                         zoom_taps=len(zf.h)).values()),
            (iq, st_k, p[:5], z_k),
            fe.block(p, st_k, iq, z_k), plain_device=True)

    # K2 and K5 are exact: every operation of the recurrence and the gain
    # curve is rounded alone on both sides.  The carried states start
    # random (any of the five AGC states, live hang counters, either
    # decay type) and the levels move between a burst and near silence,
    # so that every branch of the recurrence runs.  The states come from
    # a generator of their own, so the main paths' stimuli below stay
    # those of earlier trees.
    ap = agc_mod.agc_params(2)
    agc_gen = torch.Generator(device=dev).manual_seed(11)

    def agc_rand_state(n_ch):
        u = lambda lo, hi: lo + (hi - lo) * torch.rand(  # noqa: E731
            n_ch, generator=agc_gen, device=dev)
        ri = lambda hi: torch.randint(0, hi, (n_ch,), generator=agc_gen,  # noqa
                                      device=dev, dtype=torch.int32)
        ring = cnoise(n_ch, ap.attack_buffsize, scale=0.1, g=agc_gen)
        return agc_mod.AGCState(ring, ring.abs(), u(ap.min_volts, 1.5),
                                u(0.0, 1.5), u(0.0, 0.5), u(0.0, 0.1),
                                ri(300), ri(2), ri(5))

    levels = (0.001, 0.3, 0.0005)
    st_k = st_p = agc_rand_state(N_CH)
    err, seen = 0.0, set()
    for b in range(3):
        x2 = cnoise(N_CH, C.AUDIO_BLOCK, scale=levels[b])
        st_k, y_k = kagc.agc_block(ap, st_k, x2)
        st_p, y_p = kagc.agc_block_plain(ap, st_p, x2)
        err = max(err, close("K2 y", y_k, y_p, 0.0, 0.0))
        for f in st_p._fields:
            close(f"K2 {f}", getattr(st_k, f), getattr(st_p, f), 0.0, 0.0)
        seen |= set(st_p.state.unique().tolist())
    if seen != {0, 1, 2, 3, 4}:
        raise AssertionError(f"K2 check reached AGC states {sorted(seen)}")
    row("K2 agc_block", K2, lambda: kagc.agc_block(ap, st_k, x2),
        lambda: kagc.agc_block_plain(ap, st_k, x2), err, (0.0, 0.0),
        OPS_PER_ELEMENT["K2"] * x2.numel(), (x2, st_k),
        kagc.agc_block(ap, st_k, x2), plain_reps=REPS_PLAIN)

    # K5: the recurrence alone over 64-sample pieces at K2's levels, its
    # ring-max and |out| streams formed as agc_apply forms them
    st = agc_rand_state(N_CH)
    c_k = c_p = tuple(st[2:])
    ring, abs_ring = st.ring, st.abs_ring
    err = 0.0
    for b in range(3):
        x5 = cnoise(N_CH, AGC_PIECE, scale=levels[b])
        full = torch.cat([ring, x5], dim=-1)
        abs_full = torch.cat([abs_ring, x5.abs()], dim=-1)
        rm = agc_mod._sliding_window_max(abs_full, ap.attack_buffsize)[
            ..., 1: 1 + AGC_PIECE].T.contiguous()
        ao = abs_full[..., :AGC_PIECE].T.contiguous()
        ring, abs_ring = full[..., AGC_PIECE:], abs_full[..., AGC_PIECE:]
        c_k, v_k = kagc.agc_scan(ap, c_k, rm, ao)
        c_p, v_p = kagc.agc_scan_plain(ap, c_p, rm, ao)
        err = max(err, close("K5 volts", v_k, v_p, 0.0, 0.0))
        for i, (a, r) in enumerate(zip(c_k, c_p)):
            close(f"K5 carry[{i}]", a, r, 0.0, 0.0)
    row("K5 agc_scan", K5, lambda: kagc.agc_scan(ap, c_k, rm, ao),
        lambda: kagc.agc_scan_plain(ap, c_k, rm, ao), err, (0.0, 0.0),
        OPS_PER_ELEMENT["K5"] * rm.numel(), (c_k, rm, ao),
        kagc.agc_scan(ap, c_k, rm, ao), plain_reps=REPS_PLAIN)

    def log_phases(name, fn, names, loop=None, steps=1):
        """Where a kernel's time goes: clock64 stamps per phase, mean over
        the blocks of 10 launches, cold (L2 flushed before each) and
        warm; the `loop` phase, where there is one, also in cycles a
        step."""
        for temp in ("cold", "warm"):
            fn()
            stamps = []
            for _ in range(10):
                if temp == "cold":
                    l2_flush()
                stamps.append(fn())
            split = kagc.phase_split(torch.cat(stamps), names)
            ghz = split["sm_ghz"]
            step = (f"; {loop} {split[loop] * 1e3 * ghz / steps:.1f} cycles "
                    f"a step" if loop else "")
            log(f"# {name} phases {temp}, us a block: " + ", ".join(
                f"{k} {split[k]:.3f}" for k in (*names, "block"))
                + f"{step} at {ghz:.3f} GHz ({N_CH} channels, {card})")

    if hasattr(kagc, "agc_block_phases"):
        log_phases("K2", lambda: kagc.agc_block_phases(ap, st_k, x2)[2],
                   kagc.K2_PHASES, "recurrence", C.AUDIO_BLOCK)
        log_phases("K5", lambda: kagc.agc_scan_phases(ap, c_k, rm, ao)[2],
                   kagc.K5_PHASES, "recurrence", AGC_PIECE)

    # K3 on a contiguous row and, as the chain calls it, on the real part
    # of a complex64 block (`y.real`, element stride 2).  The imaginary
    # parts come from a generator of their own, so the draws of `gen`, and
    # the main paths' stimuli, stay those of earlier trees.
    fi = kint.FusedInterp(rx.hi1, rx.hi2)
    vol = torch.linspace(0.5, 2.0, N_CH, device=dev)
    k3_gen = torch.Generator(device=dev).manual_seed(13)
    z0 = (torch.zeros(N_CH, fi.sub1 - 1, device=dev),
          torch.zeros(N_CH, fi.sub2 - 1, device=dev))
    hk = hs = hp = z0
    err = 0.0
    for b in range(3):
        a = torch.randn(N_CH, C.AUDIO_BLOCK, generator=gen, device=dev) * 0.4
        ar = torch.complex(a, torch.randn(N_CH, C.AUDIO_BLOCK, generator=k3_gen,
                                          device=dev)).real
        *hk, y_k = fi.apply(a, *hk, vol)
        *hs, y_s = fi.apply(ar, *hs, vol)
        *hp, y_p = fi.plain(a, *hp, vol)
        for form, (h_k, yk) in (("", (hk, y_k)), (" y.real", (hs, y_s))):
            err = max(err, close(f"K3{form} y", yk, y_p, 2e-5, 2e-6))
            close(f"K3{form} int1", h_k[0], hp[0], 0.0, 0.0)
            close(f"K3{form} int2", h_k[1], hp[1], 2e-5, 2e-6)
    # the library call: the two stages and the volume are one linear x8
    # interpolator y = h8 * (x zero-stuffed by 8), h8 = h2 * (h1 zero-
    # stuffed by 4) of 47 * 4 + 1 + 32 - 1 = 220 taps, so one transposed
    # convolution of stride 8 over the block and its 27 samples of 24 kHz
    # history (cuDNN, fp32: TF32 is off); held against the plain version
    # from zero histories, and timed without the scale
    h8, hist = k3_library_taps(rx.hi1, rx.hi2)
    w8 = torch.from_numpy(h8.astype(np.float32)).to(dev)[None, None]
    xh = torch.cat([torch.zeros(N_CH, hist, device=dev), a], dim=-1)[:, None]
    y_lib = F.conv_transpose1d(xh, w8, stride=C.DF)[
        :, 0, C.DF * hist: C.DF * (hist + C.AUDIO_BLOCK)] * vol[:, None]
    lib_err = close("K3 library call", y_lib, fi.plain(a, *z0, vol)[2], 2e-5,
                    2e-6)
    log(f"# K3 library call (conv_transpose1d, {len(h8)} taps, stride "
        f"{C.DF}) vs plain from zero histories: max |err| {lib_err:.3g}")
    row("K3 interp", K3, lambda: fi.apply(ar, *hs, vol),
        lambda: fi.plain(ar, *hs, vol), err, (2e-5, 2e-6),
        k3_flops(N_CH, C.AUDIO_BLOCK, len(rx.hi1), len(rx.hi2)),
        (ar, hs, vol), fi.apply(ar, *hs, vol), plain_device=True,
        library=lambda: F.conv_transpose1d(xh, w8, stride=C.DF))
    if hasattr(kint, "interp_phases"):
        log_phases("K3", lambda: kint.interp_phases(fi, ar, *hs, vol)[3],
                   kint.K3_PHASES)

    W = rx.tensors["os_W"]
    # W's planes, packed once by the chain (a tree whose wrapper packs W
    # itself has none)
    wp = (rx.tensors["os_Wp"],) if "os_Wp" in rx.tensors else ()
    s_k = s_p = torch.zeros(N_CH, C.FFT_LENGTH // 2, dtype=torch.complex64,
                            device=dev)
    err = 0.0
    for b in range(3):
        x = cnoise(N_CH, C.FFT_LENGTH // 2, scale=0.3)
        s_k, y_k = kos.os_filter_matmul_kernel(s_k, x, W, *wp)
        s_p, y_p = kos.os_filter_matmul(s_p, x, W)
        err = max(err, close("K4 y", y_k, y_p, 2e-3, 2e-4))
        close("K4 state", s_k, s_p, 0.0, 0.0)
    # the library call: one cuBLAS product on the concatenated input
    xw = torch.cat([s_k, x], dim=-1)
    row("K4 os_filter", K4,
        lambda: kos.os_filter_matmul_kernel(s_k, x, W, *wp),
        lambda: kos.os_filter_matmul(s_k, x, W), err, (2e-3, 2e-4),
        k4_flops(N_CH, C.FFT_LENGTH // 2), (s_k, x, W),
        kos.os_filter_matmul_kernel(s_k, x, W, *wp)[1], plain_device=True,
        library=lambda: xw @ W.T)

    # K6: a 120 Hz carrier, AM at 400 Hz, a level per channel, light
    # noise (tests/test_pallas_kernels.py's SAM stimulus).  Every
    # operation is rounded alone on both sides, and sin and cos are what
    # torch.sin and torch.cos give: bit for bit.
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
        err = max(err, close("K6 audio", a_k, a_p, 0.0, 0.0))
        for f in st_p._fields:
            close(f"K6 {f}", getattr(st_k, f), getattr(st_p, f), 0.0, 0.0)
    row("K6 sam_block", K6, lambda: ksam.sam_block(sp, st_k, y),
        lambda: ksam.sam_block_plain(sp, st_k, y), err, (0.0, 0.0),
        OPS_PER_ELEMENT["K6"] * y.numel(), (y, st_k),
        ksam.sam_block(sp, st_k, y), plain_reps=REPS_PLAIN)
    if hasattr(ksam, "sam_block_phases"):
        log_phases("K6", lambda: ksam.sam_block_phases(sp, st_k, y)[2],
                   ksam.K6_PHASES, "phase loop", C.AUDIO_BLOCK)

    # K7: noise at the level of the chain's audio; leak indices at the
    # two fixed points of the reference's lidx quirk (120: clamped at the
    # minimum, 200: pinned at the maximum), where rounding cannot move
    # them.  The kernel sums in torch.sum's order on the card and rounds
    # every product as the plain version does: bit for bit.
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
            err = max(err, close("K7 y", y_k, y_p, 0.0, 0.0))
            for f in st_p._fields:
                close(f"K7 {f}", getattr(st_k, f), getattr(st_p, f), 0.0,
                      0.0)
        row(f"K7 xanr {'notch' if notch else 'nr'}", K7,
            lambda: kxanr.xanr_block(xp, st_k, x),
            lambda: kxanr.xanr_block_plain(xp, st_k, x), err, (0.0, 0.0),
            OPS_PER_ELEMENT["K7"] * x.numel(), (x, st_k),
            kxanr.xanr_block(xp, st_k, x), plain_reps=REPS_PLAIN)
        if hasattr(kxanr, "xanr_block_phases"):
            log_phases(f"K7 {'notch' if notch else 'nr'}",
                       lambda: kxanr.xanr_block_phases(xp, st_k, x)[2],
                       kxanr.K7_PHASES, "loop", C.AUDIO_BLOCK)

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
    row("K8 kim_gains", K8, lambda: knr.kim_gains(kp, g_k, pw),
        lambda: knr.kim_gains_plain(kp, g_k, pw), err, (0.0, 0.0),
        OPS_PER_ELEMENT["K8"] * pw.numel(), (pw, g_k),
        knr.kim_gains(kp, g_k, pw))

    def profile(name, blk, pr):
        """Where the time goes on spec `name`: device time per block of
        each CUDA kernel, by name, and the number of kernels a block,
        under torch.profiler over 20 blocks after 5 warm-up blocks."""
        chain = RxChain(ChainSpec(use_kernels=True, **SPECS[name][0]),
                        device=dev)
        st = [chain.init_state((N_CH,))]

        def step():
            st[0] = chain.block(pr, st[0], blk)[0]

        for _ in range(5):
            step()
        torch.cuda.synchronize()
        per, wall = kernel_us(step, 20)
        dev_us = {k: us * m for k, (us, m) in per.items()}
        wall /= 20
        log(f"# profile {name}: {N_CH} ch, device "
            f"{sum(dev_us.values()):.1f} us/block in "
            f"{sum(m for _, m in per.values())} kernels, of wall "
            f"{wall * 1e6:.1f} us/block under the profiler ({card})")
        for k, us in sorted(dev_us.items(), key=lambda kv: -kv[1])[:12]:
            log(f"#   {us:10.1f} us/block  {k[:110]}")

    if root is not None:
        # the flagship and headless blocks' kernels, for kernel_ab.py
        blk, pr = rf_blocks(N_CH, 1)[0], params(N_CH)
        for name in ("rx", "headless"):
            profile(name, blk, pr)
        for r in rows:
            del r["blocks"]
        print(json.dumps({"kernels": rows}))
        print(card)
        return 0

    # ---- 3. the main path, through the kernels ----------------------------
    def feed(counts, fed, n_blocks):
        """Add a path's launches, and the blocks it ran, to the rows of
        the variants it ran."""
        for r in rows:
            k = r["name"][:2]
            if fed.get(k, r["name"]) == r["name"] and counts[k]:
                r["launches"] += counts[k]
                r["blocks"] += n_blocks

    data = rf_blocks(N_CH, N_BLOCKS)
    data_q15 = q15(data)
    am_data = am_rf_blocks(N_CH, N_BLOCKS)
    # cw: a carrier 750 Hz above the Fs/4-shifted tuning (the sidetone),
    # keyed on and off every 2 blocks, in light noise
    t = torch.arange(N_BLOCKS * C.BLOCK_SIZE, device=dev,
                     dtype=torch.float64)
    key = ((t // (2 * C.BLOCK_SIZE)) % 2 == 0).to(torch.float64)
    car = torch.polar(0.3 * key, 2 * np.pi * (-C.SAMPLE_RATE / 4 + 750.0)
                      * t / C.SAMPLE_RATE).to(torch.complex64)
    cw_data = (car.reshape(N_BLOCKS, 1, C.BLOCK_SIZE)
               + cnoise(N_BLOCKS, N_CH, C.BLOCK_SIZE, scale=0.01)
               ).contiguous()
    # nb: the tone in noise plus impulses, off the block grid
    nb_data = data.clone()
    nb_data[:, :, 700::1300] += 4.0
    tuned = default_params((N_CH,), device=dev)
    p_eq = p._replace(eq_gains=torch.rand(N_CH, 14, generator=gen,
                                          device=dev))

    def stream(chain, src, pr, n_blocks):
        st = chain.init_state((N_CH,))
        outs = []
        for b in range(n_blocks):
            blk = (tuple(a[b] for a in src) if isinstance(src, tuple)
                   else src[b])
            st, out = chain.block(pr, st, blk)
            outs.append(out)
        return st, {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    def both(kw, src, pr, n_blocks):
        """The path with kernels (its launches counted) and with plain
        versions: (st_k, out_k, counts, st_p, out_p)."""
        chain_k = RxChain(ChainSpec(use_kernels=True, **kw), device=dev)
        chain_p = RxChain(ChainSpec(use_kernels=False, **kw), device=dev)
        reset_counts()
        st_k, out_k = stream(chain_k, src, pr, n_blocks)
        torch.cuda.synchronize()
        counts = read_counts()
        st_p, out_p = stream(chain_p, src, pr, n_blocks)
        return st_k, out_k, counts, st_p, out_p

    for name, (kw, measure, need) in SPECS.items():
        B = N_BLOCKS_SHORT if name in SHORT_SPECS else N_BLOCKS
        q = kw.get("q15_input", False)
        zoom = kw.get("spectrum_zoom", -1)
        taps = kw.get("spectrum_taps", True) and kw["mode"] != "psk31"
        if kw["mode"] == "sam":
            # tools/chipcheck.py's stimulus and default parameters: the
            # carrier sits 30 Hz off and every channel's PLL locks.  The
            # spread fine-tune of `params` would put it up to 670 Hz off,
            # where the loop slews and magnifies K1's ~1e-8 difference
            # from its plain version: t41x's own scan parts from itself
            # there by 32 dB of PSD when its input moves by one float32
            # ulp (tests/test_torch_sam_spread.py)
            src, pr = am_data, tuned
        elif kw["mode"] == "cw":
            src, pr = cw_data, tuned
        elif kw.get("nb_on"):
            src, pr = nb_data, p
        else:
            src, pr = (data_q15 if q else data), (p_eq if kw.get("eq_on")
                                                  else p)
        st_k, out_k, counts, st_p, out_p = both(kw, src, pr, B)
        for k in need:
            if counts[k] == 0:
                raise AssertionError(f"{name}: kernel {k} was not launched")
        # each launch goes to the row of the variant this spec runs
        feed(counts, {
            "K1": f"K1 frontend zoom={zoom if zoom >= 0 else None} "
                  f"{'q15' if q else 'c64'}",
            "K7": f"K7 xanr {'notch' if kw.get('notch_on') else 'nr'}"}, B)
        want = {"audio": (B, N_CH, C.BLOCK_SIZE
                          if kw.get("interpolate_out", True)
                          else C.AUDIO_BLOCK),
                "audio_24k": (B, N_CH, C.AUDIO_BLOCK)}
        if zoom >= 0:
            want["rf_spectrum"] = (B, N_CH, C.SPECTRUM_RES)
        if taps:
            want["audio_spectrum"] = (B, N_CH, C.FFT_LENGTH)
        if kw["mode"] == "sam":
            want["sam_carrier_hz"] = (B, N_CH)
        if kw["mode"] == "psk31":
            want["iq_baseband"] = (B, N_CH, C.AUDIO_BLOCK)
        if kw["mode"] == "cw":
            want["cw_combined"] = (B, N_CH)
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
            elif k == "cw_combined":
                # relative to the largest combined value of the run
                d = float((got - ref).abs().max() / ref.abs().max())
                report[k + "_rel_err"] = d
                ok = d <= 1e-4
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
        exact = (("adc_half_clip", "adc_quarter_clip") if kw.get("clip_taps")
                 else ()) + (("cw_keyed",) if kw["mode"] == "cw" else ())
        for k in exact:
            if out_k[k].shape != (B, N_CH) or not torch.equal(out_k[k],
                                                               out_p[k]):
                raise AssertionError(f"{name} {k} differs")
        if kw["mode"] == "cw":
            on = out_k["cw_keyed"].float().mean(dim=1)
            report["cw_keyed_share_per_block"] = [round(float(v), 3)
                                                  for v in on]
            if not (bool(on.max() == 1.0) and bool(on.min() == 0.0)):
                raise AssertionError(f"{name}: the keyed carrier was not "
                                     f"seen on and off: {on.tolist()}")
        if kw.get("nb_on"):
            # blanking decisions: the samples the blanker replaced, found
            # against the same chain without it (the blanker's input)
            pre = {k: v for k, v in kw.items() if k != "nb_on"}
            _, pre_k, _, _, pre_p = both(pre, src, pr, B)
            m_k = out_k["audio_24k"] != pre_k["audio_24k"]
            m_p = out_p["audio_24k"] != pre_p["audio_24k"]

            def regions(m):
                return int((m & ~torch.roll(m, 1, dims=-1)).sum())

            report["nb_blanked_regions"] = regions(m_p)
            report["nb_mask_samples_differ"] = int((m_k ^ m_p).sum())
            report["nb_regions_differ"] = regions(m_k ^ m_p)
            if regions(m_p) == 0:
                raise AssertionError(f"{name}: nothing was blanked")
        if measure == "waveform":
            state_close(f"{name} chain", st_k, st_p)
        log(f"# main path {name}: {N_CH} ch x {B} blocks, launches "
            f"{counts}, kernels vs plain on the card {report}")

    # the short-block AGC path: the same complex audio at 1024 channels
    # through agc_apply in 64-sample pieces (K5), against the plain
    # recurrence in the same pieces and against K2 in 256-sample blocks
    # (re-blocking changes nothing in exact arithmetic: the window peak is
    # exact and the recurrence runs per sample)
    agc_in = torch.cat([cnoise(N_CH, C.AUDIO_BLOCK, scale=lvl)
                        for lvl in (0.02, 0.5, 0.005)], dim=-1)

    def agc_stream(use_kernels, piece):
        st = agc_mod.agc_state(ap, (N_CH,), dev)
        ys = []
        for i in range(0, agc_in.shape[-1], piece):
            st, y = agc_mod.agc_apply(ap, st, agc_in[..., i:i + piece],
                                      use_kernels=use_kernels)
            ys.append(y)
        return st, torch.cat(ys, dim=-1)

    reset_counts()
    st_k, y_k = agc_stream(True, AGC_PIECE)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["K5"] == 0 or counts["K2"] != 0:
        raise AssertionError(f"short-block AGC path: launches {counts}")
    feed(counts, {}, agc_in.shape[-1] // C.AUDIO_BLOCK)
    st_p, y_p = agc_stream(False, AGC_PIECE)
    st_2, y_2 = agc_stream(True, C.AUDIO_BLOCK)
    report = {}
    for ref_name, st_r, y_r in (("plain", st_p, y_p), ("K2", st_2, y_2)):
        report[f"vs {ref_name} max |err|"] = close(
            f"short-block AGC y vs {ref_name}", y_k, y_r, 1e-6, 1e-7)
        for f in st_r._fields:
            close(f"short-block AGC {f} vs {ref_name}", getattr(st_k, f),
                  getattr(st_r, f), 1e-6, 1e-7)
    log(f"# main path agc_short: {N_CH} ch x {agc_in.shape[-1]} samples in "
        f"{AGC_PIECE}-sample pieces, launches {counts}, {report}")

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

    # where the time goes
    blk, pr = rf_blocks(N_CH, 1)[0], params(N_CH)
    for name in TIMED:
        profile(name, blk, pr)

    # ---- 5. the host layers -------------------------------------------------
    runner = host_layers(dev, card, N_CH, stim, (reset_counts, read_counts))

    for r in rows:
        r["launches_per_block"] = (r["launches"] / r["blocks"]
                                   if r["blocks"] else 0.0)
        del r["blocks"]
        if r["launches"] == 0:
            raise AssertionError(f"{r['name']}: launched on no main path")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"runner": runner}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
