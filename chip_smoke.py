#!/usr/bin/env python3
"""Drive t41x_torch's receive chain on one CUDA card and check it.

    python3 chip_smoke.py        (from the repository root; needs a card)
    python3 chip_smoke.py --kernels ROOT
    python3 chip_smoke.py --host
    python3 chip_smoke.py --txdec
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --tools

The second form runs phases 1 and 2 and C1's row of phase 6 (a) (its
check against the plain loop, its times and its clock64 split) alone on
the `t41x_torch` package in ROOT (another checkout, e.g. a parent
commit unpacked with `git archive`), profiles the rx and headless
blocks as phase 4 does, and prints the kernels' JSON line and the
card's line; `kernel_ab.py` runs
it for several checkouts in turns.  The third runs phases 1 and 5 and
prints the runner's JSON line and the card's line.  The fourth runs
phases 1 and 6 and prints the kernels' line (C1's row), phase 6's line,
the card's line and the last line.  The fifth runs phases 1 and 7 and
prints phase 7's line, the card's line and the last line.  The sixth
runs phases 1 and 8 and prints phase 8's line, the card's line and the
last line.

Phases, each of which raises on failure (so no result line follows a
failure):

1. build the CUDA kernels of `t41x_torch/csrc/` (nvcc, sm_90a) and time it;
2. hold each kernel against its plain torch version on the card at the
   main path's shapes (1024 channels, 3 streamed blocks): K1 the fused
   front end in its four variants (zoom None/0 x complex64/q15) and its
   zoom 2^z variant K1z (zoom 1, 3, 7 complex64, zoom 1 q15), K2 the
   AGC block, K3 the output interpolation, K4 the overlap-save matmul,
   B1 the overlap-save band-pass with the audio-spectrum tap (its FFTs
   fused; no TPU counterpart: t41x runs two matmuls) at 1024 and at
   4096 channels, K5 the AGC recurrence of 64-sample blocks, K6 the SAM
   PLL, K7 the LMS in NR and notch form, K8 the Kim NR gains, N1 the
   noise blanker (on sparse impulses and on crowded impulse noise, its
   slow path), S1
   spectral NR's gain recursion at 2 and 16 hops a launch over 128 hops
   from the initial state, E1 the 14-band EQ at 1024 channels and at
   one over 16 blocks (N1, S1 and E1 have no TPU counterpart: t41x runs
   lax.scans); and time each: its device
   time per launch (torch.profiler, 20 launches after 3 warm-up, L2
   flushed before each, so that its inputs come from device memory), its
   wrapper and its plain version (CUDA events, median of 25 runs after
   warm-up, 5 for the plain versions of the per-sample recurrences), the
   plain version's device time for K1, K3, K4 and B1, and for K3, K4
   and B1 the one PyTorch call that computes the same function (K3: a
   stride-8 `conv_transpose1d` with the two stages' composed taps; K4:
   the cuBLAS product on the concatenated input; B1: the torch.fft form
   `osfilter.os_filter(..., return_spectrum=True)` on the scaled input;
   no other kernel has one).  K3 runs
   on a contiguous row and on the real part of a complex64 row, as the
   chain calls it, and is timed on the latter.  K2, K5, K6, K7 and
   K8 must equal their plain versions bit for bit (K2 and K5 from random
   carried states that reach all five AGC states), N1 its plain
   version's blank mask but at decisions within 1e-4 of the threshold
   (counted), the input bit for bit outside its mask and >= 55 dB on the
   frames whose masks are equal, silent frames passed through (`parity.
   nb_decisions`), S1 its plain version's NN choices but within 1e-4
   of a boundary (counted), its gains within 1e-5 relative + 3e-5
   elsewhere (`parity.nr_decisions`), its states within 1e-5 relative
   (bit for bit counted) and its init flags equal, E1 >= 100 dB from its
   plain version (output and state, every block), and the `clock64`
   split per phase of K2, K3, K5, K6, K7, N1, S1 (at 2 and 16 hops) and
   E1 (at every channel and at one; cold and warm) goes to the log.  Each kernel's bound is the larger of the operations its
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
   q15), the radio's default spec, cw, the receive EQ (E1) and the
   noise blanker; spectral NR launches S1; and one short-block AGC path (`agc_apply` over 64-sample
   pieces, K5).  Each path's kernel launches are counted in its run
   (every count is set to 0 just before it), and its outputs are held
   against the same path with plain versions on the card (the noise
   blanker's decisions counted, N1's against the plain blanker's on the
   kernel path's own blanker input by `parity.nb_decisions`, and its
   eager block's wall, with N1 and with the plain loop, logged): audio
   >= 55 dB SNR and displayed
   spectrum <= 0.5 dB, or, for the adaptive stages
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
   `RxChain.block` loop; and the graphed runner on the default spec with
   the noise blanker on (N1 in the graph), against the 10.667 ms budget;
   (f) a mono runner fed by `CaptureStreamer` at
   real time for 3 s with no overrun; (g) `python -m t41x_torch.cli rx`
   in a subprocess against `Radio.receive`, and `cli info`;
6. drive the transmit chains and the decoders (`tx_decoders`): (a) C1,
   the mic compressor's kernel (no TPU counterpart: t41x runs a
   lax.scan), against its plain loop at 1024 channels x 3 blocks from
   random carried envelopes that reach both the attack and the release
   branch, bit for bit, with its row in the kernels' line (device time
   by the profiler, L2 flushed; bound, the plain loop's time), and its
   clock64 split, whose envelope phase is the measured serial floor of
   a block's 2048 dependent steps; (b) the SSB exciter
   at 1024 channels (usb with EQ and compressor, lsb with compressor)
   with C1 and E1 against the plain loops (I/Q SNR >= 55 dB) and ms a
   block, `Radio.transmit_ssb` (the default config, which compresses:
   C1's main path, its launches counted), the same with the transmit EQ
   on (E1 at one channel, counted, >= 55 dB from the plain chain) and
   `transmit_cw` at one channel in ms a block against the 10.667 ms
   budget, and a TX -> RX loopback
   (audio SNR > 10 dB); (c) FT8: a slot of 15 `transmit_ft8` signals
   and a two-signal slot through `Radio.decode_ft8` on the card, every
   message decoded and the decodes equal to the decoder's on the CPU on
   the same audio, the decode's ms split (waterfall, sync and pool, LLR
   and BP, host tail; median of 5) and BP run twice bit for bit; (d) a
   live FT8 slot through the graphed runner fed at real time, synced on
   the slot boundary, decoded inside the slot's 1.5 s margin, median
   load under 100%, no overrun;
   (e) `Radio.decode_psk31` on the card equal to the CPU's; (f) `python
   -m t41x_torch.cli ft8` and `psk31` in a subprocess against `Radio`;
7. drive the mesh layer (`mesh_layer`), every shard on the one card:
   (a) the polyphase channelizer at K = 16, 64 and 256 over 1024 narrow
   channels (64, 16 and 4 wideband captures of K x 2048 samples a
   block, 8 blocks) against the port's own channelizer on the CPU (>=
   100 dB), a tone's isolation (> 50 dB), channelizer -> the flagship
   chain with kernels against plain versions (>= 55 dB, <= 0.5 dB; K1,
   K2, K3 launched), wideband samples/s alone and with the chain, and
   the channelizer's device time a block by kernel (profiler) against
   its bound; (b) the chain channel-sharded over 4 shards against the
   unsharded loop, and an elastic resume 4 -> 2 shards through a
   checkpoint at block 4 against the uninterrupted stream; (c)
   `run_time_sharded_full` on a 2 x 4 (ch x t) mesh at 1024 channels x
   16 blocks, headless usb, against the streamed chain (>= 55 dB; K4,
   K2, K3 launched), ms for the sharded front end and the tail; (d) an
   NCCL process group of one rank: `initialize`, `global_mesh`,
   `shard_local_channels`, `fleet_summary` against torch's reductions.
   It checks the splits, halos and state composition on the card, not
   traffic between cards.
8. run the measurement tools in process (`tools_layer`): (a)
   `t41x_torch.tools.bench` at --min-ms 200 for rx at 1024 and 4096
   channels, rx_nodisplay, rx with q15, nr, cw, beacon and tx at 1024,
   and the channelizer at K = 16 over 1024 channels, each its parity on
   the card (raised inside), its CUDA graph's checksum bit for bit with
   the eager loop, its 2x-repeats time ratio within 1.8-2.2, its graphed
   and eager rates and the kernels it launched, and the graphed rx
   block's device time, kernels and idle share (profiler); (b)
   `stagebench`'s 32 variants at 1024 channels and --min-ms 50, plus a
   noise-blanker row and the FFT overlap-save filter with the kernels,
   none failing, each kernel variant launching its kernels and each
   plain one none, and the noise blanker's add over `pallas` with its
   spread over NB_ADD_ROUNDS rounds of the two in turns; (c)
   `ft8_sensitivity` clean and fading at -20 to -10 dB, 10 trials a
   cell, on the card, every probability within 0.2 of FT8_SENS.json's
   and the clean 50% threshold within 1 dB of its.

It prints the kernels' JSON line (per kernel: its launches and launches
per block on the main paths, max |err|, device ms a launch, the
wrapper's, the plain version's and the library call's times, its flops,
bytes and bound, and the bound's share of the launch), phase 5's `{"runner": ...}`, phase 6's `{"txdec":
...}`, phase 7's `{"mesh": ...}` and phase 8's `{"tools": ...}` lines,
the card's name and
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
from collections import Counter
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
# C1 replaces no TPU kernel: t41x runs the compressor's envelope as a
# lax.scan (the line given)
C1 = ("t41x_torch/csrc/compressor.cu", "t41x/chain/compressor.py:64")
C1_MAX_ULP = 0      # C1 against its plain loop on the card: bit for bit
# N1 replaces no TPU kernel either: t41x runs the noise blanker's
# Levinson recursion, predictors and cross-fade distances as lax.scans
# (t41x/dsp/nb.py:63, :126, :138; the predictors' given)
N1 = ("t41x_torch/csrc/nb.cu", "t41x/dsp/nb.py:126")
# S1 and E1 replace no TPU kernel either: t41x runs spectral NR's gain
# recursion and the 14-band EQ as lax.scans (the lines given)
S1 = ("t41x_torch/csrc/spectral_nr.cu", "t41x/dsp/nr.py:433")
E1 = ("t41x_torch/csrc/eq.cu", "t41x/dsp/eq.py:110")
# B1 replaces no TPU kernel: t41x runs the spectrum-tap band-pass as two
# matmuls (the line given), for want of an FFT on the TPU
B1 = ("t41x_torch/csrc/os_spectrum.cu", "t41x/dsp/osfilter.py:100")
B1_CHANNELS = (N_CH, 4096)   # its rows: phase 3's and the bulk cells'
# their rows, by the shapes the main paths give them: S1 at 2 hops a
# call (`spectral_nr`, a block) and 16 (`spectral_nr_batch` over 8
# blocks), E1 at 1024 channels and at one (`Radio.transmit_ssb`)
S1_ROWS = {2: "S1 spectral_gains 2 hops", 16: "S1 spectral_gains 16 hops"}
E1_ROWS = {"channels": "E1 eq 1024 x 256", "one": "E1 eq 1 x 256"}

# the main paths: ChainSpec keywords, parity measure, and the kernels that
# must launch
SPECS = {
    "rx": (dict(mode="usb", spectrum_zoom=0), "waveform",
           ("K1", "K2", "K3", "B1")),
    "rx_q15": (dict(mode="usb", spectrum_zoom=0, q15_input=True,
                    clip_taps=True), "waveform", ("K1", "K2", "K3", "B1")),
    "headless": (dict(mode="usb", spectrum_taps=False), "waveform",
                 ("K1", "K2", "K3", "K4")),
    "headless_q15": (dict(mode="usb", spectrum_taps=False, q15_input=True),
                     "waveform", ("K1", "K2", "K3", "K4")),
    "am": (dict(mode="am"), "waveform", ("K1", "K2", "K3", "B1")),
    "sam": (dict(mode="sam", f_lo=-3000.0, f_hi=3000.0), "adaptive",
            ("K1", "K2", "K3", "K6", "B1")),
    "nfm": (dict(mode="nfm"), "waveform", ("K1", "K2", "K3", "B1")),
    "nfm_headless": (dict(mode="nfm", spectrum_taps=False), "waveform",
                     ("K1", "K2", "K3", "K4")),
    "nr_kim": (dict(mode="usb", nr_mode=1), "waveform",
               ("K1", "K2", "K3", "K8", "B1")),
    "nr_spectral": (dict(mode="usb", nr_mode=2), "waveform",
                    ("K1", "K2", "K3", "S1", "B1")),
    "nr_lms": (dict(mode="usb", nr_mode=3), "adaptive",
               ("K1", "K2", "K3", "K7", "B1")),
    "notch": (dict(mode="usb", notch_on=True), "adaptive",
              ("K1", "K2", "K3", "K7", "B1")),
    "ft8": (dict(mode="ft8"), "waveform", ("K1", "K2", "K3", "B1")),
    "psk31": (dict(mode="psk31"), "waveform", ("K1", "K3")),
    "zoom1": (dict(mode="usb", spectrum_zoom=1), "waveform",
              ("K1", "K2", "K3", "B1")),
    "zoom3": (dict(mode="usb", spectrum_zoom=3), "waveform",
              ("K1", "K2", "K3", "B1")),
    "zoom7": (dict(mode="usb", spectrum_zoom=7), "waveform",
              ("K1", "K2", "K3", "B1")),
    # the spec t41x.radio.Radio.chain builds from a default RadioConfig:
    # no output interpolation, so K3 does not run
    "radio_default": (dict(mode="usb", f_lo=200.0, f_hi=3000.0, agc_mode=2,
                           spectrum_zoom=1, interpolate_out=False),
                      "waveform", ("K1", "K2", "B1")),
    "zoom1_q15": (dict(mode="usb", spectrum_zoom=1, q15_input=True),
                  "waveform", ("K1", "K2", "K3", "B1")),
    "cw": (dict(mode="cw", cw_filter_index=2), "waveform",
           ("K1", "K2", "K3", "B1")),
    "eq": (dict(mode="usb", eq_on=True), "waveform",
           ("K1", "K2", "K3", "E1", "B1")),
    "nb": (dict(mode="usb", nb_on=True), "waveform",
           ("K1", "K2", "K3", "N1", "B1")),
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
                "K7": "xanr_kernel", "K8": "kim_gain_kernel",
                "C1": "compress_kernel", "N1": "nb_kernel",
                "S1": "spectral_gain_kernel", "E1": "eq_kernel",
                "B1": "os_spectrum_kernel"}


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


def b1_flops(n_ch: int, n_fft: int = 512) -> int:
    """fp32 operations of the spectrum-tap band-pass as FFTs: two n-point
    complex FFTs (5 n log2 n each), the mask's complex product (6 n),
    |X|^2 (3 n) times |mask|^2 (n), and the level scale (2 n/2)."""
    return n_ch * (2 * 5 * n_fft * int(np.log2(n_fft)) + 11 * n_fft)


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
    # per bin and hop: the noise tracking (exp counted as one), the SNRs
    # and gain, the two in-band sums, the box filter and the selects
    "S1": 60,
    "C1": 60,      # per sample: log10f, the envelope step, powf
    # per sample: the 11 lags (22), the two 11-tap FIRs (44), the
    # variance (4) and the hit test (2); n1_flops adds the rest
    "N1": 72,
}
N1_OPS_PER_FRAME = 151   # Levinson-Durbin (250) and the threshold (22),
#                          less the lags' 121 products and sums past the
#                          frame's end
N1_OPS_PER_BLANKED = 45  # two 10-tap predictions (38) and the cross-fade


def n1_flops(x, mask) -> int:
    """fp32 operations of the noise blanker on frames x (..., n) whose
    blank mask is `mask`: the predictions and the cross-fade run only
    on the blanked samples this input has."""
    frames = x.numel() // x.shape[-1]
    return (OPS_PER_ELEMENT["N1"] * x.numel() + N1_OPS_PER_FRAME * frames
            + N1_OPS_PER_BLANKED * int(mask.sum()))


def nb_stimulus(kind: str, frames: int, n: int, gen, dev):
    """N1's audio frames (frames, n) at 24 kHz on `dev`, drawn from `gen`.
    tone: a 600 Hz tone in light noise with 1-3 impulses a frame,
    impulses at the hit guard's edges (13 and n - 15) in every 64th frame
    and the next, every 16th frame from the 8th silent.  crowded: impulse
    noise over most of the blankable range [10, n - 11) by turns of four
    frames, as `tests/test_torch_nb_gpu.py` `nb_frames` makes it: a
    +8, +8, -8, -8 train at most 7 samples apart over the whole guard in
    light noise (one run over [10, n - 11)); the tone with random-sign
    impulses of 3 every 7 samples (long runs) and every 8 (runs of 7 one
    unset sample apart: one dependent group); bursts of impulses of 2,
    2-5 apart, n // 64 a frame."""
    import torch
    t = torch.arange(n, device=dev) / 24000.0
    x = 0.3 * torch.sin(2 * np.pi * 600.0 * t + 6.0 * torch.rand(
        frames, 1, generator=gen, device=dev)) + 0.02 * torch.randn(
        frames, n, generator=gen, device=dev)
    if kind == "tone":
        pos = torch.randint(14, n - 14, (frames, 3), generator=gen,
                            device=dev)
        amp = 1.5 * torch.sign(torch.randn(frames, 3, generator=gen,
                                           device=dev))
        amp[:, 1:] *= torch.rand(frames, 2, generator=gen, device=dev) < 0.5
        x.scatter_add_(1, pos, amp)
        x[0::64, 13] += 2.0
        x[1::64, n - 15] += 2.0
        x[8::16] = 0.0
        return x
    if kind != "crowded":
        raise ValueError(f"nb_stimulus: no kind {kind!r}")
    lo, hi = 13, n - 15   # the first and last guarded hit
    f = torch.arange(frames, device=dev)
    turn, sign = (f % 4)[:, None], (1.0 - 2.0 * (f % 2))[:, None]

    def signs():
        return torch.where(torch.rand(frames, n, generator=gen, device=dev)
                           < 0.5, -1.0, 1.0)
    k = -(-(hi - lo) // 7) + 1
    train = torch.zeros(n, device=dev)
    train[torch.round(torch.linspace(lo, hi, k)).long()] = 8.0 * torch.tensor(
        [1.0, 1.0, -1.0, -1.0], device=dev)[torch.arange(k) % 4]
    x = torch.where(turn == 0, 0.02 * torch.randn(frames, n, generator=gen,
                                                  device=dev)
                    + sign * train, x)
    step = 6 + turn
    off = torch.randint(0, 8, (frames, 1), generator=gen, device=dev) % step
    on = (turn >= 1) & (turn <= 2)
    u = torch.arange(n, device=dev) - lo - off
    x = x + torch.where(on & (u >= 0) & (u % step == 0) & (u + lo + off <= hi),
                        3.0 * signs(), 0.0)
    for _ in range(max(1, n // 64)):
        s = torch.randint(lo, hi - 24, (frames, 1), generator=gen, device=dev)
        ln = torch.randint(6, 24, (frames, 1), generator=gen, device=dev)
        sp = torch.randint(2, 6, (frames, 1), generator=gen, device=dev)
        u = torch.arange(n, device=dev) - s
        x = x + torch.where((turn == 3) & (u >= 0) & (u < ln) & (u % sp == 0),
                            2.0 * signs(), 0.0)
    return x.contiguous()


def e1_flops(x) -> int:
    """fp32 operations of the 14-band EQ on audio x (..., n), by
    `k1_flops`' rule: those of the sample-by-sample recurrences, not of
    the chunk form: per sample and band two biquad sections of ~10
    operations and the band's gain-weighted add (an FMA, 2)."""
    return x.numel() * 14 * (2 * 10 + 2)


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
# what each profiler session runs before its timed calls: the profiler
# drops a session's first device records, always the first ones, up to
# 142 in one session of the whole script (`kernel_study.py
# profiler-loss`), so PROFILER_SPINS spin kernels (torch.cuda._sleep's)
# and a wait of PROFILER_WAIT_S take the loss
PROFILER_SPINS = 256
PROFILER_WAIT_S = 0.01
SPIN_KERNEL = "spin_kernel"
_spins_dropped = []  # a session each: spin records the profiler dropped
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
    them.  The profiler can drop a session's first device records, or
    deliver a session's kernels into the next one: so each session
    starts with PROFILER_SPINS spin kernels and a wait, which take the
    first loss, the spins left out (`_spins_dropped` keeps how many of
    them were dropped), a
    kernel's time is its mean over the launches the session holds, its
    launches a call the whole number m nearest its count over `n`, and
    a session in which a count lies more than a tenth of max(m, 1) n
    from m n, or that fails `check`, is logged and run again.  Counts
    below n/10 are strays of an earlier session."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(PROFILER_TRIES):
        if attempt:
            log(f"# kernel_us: session {attempt} of {n} calls not whole, "
                f"kernel counts {counts}; run again")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILER_SPINS):
                torch.cuda._sleep(1)
            torch.cuda.synchronize()
            time.sleep(PROFILER_WAIT_S)
            t0 = time.perf_counter()
            for _ in range(n):
                body()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        _spins_dropped.append(PROFILER_SPINS - sum(
            ev.count for ev in evs if SPIN_KERNEL in ev.key))
        evs = [ev for ev in evs if SPIN_KERNEL not in ev.key]
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


def sm_max_mhz() -> float:
    """The card's top SM clock, MHz, as `nvidia-smi` gives it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.strip().splitlines()[0])


def log_phases(name, fn, names, card: str, loop=None, steps=1,
               n_ch: int = N_CH) -> dict:
    """Where a kernel's time goes: clock64 stamps per phase, mean over
    the blocks of 10 launches, cold (L2 flushed before each) and warm;
    the `loop` phase, where there is one, also in cycles a step.  `fn`
    launches the phases variant and returns its stamps.  Returns each
    temperature's split (`phase_split`)."""
    import torch

    # agc.py re-exports phase_split, as in the trees before it moved
    from t41x_torch.kernels import agc as kagc
    out = {}
    for temp in ("cold", "warm"):
        fn()
        stamps = []
        for _ in range(10):
            if temp == "cold":
                l2_flush()
            stamps.append(fn())
        split = kagc.phase_split(torch.cat(stamps), names)
        ghz = split["sm_ghz"]
        if loop:
            split["cycles_a_step"] = split[loop] * 1e3 * ghz / steps
        step = (f"; {loop} {split['cycles_a_step']:.1f} cycles a step"
                if loop else "")
        log(f"# {name} phases {temp}, us a block: " + ", ".join(
            f"{k} {split[k]:.3f}" for k in (*names, "block"))
            + f"{step} at {ghz:.3f} GHz ({n_ch} channels, {card})")
        out[temp] = split
    return out


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

    def nb_radio():
        """The default radio with the noise blanker on (N1): `Radio`'s
        config has `nb_on` but, as t41x's, builds its chain without it."""
        import dataclasses
        radio = Radio(device=dev)
        radio._chain = RxChain(dataclasses.replace(radio.chain.spec,
                                                   nb_on=True), device=dev)
        return radio

    # (e) times: the graphed and the eager runner, and the bare chain loop;
    # the nb spec's graphed step beside the default's
    if cuda:
        result["e"] = {}
        for name, mode in (("default", None), ("sam", "sam"), ("nb", None)):
            figures = {}
            for kind in ("graphed",) if name == "nb" else ("graphed",
                                                             "eager"):
                radio = nb_radio() if name == "nb" else Radio(device=dev)
                if mode:
                    radio.set_mode(mode)
                runner = runner_for(radio, graphs=kind == "graphed",
                                    capacity=8)
                runner.keep_audio = False
                reset_counts()
                runner.prime()   # the warm-up and the capture
                body = steps(runner)
                for _ in range(3):
                    body()
                if name == "nb" and read_counts()["N1"] == 0:
                    raise AssertionError("phase 5 (e) nb: N1 was not "
                                         "captured")
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
                    figures["budget_ms"] = BLOCK_BUDGET_MS
                del runner
            if name == "nb":
                result["e"][name] = figures
                log(f"# phase 5 (e) nb (N1 in the graph), {n_ch} channels, "
                    f"ms a block against {BLOCK_BUDGET_MS:.3f} and device "
                    f"idle share ({card}): {figures}")
                continue
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


TX_CHANNELS = 1024       # phase 6 (b): the batched exciter
TX_BLOCKS = 8
RADIO_TX_BLOCKS = 32     # phase 6 (b): Radio.transmit_ssb, one channel
BLOCK_BUDGET_MS = 1e3 * 2048 / 192_000   # 10.667 ms, a block's real time
FT8_REPS = 5
FT8_CROWD = 15
FT8_MARGIN_S = 1.5       # slots.py: a 15 s slot of which 13.5 s is taken
LIVE_SLOT_END_S = 15.2   # phase 6 (d): the slot's audio ends 15.2 s in
LIVE_WAIT_S = 25.0
LIVE_SYNC_BY_S = 0.25    # the boundary at 0.2 s, and a block's 10.7 ms


def _ft8_crowd(radio, n_sig: int, seed: int):
    """n_sig `Radio.transmit_ft8` signals in one 15.4 s capture: base
    frequencies over 400-2700 Hz, levels over ~16 dB, starts over 0-2 s
    after the 0.5 s lead-in, in light noise; and their messages."""
    from t41x_torch import constants as C

    rng = np.random.default_rng(seed)
    calls = ["K1ABC", "W9XYZ", "N2DEF", "K5GHI", "W0JKL", "N8MNO",
             "K3PQR", "W4STU", "N6VWX", "K7YZA", "W1BCD", "N3EFG",
             "K9HIJ", "W5KLM", "N7NOP"][:n_sig]
    msgs = [f"CQ {c} FN{(i * 7) % 90:02d}" for i, c in enumerate(calls)]
    freqs = np.linspace(400.0, 2700.0, n_sig)
    rng.shuffle(freqs)
    amps = 10 ** (rng.uniform(0.0, 0.8, n_sig)) / 10 ** 0.8
    n = int(15.4 * C.SAMPLE_RATE) // C.BLOCK_SIZE * C.BLOCK_SIZE
    iq = 0.002 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    for m, f, a in zip(msgs, freqs, amps):
        sig = radio.transmit_ft8(m, base_freq=float(f)) * a
        d = int(rng.uniform(0.0, 2.0) * C.SAMPLE_RATE)
        e = min(d + len(sig), n)
        iq[d:e] += sig[: e - d]
    return iq.astype(np.complex64), msgs


def _live_ft8_slot(dev, iq, msg: str) -> dict:
    """One live FT8 slot (phase 6 (d)): a radio in ft8 mode, its runner
    (graphed on the card) fed by `CaptureStreamer` at real time, the
    slot clock the wall clock with its next 15 s boundary 0.2 s into the
    stream.  Returns what a decode gave and when, the load, the ring's
    overruns and when the slot manager synced."""
    import torch

    from t41x_torch import constants as C
    from t41x_torch.decode.ft8 import decode as ft8
    from t41x_torch.io import runtime
    from t41x_torch.radio import Radio
    from t41x_torch.runner import StreamRunner

    live = Radio(device=dev)
    live.set_mode("ft8")
    t_start = None

    def wall_clock():
        if t_start is None:
            return 0.0
        return (time.monotonic() - t_start) + (15.0 - 0.2)

    runner = StreamRunner(live, ring=runtime.BlockRing(capacity=256),
                          slot_clock=wall_clock)
    runner.prime()
    ft8.decode_audio(np.zeros(int(13.5 * C.AUDIO_RATE), np.float32),
                     device=dev)   # the decoder's first-use set-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
    slots = runner._ft8_slots
    t_start = time.monotonic()
    streamer = runtime.CaptureStreamer(runner.ring, iq, rate_factor=1.0)
    decoded, t_decode, synced, loads, steps = None, None, None, [], []
    try:
        while time.monotonic() < t_start + LIVE_WAIT_S:
            t0 = time.monotonic()
            r = runner.step()
            if r is None:
                if not streamer.running and runner.ring.available() == 0:
                    break
                time.sleep(0.001)
                continue
            steps.append(time.monotonic() - t0)
            loads.append(r["load_percent"])
            if synced is None and slots.synced:
                synced = time.monotonic() - t_start
            if r.get("ft8"):
                decoded, t_decode = r["ft8"], time.monotonic() - t_start
                break
    finally:
        streamer.stop()
    return {"decoded": [d.text for d in decoded or []],
            "t_decode_s": t_decode,
            "deadline_s": LIVE_SLOT_END_S + FT8_MARGIN_S,
            "median_load_percent": float(np.median(loads)),
            "overruns": runner.ring.overruns,
            "blocks": runner.blocks_processed, "graphed": runner.graphs,
            "synced_s": synced, "longest_step_ms": 1e3 * max(steps)}


def c1_check(dev, card: str, rows: list, row) -> tuple:
    """Phase 6 (a): C1, the mic compressor's kernel, against its plain loop
    on the card, bit for bit, its row in the kernels' line (appended to
    `rows` by `row`) and its clock64 split.  Raises on a disagreement;
    returns (its row, the figures)."""
    import torch

    from t41x_torch import constants as C
    from t41x_torch.chain import compressor as comp_mod
    from t41x_torch.kernels import compressor as kcomp

    # 1024 channels x 3 blocks from random carried envelopes, the levels
    # spread over the channels from -60 to +10 dBFS, so that both the
    # attack and the release branch run
    p = comp_mod.compressor_params(rate=C.SAMPLE_RATE)
    g = torch.Generator(device=dev).manual_seed(13)
    n_ch = TX_CHANNELS
    env0 = -80.0 + 90.0 * torch.rand(n_ch, generator=g, device=dev)
    level = torch.logspace(-3, 0.5, n_ch, device=dev)[:, None]
    st_k = st_p = comp_mod.CompressorState(env0)
    up = torch.zeros((), dtype=torch.int64, device=dev)
    env = env0.clone()
    ulp = {"y": 0, "env_db": 0}

    def ulps(a, b):
        ia = a.view(torch.int32).to(torch.int64)
        ib = b.view(torch.int32).to(torch.int64)
        ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
        ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
        return int((ia - ib).abs().max())

    for _ in range(3):
        x = torch.randn(n_ch, C.BLOCK_SIZE, generator=g, device=dev) * level
        st_k, y_k = comp_mod.compress(p, st_k, x)
        st_p, y_p = comp_mod.compress_plain(p, st_p, x)
        ulp["y"] = max(ulp["y"], ulps(y_k, y_p))
        ulp["env_db"] = max(ulp["env_db"], ulps(st_k.env_db, st_p.env_db))
        ldb = 20.0 * torch.log10(torch.clamp_min(x.abs(), 1e-9))
        for n in range(C.BLOCK_SIZE):   # which branch each sample takes
            u = ldb[:, n] > env
            up += u.sum()
            c = torch.where(u, p.attack_coeff, p.release_coeff)
            env = c * env + (1.0 - c) * ldb[:, n]
    n_samples = 3 * n_ch * C.BLOCK_SIZE
    up = int(up)
    if not 0 < up < n_samples:
        raise AssertionError(f"phase 6 (a): attack on {up} of {n_samples}")
    err = float((y_k - y_p).abs().max())
    if ulp["y"] > C1_MAX_ULP or ulp["env_db"] > C1_MAX_ULP:
        raise AssertionError(f"phase 6 (a): C1 vs its plain loop {ulp} ulp")
    row("C1 compressor", C1, lambda: comp_mod.compress(p, st_k, x),
        lambda: comp_mod.compress_plain(p, st_k, x), err, (0.0, 0.0),
        OPS_PER_ELEMENT["C1"] * x.numel(), (x, st_k),
        comp_mod.compress(p, st_k, x), plain_reps=REPS_PLAIN)
    c1 = rows[-1]
    c1["tpu_kernel"] = None   # replaces t41x's lax.scan, no TPU kernel
    # the serial floor, measured: the envelope row of a block (its 2048
    # dependent steps, one lane a channel), from C1's clock64 stamps, beside
    # its other phases (the tree's own C1_PHASES)
    split = log_phases("C1", lambda: kcomp.compress_phases(p, st_k, x)[2],
                       kcomp.C1_PHASES, card, "envelope", C.BLOCK_SIZE,
                       n_ch)
    # one channel, as `Radio.transmit_ssb` runs it: one block of the kernel
    st1, x1 = comp_mod.CompressorState(st_k.env_db[:1]), x[:1]
    got, want = comp_mod.compress(p, st1, x1), comp_mod.compress_plain(
        p, st1, x1)
    if not (torch.equal(got[1], want[1])
            and torch.equal(got[0].env_db, want[0].env_db)):
        raise AssertionError("phase 6 (a): C1 at one channel vs its plain "
                             "loop")
    us1 = device_us(lambda: comp_mod.compress(p, st1, x1),
                    KERNEL_NAMES["C1"])
    log(f"# C1 one channel: bit for bit; device {us1:.2f} us a launch "
        f"(L2 flushed; {card})")
    split1 = log_phases("C1 one channel",
                        lambda: kcomp.compress_phases(p, st1, x1)[2],
                        kcomp.C1_PHASES, card, "envelope", C.BLOCK_SIZE, 1)
    a = {"attack_share": up / n_samples, "max_ulp": ulp,
         "max_abs_err": err,
         "phases_us": {t: {k: split[t][k] for k in kcomp.C1_PHASES}
                       for t in split},
         "envelope_cycles_a_step": {t: split[t]["cycles_a_step"]
                                    for t in split},
         "block_us": {t: split[t]["block"] for t in split},
         "sm_ghz": split["warm"]["sm_ghz"],
         "device_us": c1["ms"] * 1e3,
         "bound_us": c1["bound_ms"] * 1e3,
         "plain_ms": c1["plain_ms"],
         "one_channel": {"device_us": us1,
                         "envelope_cycles_a_step":
                             split1["warm"]["cycles_a_step"],
                         "block_us": split1["warm"]["block"]}}
    log(f"# phase 6 (a) C1: {a} ({card})")
    return c1, a


def _feed_row(rows: list, name: str, launches: int, blocks: int) -> None:
    """Add a main path's launches of one kernel variant, and the blocks
    it ran, to that variant's row, where the run has one (`--txdec`
    has only C1's)."""
    for r in rows:
        if launches and r["name"] == name:
            r["launches"] += launches
            r["blocks"] += blocks


def tx_decoders(dev, card: str, rows: list, row, time_ms, counts) -> dict:
    """Phase 6, the transmit chains and the decoders on the card: (a) C1
    against its plain loop; (b) the SSB exciter at 1024 channels, the
    radio's `transmit_ssb` / `transmit_cw` at one channel against the
    block budget, and a TX -> RX loopback; (c) FT8 slots decoded by
    `Radio.decode_ft8` on the card against the port on the CPU, and
    the decode's time split; (d) a live FT8 slot through the graphed
    runner at real time; (e) PSK31; (f) the CLI's ft8 and psk31.
    Raises on any failure; returns the figures."""
    import os
    import tempfile

    import torch

    from t41x_torch import constants as C
    from t41x_torch.chain import ChainSpec, RxChain
    from t41x_torch.chain import tx
    from t41x_torch.decode import psk31
    from t41x_torch.decode.ft8 import decode as ft8, ldpc, sync
    from t41x_torch.decode.ft8 import waterfall
    from t41x_torch.io import signals, wav
    from t41x_torch.radio import Radio
    from t41x_torch.utils import parity

    t_phase = time.perf_counter()
    reset_counts, read_counts = counts
    result = {"card": card}

    # (a) C1 against its plain loop
    c1, result["a"] = c1_check(dev, card, rows, row)

    # (b) the SSB exciter at 1024 channels, kernel path against the plain
    # loop on the card; ms a block
    voices = np.stack([signals.voice_proxy(
        TX_BLOCKS * C.BLOCK_SIZE, fs_audio=C.SAMPLE_RATE, seed=s)
        for s in range(16)]).astype(np.float32)
    mic = torch.from_numpy(np.tile(voices, (TX_CHANNELS // 16, 1))).to(dev)
    mic = mic * torch.linspace(0.1, 2.0, TX_CHANNELS, device=dev)[:, None]
    result["b"] = {}
    for name, kw in (("usb_eq_comp", dict(sideband="usb", eq_on=True,
                                          compressor_on=True)),
                     ("lsb_comp", dict(sideband="lsb",
                                       compressor_on=True))):
        ex = tx.SSBExciter(tx.TxSpec(**kw), device=dev)
        # the same exciter with the compressor's plain loop
        ex_p = tx.SSBExciter(tx.TxSpec(**kw, use_kernels=False), device=dev)
        pr = tx.default_tx_params((TX_CHANNELS,), device=dev)._replace(
            iq_phase=torch.linspace(-0.02, 0.02, TX_CHANNELS, device=dev))

        def stream(ex, pr=pr):
            st, out = ex.init_state((TX_CHANNELS,)), []
            for b in range(TX_BLOCKS):
                st, iq = ex.block(pr, st, mic[:, b * C.BLOCK_SIZE:
                                              (b + 1) * C.BLOCK_SIZE])
                out.append(iq)
            return st, torch.cat(out, -1)

        reset_counts()
        _, iq_k = stream(ex)
        torch.cuda.synchronize()
        launches = read_counts()["C1"]
        n_e1 = read_counts().get("E1", 0)
        _feed_row(rows, E1_ROWS["channels"], n_e1, TX_BLOCKS)
        _, iq_p = stream(ex_p)
        snr = parity.snr_db(iq_p.cpu().numpy(), iq_k.cpu().numpy())
        st0 = ex.init_state((TX_CHANNELS,))
        blk = mic[:, : C.BLOCK_SIZE]
        ms = time_ms(lambda: ex.block(pr, st0, blk))
        ms_plain = time_ms(lambda: ex_p.block(pr, st0, blk), REPS_PLAIN)
        result["b"][name] = {"channels": TX_CHANNELS, "blocks": TX_BLOCKS,
                             "c1_launches": launches, "e1_launches": n_e1,
                             "iq_snr_db": _finite(snr),
                             "ms_a_block": ms, "ms_a_block_plain": ms_plain}
        log(f"# phase 6 (b) SSBExciter {name}: {result['b'][name]} ({card})")
        if launches != TX_BLOCKS or not snr >= parity.AUDIO_SNR_MIN_DB \
                or n_e1 != (TX_BLOCKS if kw.get("eq_on") else 0):
            raise AssertionError(f"phase 6 (b) {name}: {result['b'][name]}")

    # the radio's transmit entry points, one channel, the default config
    # (mic_compression -10 < 0: the compressor runs, t41x's rule)
    radio = Radio(device=dev)
    voice = signals.voice_proxy(RADIO_TX_BLOCKS * C.BLOCK_SIZE,
                                fs_audio=C.SAMPLE_RATE)
    radio.transmit_ssb(voice[: 2 * C.BLOCK_SIZE])   # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    iq_tx = radio.transmit_ssb(voice)
    wall = time.perf_counter() - t0
    n_c1 = read_counts()["C1"]
    t0 = time.perf_counter()
    iq_tx_plain = radio.transmit_ssb(voice[: 4 * C.BLOCK_SIZE],
                                     use_kernels=False)
    wall_plain = time.perf_counter() - t0
    t0 = time.perf_counter()
    cw = radio.transmit_cw("CQ TEST DE K1ABC")
    wall_cw = time.perf_counter() - t0
    cw_blocks = len(cw) // C.BLOCK_SIZE
    c1["launches"] += n_c1
    c1["blocks"] += RADIO_TX_BLOCKS
    result["b"]["radio"] = {
        "transmit_ssb_ms_a_block": wall / RADIO_TX_BLOCKS * 1e3,
        "transmit_ssb_plain_ms_a_block": wall_plain / 4 * 1e3,
        "transmit_cw_ms_a_block": wall_cw / cw_blocks * 1e3,
        "budget_ms": BLOCK_BUDGET_MS, "c1_launches": n_c1,
        "blocks": RADIO_TX_BLOCKS,
        "plain_vs_kernel_snr_db": _finite(parity.snr_db(
            iq_tx_plain, iq_tx[: 4 * C.BLOCK_SIZE])),
        "cw_peak": float(np.abs(cw).max())}
    log(f"# phase 6 (b) Radio.transmit_ssb / transmit_cw, 1 channel: "
        f"{result['b']['radio']} ({card})")
    r = result["b"]["radio"]
    if n_c1 != RADIO_TX_BLOCKS or not (
            r["transmit_ssb_ms_a_block"] < BLOCK_BUDGET_MS
            and float(r["plain_vs_kernel_snr_db"])
            >= parity.AUDIO_SNR_MIN_DB
            and np.isfinite(cw).all() and r["cw_peak"] > 0.1):
        raise AssertionError(f"phase 6 (b) radio: {r}")

    # the same with the transmit EQ on: E1 at one channel, its shared
    # (14,) gains the config's, against the plain chain
    radio.set_eq("tx", True)
    n_eq = 8 * C.BLOCK_SIZE
    reset_counts()
    iq_eq = radio.transmit_ssb(voice[:n_eq])
    n_e1 = read_counts()["E1"]
    iq_eq_plain = radio.transmit_ssb(voice[:n_eq], use_kernels=False)
    radio.set_eq("tx", False)
    _feed_row(rows, E1_ROWS["one"], n_e1, n_eq // C.BLOCK_SIZE)
    r = result["b"]["radio_eq"] = {
        "e1_launches": n_e1, "blocks": n_eq // C.BLOCK_SIZE,
        "plain_vs_kernel_snr_db": _finite(parity.snr_db(iq_eq_plain,
                                                         iq_eq))}
    log(f"# phase 6 (b) Radio.transmit_ssb with the transmit EQ, 1 "
        f"channel: {r} ({card})")
    if n_e1 != n_eq // C.BLOCK_SIZE or not (
            float(r["plain_vs_kernel_snr_db"]) >= parity.AUDIO_SNR_MIN_DB):
        raise AssertionError(f"phase 6 (b) radio with EQ: {r}")

    # the TX -> RX loopback of tests/test_tx.py: voice proxy ->
    # transmit_ssb -> the port's usb chain at the RX frequency plan
    n = 30 * C.BLOCK_SIZE
    vmic = signals.voice_proxy(n, fs_audio=C.SAMPLE_RATE, f_lo=600.0,
                               f_hi=2400.0)
    iq_l = radio.transmit_ssb(vmic)
    t = np.arange(len(iq_l)) / C.SAMPLE_RATE
    iq_rx = (iq_l * np.exp(-2j * np.pi * (C.SAMPLE_RATE / 4) * t) * 0.01
             ).astype(np.complex64)
    chain = RxChain(ChainSpec(mode="usb", interpolate_out=False, agc_mode=0,
                              use_kernels=True), device=dev)
    a = chain.run(iq_rx)["audio_24k"].cpu().numpy()[4096:]
    b = vmic[:: C.DF][4096:]
    m = min(len(a), len(b))
    a, b = a[:m], b[:m]
    xc = np.fft.irfft(np.fft.rfft(a) * np.conj(np.fft.rfft(b)))
    d = int(np.argmax(np.abs(xc)))
    d = d - m if d > m // 2 else d
    fr = np.fft.rfftfreq(m)
    sb = np.fft.irfft(np.fft.rfft(b) * np.exp(-2j * np.pi * fr * d), m)
    best = max(signals.snr_db(a[1000:-1000], np.fft.irfft(
        np.fft.rfft(sb) * np.exp(-2j * np.pi * fr * f), m)[1000:-1000])
        for f in np.linspace(-1.5, 1.5, 31))
    result["b"]["loopback_snr_db"] = best
    log(f"# phase 6 (b) TX -> RX loopback audio SNR {best:.2f} dB")
    if not best > 10.0:
        raise AssertionError(f"phase 6 (b): loopback SNR {best}")

    # (c) FT8: a crowded slot of 15 transmit_ft8 signals and a two-signal
    # slot, decoded by Radio.decode_ft8 on the card; the decoder on the
    # CPU on the same audio must give the same decodes
    result["c"] = {}
    for name, n_sig, seed in (("crowded", FT8_CROWD, 5), ("two", 2, 6)):
        iq, msgs = _ft8_crowd(radio, n_sig, seed)
        dec = radio.decode_ft8(iq)
        audio = radio.receive(iq)["audio_24k"].astype(np.float32)
        on_card = ft8.decode_audio(audio, my_grid=radio.config.my_grid,
                                   device=dev)
        on_cpu = ft8.decode_audio(audio, my_grid=radio.config.my_grid,
                                  device="cpu")

        def key(ds):
            # t41x's decoder also accepts the all-zero codeword (CRC 0,
            # text "") where a candidate sees only silence or the
            # receiver's rounding noise; the port keeps that, and the
            # comparisons leave it out
            return sorted((d.text, d.time_offset, d.freq_hz) for d in ds
                          if d.bits77.any())

        cpu_score = {d.text: d.score for d in on_cpu if d.bits77.any()}
        score_err = max((abs(d.score - cpu_score.get(d.text, np.inf))
                         for d in on_card if d.bits77.any()), default=0.0)
        texts = [k[0] for k in key(dec)]
        result["c"][name] = {"decoded": len(texts), "sent": n_sig,
                             "all_zero_codewords": len(dec) - len(texts),
                             "texts_equal_sent": texts == sorted(msgs),
                             "card_equals_cpu": key(on_card) == key(on_cpu),
                             "max_score_err": score_err}
        log(f"# phase 6 (c) FT8 {name} slot: {result['c'][name]}")
        if texts != sorted(msgs) or key(dec) != key(on_card) \
                or key(on_card) != key(on_cpu) or score_err > 0.01:
            raise AssertionError(f"phase 6 (c) {name}: {texts} vs "
                                 f"{sorted(msgs)}; card {key(on_card)}, "
                                 f"cpu {key(on_cpu)}")
        if name == "crowded":
            crowd_audio = audio

    # the decode's time split, median of FT8_REPS after a warm-up
    def split():
        marks = [time.perf_counter()]
        x = torch.from_numpy(crowd_audio).to(dev)
        wf = waterfall.compute_waterfall(x)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        pool = sync.find_candidates(wf, ft8._K_POOL)
        k = ft8._pool_bucket(pool.score.cpu().numpy(), ft8.SCORE_FLOOR)
        cands = sync.Candidates(*(a[:k] for a in pool))
        marks.append(time.perf_counter())
        res = ft8._llr_bp(wf, cands, 25)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        out = ft8.messages(res, cands)
        marks.append(time.perf_counter())
        return np.diff(marks) * 1e3, k, len(out)

    split()
    runs = [split() for _ in range(FT8_REPS)]
    parts = np.median(np.stack([r[0] for r in runs]), axis=0)
    t0 = time.perf_counter()
    for _ in range(FT8_REPS):
        ft8.decode_audio(crowd_audio, device=dev)
    whole = (time.perf_counter() - t0) / FT8_REPS * 1e3
    result["c"]["ms_a_slot"] = {
        "decode_audio": whole, "waterfall": parts[0],
        "sync_and_pool": parts[1], "llr_and_bp": parts[2],
        "host_tail": parts[3], "bp_bucket": runs[0][1],
        "decodes": runs[0][2]}
    log(f"# phase 6 (c) FT8 decode, crowded slot, ms (median of "
        f"{FT8_REPS}): {result['c']['ms_a_slot']} ({card})")
    g = torch.Generator(device=dev).manual_seed(13)
    llr = torch.randn(96, 174, generator=g, device=dev) * 4.0
    r1, r2 = ldpc.bp_decode(llr), ldpc.bp_decode(llr)
    if not (torch.equal(r1.bits, r2.bits) and torch.equal(r1.errors,
                                                          r2.errors)):
        raise AssertionError("phase 6 (c): bp_decode is not deterministic")

    # (d) a live FT8 slot: the graphed runner in ft8 mode fed at real
    # time, the wall clock of tests/test_realtime_ft8.py (the next 15 s
    # boundary 0.2 s into the stream).  The runner gives the slot manager
    # the slot time of the audio it feeds (the clock read at the first
    # feed, then the audio's own length), so the boundary falls in the
    # block that holds it however late that block is fed: one run, and a
    # missed sync fails it.
    msg = "CQ K1ABC FN42"
    from t41x_torch.decode.ft8 import encode
    iq = encode.synth_iq(msg, base_freq=1000.0, amp=0.4, pad_start_s=0.5,
                         pad_end_s=2.3)
    iq = iq[: len(iq) // C.BLOCK_SIZE * C.BLOCK_SIZE]
    d = result["d"] = _live_ft8_slot(dev, iq, msg)
    log(f"# phase 6 (d) live FT8 slot at real time: {d} ({card})")
    if d["synced_s"] is None or not d["synced_s"] < LIVE_SYNC_BY_S \
            or msg not in d["decoded"] \
            or not d["t_decode_s"] < d["deadline_s"] \
            or not d["median_load_percent"] < 100.0 or d["overruns"] \
            or not (d["graphed"] or dev.type != "cuda"):
        # on a CPU device (a rehearsal) the runner runs eagerly
        raise AssertionError(f"phase 6 (d): {d}")

    # (e) PSK31 through Radio.decode_psk31, on the card and on the CPU
    text = "CQ CQ DE T41"
    piq = psk31.synth_psk31(text, tone_hz=1000.0)
    piq = piq[: len(piq) // C.BLOCK_SIZE * C.BLOCK_SIZE]
    on_card = Radio(device=dev).decode_psk31(piq, tone_hz=1000.0)
    on_cpu = Radio(device="cpu").decode_psk31(piq, tone_hz=1000.0)
    result["e"] = {"card": on_card, "cpu": on_cpu}
    log(f"# phase 6 (e) PSK31: {result['e']}")
    if text not in on_card or on_card != on_cpu:
        raise AssertionError(f"phase 6 (e): {result['e']}")

    # (f) the CLI's ft8 and psk31 in a subprocess, against Radio
    root = Path(__file__).resolve().parent
    result["f"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for cmd, cap_iq, extra, want in (
                ("ft8", _ft8_crowd(radio, 3, 7)[0], [], None),
                ("psk31", piq, ["--tone", "1000"], on_card)):
            cap = os.path.join(tmp, f"{cmd}.wav")
            wav.write_iq_wav(cap, cap_iq, C.SAMPLE_RATE)
            cap_iq, _ = wav.read_iq_wav(cap)
            if cmd == "ft8":
                want = "\n".join(
                    _ft8_cli_line(d) for d in Radio(device=dev).decode_ft8(
                        cap_iq))
            res = subprocess.run(
                [sys.executable, "-m", "t41x_torch.cli", cmd, "--in", cap,
                 *extra, "--device", str(dev)], cwd=root,
                capture_output=True, text=True,
                timeout=600)
            result["f"][cmd] = {"rc": res.returncode,
                                "stdout": res.stdout.strip()}
            if res.returncode != 0 or res.stdout.strip() != want.strip() \
                    or not want.strip():
                raise AssertionError(f"phase 6 (f) cli {cmd}: "
                                     f"{res.stderr} {res.stdout} vs {want}")
    log(f"# phase 6 (f) cli: {result['f']}")
    result["seconds"] = time.perf_counter() - t_phase
    return result


MESH_K = (16, 64, 256)   # phase 7 (a): channelizer widths, 1024 channels
MESH_BLOCKS = 8          # (a), (b): blocks a run
MESH_T_BLOCKS = 16       # (c): blocks of the time-sharded capture
MESH_SHARDS = 4          # (b): channel shards on the card
MESH_RESUME = (4, 2)     # (b): the elastic resume's block and shard count
MESH_CT = (2, 4)         # (c): the ch x t mesh
MESH_REPS = 5            # (b), (c): timed calls (median), after 3 warm-up
CHANNELIZER_SNR_MIN_DB = 100.0
ISOLATION_MIN_DB = 50.0  # tests/test_channelizer.py:53


def _chain_parity(name: str, out_k: dict, out_p: dict) -> dict:
    """The North-star measures of a stream's outputs against a reference
    stream: audio SNR >= 55 dB, displayed spectra <= 0.5 dB, and whether
    the two are bit for bit; raises out of bound."""
    import torch

    from t41x_torch.utils import parity

    rep = {"bit_for_bit": all(torch.equal(out_k[k], out_p[k])
                              for k in out_p)}
    for k in out_p:
        got, ref = out_k[k], out_p[k]
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {k}: {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)}, finite "
                                 f"{bool(torch.isfinite(got).all())}")
        if k in ("rf_spectrum", "audio_spectrum"):
            d = rep[k + "_err_db"] = parity.spectrum_err_db(ref, got)
            ok = d <= parity.SPECTRUM_ERR_MAX_DB
        elif k in ("audio", "audio_24k"):
            d = parity.snr_db(ref, got)
            rep[k + "_snr_db"] = _finite(d)
            ok = d >= parity.AUDIO_SNR_MIN_DB
        else:
            continue
        if not ok:
            raise AssertionError(f"{name} {k}: parity {d} out of bound")
    return rep


def _wideband(k: int, n_cap: int, n_blocks: int, g, dev):
    """(n_blocks, n_cap, K * BLOCK) wideband captures at K x 192 kHz: in
    every narrow channel a USB tone 1500 + 93.75 (k mod 8) Hz above the
    channel's -Fs/4 (so the chain's Fs/4 shift puts it in the audio
    band), random phases, a bin-exact tone of the block (so blocks
    continue one another), in complex noise 26 dB below a tone."""
    import torch

    from t41x_torch import constants as C
    n = k * C.BLOCK_SIZE              # 93.75 Hz bins, 2048 a channel
    kk = torch.arange(k, device=dev)
    bins = (kk * C.BLOCK_SIZE - C.BLOCK_SIZE // 4 + 16 + kk % 8) % n
    ph = 2 * np.pi * torch.rand(n_cap, k, generator=g, device=dev)
    spec = torch.zeros(n_cap, n, dtype=torch.complex64, device=dev)
    spec[:, bins] = torch.polar(torch.full_like(ph, 0.3 * n), ph)
    block = torch.fft.ifft(spec)
    noise = torch.complex(
        torch.randn(n_blocks, n_cap, n, generator=g, device=dev),
        torch.randn(n_blocks, n_cap, n, generator=g, device=dev)) * 0.015
    return (block + noise).contiguous()


def mesh_layer(dev, card: str, n_ch: int, counts, feed, time_ms,
               kernel_us, rf_blocks, params) -> dict:
    """Phase 7, the mesh layer on the card: (a) the channelizer at K =
    16, 64 and 256 over 1024 narrow channels against the port's own on
    the CPU, a tone's isolation, channelizer -> the flagship chain with
    kernels against plain versions, rates, and the channelizer's device
    time by op against its bound; (b) the chain channel-sharded over 4
    shards against the plain chain and the unsharded loop, timed against
    that loop, and an elastic 4 -> 2 resume through a checkpoint; (c)
    the full chain time-sharded on a 2 x 4 (ch x t) mesh against the
    plain chain and the streamed chain, each pass timed; (d) an NCCL process group
    of one rank: `initialize`, `global_mesh`, `shard_local_channels`,
    `fleet_summary` against torch's reductions.  Every shard sits on
    `dev`: this checks the splits, halos and state composition, not
    traffic between cards.  `counts` is the (reset, read) pair of the
    launch counters and `feed` adds a path's launches to the kernels'
    rows; `rf_blocks(n_ch, n)` gives (n, n_ch, BLOCK) stimulus on the
    card and `params(n_ch)` spread channel parameters.  Raises on any
    failure; returns the figures."""
    import os
    import tempfile

    import torch
    import torch.distributed as tdist

    from t41x_torch import constants as C
    from t41x_torch.chain import ChainSpec, RxChain
    from t41x_torch.chain.rx import join_blocks
    from t41x_torch.mesh import distributed as dist
    from t41x_torch.mesh import sharding, timeshard
    from t41x_torch.mesh.channelizer import Channelizer
    from t41x_torch.utils import checkpoint, parity

    t_phase = time.perf_counter()
    reset_counts, read_counts = counts
    cuda = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(17)
    result = {"card": card, "channels": n_ch}
    rx_kw = SPECS["rx"][0]
    rx_row = {"K1": "K1 frontend zoom=0 c64"}
    p = params(n_ch)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def stream(chain, pr, blocks, st=None):
        st = chain.init_state((n_ch,)) if st is None else st
        outs = []
        for blk in blocks:
            st, out = chain.block(pr, st, blk)
            outs.append(out)
        return st, join_blocks(outs, 1)

    # (a) the channelizer at full width
    chains = {uk: RxChain(ChainSpec(use_kernels=uk, **rx_kw), device=dev)
              for uk in (True, False)}
    result["channelizer"] = {}
    for k in MESH_K:
        n_cap = n_ch // k
        cz, cz_cpu = Channelizer(k, device=dev), Channelizer(k, device="cpu")
        x = _wideband(k, n_cap, MESH_BLOCKS, g, dev)
        st, st_c = cz.init_state((n_cap,)), cz_cpu.init_state((n_cap,))
        ch, ch_c = [], []
        for b in range(MESH_BLOCKS):
            st, y = cz.block(st, x[b])
            st_c, y_c = cz_cpu.block(st_c, x[b].cpu())
            ch.append(y.reshape(n_ch, C.BLOCK_SIZE))
            ch_c.append(y_c.reshape(n_ch, C.BLOCK_SIZE))
        ch, ch_c = torch.stack(ch), torch.stack(ch_c)
        snr = parity.snr_db(ch_c, ch)
        rep = {"captures": n_cap, "samples_a_block": k * C.BLOCK_SIZE,
               "snr_vs_cpu_db": _finite(snr)}
        if snr < CHANNELIZER_SNR_MIN_DB:
            raise AssertionError(f"channelizer K={k}: {rep}")
        # a lone tone 10 kHz above channel k/3's centre, over K x 4096
        # samples from a zero history, as tests/test_channelizer.py
        # measures it (the start transient included), and past the
        # branch filters' first P frames
        k0 = k // 3
        t = torch.arange(k * 4096, device=dev, dtype=torch.float64) \
            / cz.fs_in
        ph = 2 * np.pi * (k0 * cz.fs_channel + 10_000.0) * t
        _, y = cz.block(cz.init_state(), torch.polar(
            torch.ones_like(ph), ph).to(torch.complex64))
        for key, seg in (("isolation_db", y),
                         ("isolation_steady_db", y[:, cz.P:])):
            pw = 10 * torch.log10((seg.abs() ** 2).mean(dim=-1) + 1e-30)
            rep[key] = float(pw[k0] - torch.cat([pw[:k0],
                                                 pw[k0 + 1:]]).max())
            if int(pw.argmax()) != k0 or rep[key] <= ISOLATION_MIN_DB:
                raise AssertionError(
                    f"channelizer K={k}: tone in channel {k0} came out in "
                    f"{int(pw.argmax())}, {key} {rep[key]:.2f}")
        # channelizer -> the flagship chain, kernels against plain
        reset_counts()
        _, out_k = stream(chains[True], p, ch.contiguous())
        sync()
        c = read_counts()
        _, out_p = stream(chains[False], p, ch.contiguous())
        if not all(c[kk] for kk in ("K1", "K2", "K3")):
            raise AssertionError(f"channelizer K={k} -> chain: launches {c}")
        feed(c, rx_row, MESH_BLOCKS)
        rep["chain_launches"] = {kk: v for kk, v in c.items() if v}
        rep["chain_vs_plain"] = _chain_parity(f"channelizer K={k} -> chain",
                                              out_k, out_p)
        if cuda:
            xb, st0 = x[0], cz.init_state((n_cap,))
            st_rx = chains[True].init_state((n_ch,))
            ms = time_ms(lambda: cz.block(st0, xb))
            ms_chain = time_ms(lambda: chains[True].block(
                p, st_rx, cz.block(st0, xb)[1].reshape(n_ch, C.BLOCK_SIZE)))
            per, _ = kernel_us(lambda: cz.block(st0, xb), 20)
            dev_us = {kk: us * m for kk, (us, m) in per.items()}
            by_kernel = Counter()   # by name, cut to 100 characters
            for kk, us in dev_us.items():
                by_kernel[kk[:100]] += us
            # a frame's work at the least: the P-tap branch FIR (real
            # taps on complex samples, 4 P K) and the K-point DFT done as
            # an FFT (5 K log2 K), not the dense product the port runs
            n_out = C.BLOCK_SIZE
            flops = n_cap * n_out * (4 * cz.P * k + 5 * k * int(np.log2(k)))
            nbytes = n_cap * 8 * (2 * k * C.BLOCK_SIZE
                                  + 2 * (cz.P * k - 1))
            b = bound(flops, nbytes)
            rep.update(
                ms=ms, ms_with_chain=ms_chain,
                wideband_samples_per_s=n_cap * k * C.BLOCK_SIZE / ms * 1e3,
                wideband_samples_per_s_with_chain=(
                    n_cap * k * C.BLOCK_SIZE / ms_chain * 1e3),
                device_us=sum(dev_us.values()),
                device_us_by_kernel=dict(by_kernel.most_common()),
                **b)
            log(f"# channelizer K={k}: {n_cap} x {k * C.BLOCK_SIZE} samples "
                f"a block, {ms:.4f} ms ({rep['wideband_samples_per_s']:.6g} "
                f"wideband samples/s), with the chain {ms_chain:.4f} ms; "
                f"device {rep['device_us']:.2f} us a block in "
                f"{sum(m for _, m in per.values())} kernels, bound "
                f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}) ({card})")
            for kk, us in list(rep["device_us_by_kernel"].items())[:8]:
                log(f"#   {us:10.2f} us  {kk}")
        brief = {kk: v for kk, v in rep.items()
                 if kk != "device_us_by_kernel"}
        log(f"# channelizer K={k}: {json.dumps(brief)} ({card})")
        result["channelizer"][f"K{k}"] = rep

    # (b) channel sharding over MESH_SHARDS shards on the card
    chain = chains[True]
    data = rf_blocks(n_ch, MESH_BLOCKS)                 # (B, C, BLOCK)
    iq = data.permute(1, 0, 2).reshape(n_ch, -1)
    mesh = sharding.make_mesh(devices=[dev] * MESH_SHARDS)
    _, ref = stream(chain, p, data)
    _, ref_plain = stream(chains[False], p, data)
    reset_counts()
    st_sh, out_sh = sharding.channel_sharded_outputs(chain, mesh, p, iq)
    sync()
    c = read_counts()
    feed(c, rx_row, MESH_BLOCKS)
    # the kernels at a shard's n_ch / MESH_SHARDS channels against the
    # plain versions, and against the kernels at n_ch
    shard = {"shards": MESH_SHARDS,
             "launches": {kk: v for kk, v in c.items() if v},
             "vs_plain": _chain_parity("channel-sharded vs plain", out_sh,
                                       ref_plain),
             "vs_unsharded": _chain_parity("channel-sharded", out_sh, ref)}
    if cuda:
        def sharded():
            sharding.channel_sharded_outputs(chain, mesh, p, iq)

        def unsharded():
            stream(chain, p, data)

        for key, fn in (("sharded", sharded), ("unsharded", unsharded)):
            shard[f"ms_{key}"] = time_ms(fn, MESH_REPS)
            per, _ = kernel_us(fn, 3)
            shard[f"device_us_a_block_{key}"] = sum(
                us * m for us, m in per.values()) / MESH_BLOCKS
            shard[f"kernels_a_block_{key}"] = sum(
                m for _, m in per.values()) / MESH_BLOCKS
    # the elastic resume: a checkpoint at block MESH_RESUME[0] on 4
    # shards, resumed on MESH_RESUME[1]
    cut = MESH_RESUME[0] * C.BLOCK_SIZE
    st1, a1 = sharding.channel_sharded_stream(chain, mesh, p, iq[:, :cut])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "elastic.npz")
        checkpoint.save_state(path, st1, extra={"blocks_done":
                                                MESH_RESUME[0]})
        st_r, meta = checkpoint.load_state(path, chain.init_state((n_ch,)))
    mesh2 = sharding.make_mesh(devices=[dev] * MESH_RESUME[1])
    _, a2 = sharding.channel_sharded_stream(chain, mesh2, p, iq[:, cut:],
                                            st_r)
    joined = torch.cat([a1, a2], dim=-1)
    whole = out_sh["audio_24k"]
    d = (joined - whole).abs()
    snr_plain = parity.snr_db(ref_plain["audio_24k"], joined)
    shard["elastic"] = {
        "resumed_at_block": meta["blocks_done"],
        "shards": list(MESH_RESUME[1:]), "bit_for_bit": bool(torch.equal(
            joined, whole)),
        "max_abs_err": float(d.max()),
        "snr_db": _finite(parity.snr_db(whole, joined)),
        "vs_plain_snr_db": _finite(snr_plain)}
    # equal to the uninterrupted stream at tests/test_mesh.py's bounds,
    # and the resumed shards' kernels within the audio bound of the plain
    if bool((d > 1e-4 + 1e-3 * whole.abs()).any()) \
            or snr_plain < parity.AUDIO_SNR_MIN_DB:
        raise AssertionError(f"elastic resume: {shard['elastic']}")
    log(f"# channel-sharded: {json.dumps(shard)} ({card})")
    result["channel_sharded"] = shard

    # (c) the full chain time-sharded on a ch x t mesh, headless usb
    hl_kw = SPECS["headless"][0]
    hl = RxChain(ChainSpec(use_kernels=True, **hl_kw), device=dev)
    hl_plain = RxChain(ChainSpec(use_kernels=False, **hl_kw), device=dev)
    data = rf_blocks(n_ch, MESH_T_BLOCKS)
    iq = data.permute(1, 0, 2).reshape(n_ch, -1)
    _, ref = stream(hl, p, data)
    _, ref_plain = stream(hl_plain, p, data)
    ct = sharding.Mesh(np.asarray([dev] * (MESH_CT[0] * MESH_CT[1]),
                                  dtype=object).reshape(MESH_CT),
                       ("ch", "t"))

    def front_end():
        return timeshard.frontend_pass(hl, ct, iq, p, channel_axis="ch")

    timeshard.tail_pass(front_end())
    sync()                                          # warm-up
    reset_counts()
    got = timeshard.tail_pass(front_end())
    sync()
    c = read_counts()
    if not all(c[kk] for kk in ("K4", "K2", "K3")):
        raise AssertionError(f"time-sharded tail: launches {c}")
    feed(c, {}, MESH_T_BLOCKS)
    got = {kk: got[kk] for kk in ref}
    # the tail's kernels at a slice's n_ch / MESH_CT[0] channels against
    # the plain versions, and against the streamed chain's kernels
    tsh = {"mesh": dict(ct.shape), "blocks": MESH_T_BLOCKS,
           "launches": {kk: v for kk, v in c.items() if v},
           "vs_plain": _chain_parity("time-sharded vs plain", got,
                                     ref_plain),
           "vs_streamed": _chain_parity("time-sharded", got, ref)}
    if cuda:
        slices = front_end()
        tsh["ms_front_end"] = time_ms(front_end, MESH_REPS)
        tsh["ms_tail"] = time_ms(lambda: timeshard.tail_pass(slices),
                                 MESH_REPS)
    log(f"# time-sharded: {json.dumps(tsh)} ({card})")
    result["time_sharded"] = tsh

    # (d) an NCCL process group of one rank (gloo on a CPU rehearsal)
    with tempfile.TemporaryDirectory() as tmp:
        store = tdist.FileStore(os.path.join(tmp, "store"), 1)
        tdist.init_process_group("nccl" if cuda else "gloo", store=store,
                                 rank=0, world_size=1)
        try:
            dist.initialize()          # one process: returns at once
            gm = dist.global_mesh(axis="ch", devices=None if cuda
                                  else [dev])
            local = dist.shard_local_channels(gm, iq)
            if (local.offset, local.global_shape) != (0, tuple(iq.shape)):
                raise AssertionError(f"shard_local_channels: {local[1:]}")
            vals = -120.0 + 60.0 * torch.rand(n_ch, generator=g, device=dev)
            s = dist.fleet_summary(vals)
            mean = float(vals.mean())
            fleet = {"backend": tdist.get_backend(), "world": 1,
                     "mesh": {k: v for k, v in gm.shape.items()},
                     "max_equal": bool(torch.equal(s["max"], vals.max())),
                     "min_equal": bool(torch.equal(s["min"], vals.min())),
                     "mean_rel_err": abs(float(s["mean"]) - mean)
                     / abs(mean)}
        finally:
            tdist.destroy_process_group()
    if not (fleet["max_equal"] and fleet["min_equal"]
            and fleet["mean_rel_err"] <= 1e-6):
        raise AssertionError(f"fleet_summary: {fleet}")
    log(f"# distributed: {json.dumps(fleet)} ({card})")
    result["distributed"] = fleet
    result["phase_s"] = time.perf_counter() - t_phase
    return result


# phase 8: the measurement tools
TOOLS_BENCH = (          # (name, bench arguments); --min-ms TOOLS_MIN_MS
    ("rx_1024", ["--config", "rx", "--channels", "1024"]),
    ("rx_4096", ["--config", "rx", "--channels", "4096"]),
    ("rx_nodisplay", ["--config", "rx_nodisplay", "--channels", "1024"]),
    ("rx_q15", ["--config", "rx", "--q15", "--channels", "1024"]),
    ("nr", ["--config", "nr", "--channels", "1024"]),
    ("cw", ["--config", "cw", "--channels", "1024"]),
    ("beacon", ["--config", "beacon", "--channels", "1024"]),
    ("tx", ["--config", "tx", "--channels", "1024"]),
    ("channelizer", ["--config", "channelizer", "--channelizer-k", "16",
                     "--channels", "1024"]),
)
TOOLS_MIN_MS = 200.0
STAGE_CHANNELS = 1024
STAGE_BLOCKS = 8
STAGE_MIN_MS = 50.0
NB_ADD_ROUNDS = 6   # phase 8 (b): pallas and pallas_nb in turns
# beside the reference's variants: the noise blanker's share of a block,
# and the FFT overlap-save filter against the tap GEMMs with the kernels
STAGE_EXTRA = {"pallas_nb": dict(nb_on=True, use_kernels=True),
               "pallas_fft_osfilter": dict(use_matmul_osfilter=False,
                                           use_kernels=True)}
FT8_ARGS = ["--conds", "clean,fading", "--snrs=-20,-19,-18,-17,-16,-14,-10",
            "--trials", "10", "--seed", "0"]
FT8_PROB_TOL = 0.2       # decode probability against FT8_SENS.json
FT8_THRESH_TOL_DB = 1.0  # the clean 50% threshold against FT8_SENS.json
LINEARITY = (1.8, 2.2)   # 2x repeats' time ratio


def _kernels_of(kw: dict) -> set:
    """The kernels a `ChainSpec(use_kernels=True, **kw)` block launches."""
    need = {"K1"}
    psk = kw.get("mode") == "psk31"
    if not psk and kw.get("agc_mode", 2):
        need.add("K2")
    if kw.get("interpolate_out", True):
        need.add("K3")
    if not psk and not kw.get("spectrum_taps", True):
        need.add("K4")
    if not psk and kw.get("spectrum_taps", True) and kw.get(
            "use_matmul_osfilter", True):
        need.add("B1")
    if kw.get("mode") == "sam":
        need.add("K6")
    if kw.get("nr_mode") == 3 or kw.get("notch_on"):
        need.add("K7")
    if kw.get("nr_mode") == 1:
        need.add("K8")
    if kw.get("nr_mode") == 2:
        need.add("S1")
    if kw.get("eq_on"):
        need.add("E1")
    if kw.get("nb_on"):
        need.add("N1")
    return need


def _variant_rows(kw: dict) -> dict:
    """The kernels' rows a spec's launches go to, for the kernels with
    variant rows (phase 3's names): K1's by zoom and format, K7's by
    form, S1's by hops a launch (a `_batched` stagebench variant runs
    `block_batch` over 8 blocks: 16 hops), E1's at 1024 channels."""
    return {"K1": _k1_row(kw),
            "K7": f"K7 xanr {'notch' if kw.get('notch_on') else 'nr'}",
            "S1": S1_ROWS[16 if kw.get("_batched") else 2],
            "E1": E1_ROWS["channels"]}


def _k1_row(kw: dict) -> str:
    """The kernels' row a spec's K1 launches go to (phase 3's names)."""
    zoom = kw.get("spectrum_zoom", -1)
    return (f"K1 frontend zoom={zoom if zoom >= 0 else None} "
            f"{'q15' if kw.get('q15_input') else 'c64'}")


def tools_layer(dev, card: str, counts, feed) -> dict:
    """Phase 8, the measurement tools on the card, in process: (a)
    `t41x_torch.tools.bench` for each of TOOLS_BENCH at --min-ms
    TOOLS_MIN_MS: its parity (raised inside), the graphed checksum equal
    to the eager one bit for bit, the 2x-repeats time ratio within
    LINEARITY, the graphed and eager rates, and the kernels each run
    launched, and on the card the graphed rx block's kernels under the
    profiler (device µs, kernels and idle share a block); (b)
    `stagebench`, every variant at STAGE_CHANNELS and
    --min-ms STAGE_MIN_MS, none failed, each `use_kernels` variant
    launching its kernels and each plain one none; (c) `ft8_sensitivity`
    over FT8_ARGS on the card against `FT8_SENS.json` (every probability
    within FT8_PROB_TOL, the clean 50% threshold within
    FT8_THRESH_TOL_DB).  Each run's launches are counted from 0 (`counts`,
    the (reset, read) pair) and added to the kernels' rows by `feed`
    (blocks: K1's launches, one a block).  The tools print to stderr.
    Raises on any failure; returns the figures."""
    import contextlib

    from t41x_torch.chain import ChainSpec
    from t41x_torch.tools import bench, ft8_sensitivity, stagebench

    t_phase = time.perf_counter()
    reset_counts, read_counts = counts
    cuda = dev.type == "cuda"
    result = {"card": card, "bench": {}, "stagebench": {}}
    quiet = contextlib.redirect_stdout(sys.stderr)

    # (a) bench
    for name, argv in TOOLS_BENCH:
        t0 = time.perf_counter()
        reset_counts()
        with quiet:
            res = bench.main(argv + ["--min-ms", str(TOOLS_MIN_MS),
                                     "--device", str(dev)])
        c = read_counts()
        cfg = res["config"]
        kw = {**bench.cfg_map()[cfg["bench"]], "q15_input": cfg["q15"],
              "spectrum_taps": cfg["spectrum_taps"],
              "interpolate_out": cfg["interpolate_out"]}
        tx = cfg["bench"] == "tx"
        need = {"E1"} if tx else _kernels_of(kw)
        if any(c[k] == 0 for k in need):
            raise AssertionError(f"phase 8 (a) bench {name}: launches {c}")
        feed(c, _variant_rows(kw), c["E1"] if tx else c["K1"])
        lin = cfg["linearity_2x_time_ratio"]
        if cuda and not (cfg["graphed"] and cfg["checksum_graph_equals_eager"]
                         and LINEARITY[0] <= lin <= LINEARITY[1]):
            raise AssertionError(f"phase 8 (a) bench {name}: {cfg}")
        if not (res["value"] > 0 and np.isfinite(cfg["checksum"])):
            raise AssertionError(f"phase 8 (a) bench {name}: {res}")
        result["bench"][name] = {
            "metric": res["metric"], "rate": res["value"],
            "vs_baseline": res["vs_baseline"],
            "eager_rate": cfg["eager_rate"],
            "eager_vs_baseline": round(cfg["eager_rate"] / 192000.0, 2),
            **{k: cfg.get(k) for k in (
                "channels", "repeats", "timed_step_ms",
                "linearity_2x_time_ratio", "dispatch_floor_us", "graphed",
                "checksum_graph_equals_eager", "parity_db",
                "power_limit_w")},
            "launches": {k: v for k, v in c.items() if v},
            "wall_s": time.perf_counter() - t0}
        log(f"# phase 8 (a) bench {name}: {result['bench'][name]} ({card})")

    # where a graphed rx block's time goes: the replays' kernels under
    # the profiler, against the wall time of the same replays
    if cuda:
        n_ch, n_blk, n_rep = 1024, 8, 20
        spec = ChainSpec(spectrum_taps=True, use_matmul_osfilter=True,
                         use_kernels=True, interpolate_out=True,
                         **bench.cfg_map()["rx"])
        d = bench.dispatch(*bench.build("rx", spec, n_ch, n_blk, dev))
        per, wall = kernel_us(d.replay, n_rep)
        busy = sum(us * m for us, m in per.values()) / n_blk
        wall_us = wall / (n_rep * n_blk) * 1e6
        result["rx_graph_profile"] = {
            "channels": n_ch, "device_us_per_block": busy,
            "wall_us_per_block": wall_us,
            "device_idle_share": 1.0 - busy / wall_us,
            "kernels_per_block": sum(m for _, m in per.values()) / n_blk,
            "top_us_per_block": {k: us * m / n_blk for k, (us, m) in sorted(
                per.items(), key=lambda kv: -kv[1][0] * kv[1][1])[:8]}}
        log(f"# phase 8 (a) rx graph profile: {result['rx_graph_profile']} "
            f"({card})")

    # (b) stagebench, one variant at a time so that each one's launches
    # are its own
    floor_s = bench.dispatch_floor(dev)
    iq = bench.make_blocks(ChainSpec(), STAGE_CHANNELS, STAGE_BLOCKS, seed=0,
                           device=dev)
    for name, kw in {**stagebench.VARIANTS, **STAGE_EXTRA}.items():
        t0 = time.perf_counter()
        reset_counts()
        r = stagebench.time_variant(kw, STAGE_CHANNELS, STAGE_BLOCKS,
                                    STAGE_MIN_MS, dev, floor_s, iq)
        c = read_counts()
        launched = {k: v for k, v in c.items() if v}
        if kw["use_kernels"]:
            if any(c[k] == 0 for k in _kernels_of(kw)):
                raise AssertionError(f"phase 8 (b) {name}: launches {c}")
            feed(c, _variant_rows(kw), c["K1"])
        elif launched:
            raise AssertionError(f"phase 8 (b) plain {name}: launches {c}")
        if cuda and not r["graphed"]:
            raise AssertionError(f"phase 8 (b) {name}: not graphed")
        result["stagebench"][name] = {
            "us_per_block": r["us_per_block"], "rate": r["rate"],
            "repeats": r["repeats"], "launches": launched,
            "wall_s": time.perf_counter() - t0}
        log(f"# phase 8 (b) stagebench {name:26s} {r['us_per_block']:9.1f} "
            f"us/block/{STAGE_CHANNELS}ch  {launched} ({card})")
    result["stagebench_floor_us"] = floor_s * 1e6
    # the noise blanker's add over `pallas`, with its spread: NB_ADD_ROUNDS
    # rounds of the two, in turns (pallas, nb, nb, pallas, ...)
    adds = []
    for i in range(NB_ADD_ROUNDS):
        pair = ("pallas", "pallas_nb")[::1 if i % 2 == 0 else -1]
        us = {k: stagebench.time_variant(
            {**stagebench.VARIANTS, **STAGE_EXTRA}[k], STAGE_CHANNELS,
            STAGE_BLOCKS, STAGE_MIN_MS, dev, floor_s, iq)["us_per_block"]
            for k in pair}
        adds.append(us["pallas_nb"] - us["pallas"])
    result["stagebench_nb_add_us"] = adds
    log(f"# phase 8 (b) stagebench pallas_nb - pallas over {NB_ADD_ROUNDS} "
        f"rounds: mean {np.mean(adds):.2f}, min {min(adds):.2f}, max "
        f"{max(adds):.2f} us/block/{STAGE_CHANNELS}ch ({card})")

    # (c) ft8_sensitivity against the reference's record
    t0 = time.perf_counter()
    with quiet:
        rec = ft8_sensitivity.main(FT8_ARGS + ["--device", str(dev)])
    ref = json.loads((Path(__file__).resolve().parent
                      / "FT8_SENS.json").read_text())
    diffs = {}
    for cond, cells in rec["table"].items():
        for snr, cell in cells.items():
            want = ref["table"][cond][str(float(snr))]["prob"]
            diffs[f"{cond} {snr}"] = round(cell["prob"] - want, 3)
    worst = max(abs(d) for d in diffs.values())
    th, th_ref = rec["clean_threshold_db"], ref["clean_threshold_db"]
    result["ft8"] = {
        "table": {cond: {str(snr): cell["prob"] for snr, cell in cells.items()}
                  for cond, cells in rec["table"].items()},
        "prob_minus_t41x": diffs, "max_abs_prob_diff": worst,
        "clean_threshold_db": th, "t41x_clean_threshold_db": th_ref,
        "snr_calibration": rec.get("snr_calibration"),
        "wall_s": time.perf_counter() - t0}
    log(f"# phase 8 (c) ft8_sensitivity: {result['ft8']} ({card})")
    if worst > FT8_PROB_TOL or th is None \
            or abs(th - th_ref) > FT8_THRESH_TOL_DB:
        raise AssertionError(f"phase 8 (c) ft8_sensitivity: {result['ft8']}")
    result["phase_s"] = time.perf_counter() - t_phase
    return result


def _ft8_cli_line(d) -> str:
    from t41x_torch import cli

    return cli._ft8_line(d)


def _finite(x: float):
    """A figure for the JSON line: "inf" where two outputs are equal."""
    return x if np.isfinite(x) else str(x)


def main(argv: list[str]) -> int:
    import torch
    import torch.nn.functional as F

    root = None  # --kernels ROOT: phases 1, 2 and 6 (a) on ROOT's t41x_torch
    host_only = argv == ["--host"]  # phases 1 and 5
    txdec_only = argv == ["--txdec"]  # phases 1 and 6
    mesh_only = argv == ["--mesh"]  # phases 1 and 7
    tools_only = argv == ["--tools"]  # phases 1 and 8
    if len(argv) == 2 and argv[0] == "--kernels":
        root = Path(argv[1]).resolve()
        sys.path.insert(0, str(root))
    elif argv and not (host_only or txdec_only or mesh_only or tools_only):
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
        from t41x_torch.dsp import osfilter
        from t41x_torch.dsp.spectrum import ZoomFFT
        from t41x_torch.kernels import _build
        from t41x_torch.kernels import agc as kagc
        from t41x_torch.kernels import compressor as kcomp
        from t41x_torch.kernels import frontend as kfe
        from t41x_torch.kernels import interp as kint
        from t41x_torch.kernels import nr_gain as knr
        from t41x_torch.kernels import os_filter as kos
        from t41x_torch.kernels import sam as ksam
        from t41x_torch.kernels import xanr as kxanr
        from t41x_torch.utils import parity
        if root is None or (root / "t41x_torch/kernels/nb.py").exists():
            from t41x_torch.kernels import nb as knb
        else:   # --kernels on a tree from before N1 (kernel_ab.py)
            knb = None
        if root is None or (root / "t41x_torch/kernels/eq.py").exists():
            from t41x_torch.dsp import eq as eq_mod
            from t41x_torch.kernels import eq as keq
            from t41x_torch.kernels import spectral_nr as kspec
        else:   # --kernels on a tree from before S1 and E1
            keq = kspec = None
        if root is None or (root / "t41x_torch/kernels/os_spectrum.py"
                            ).exists():
            from t41x_torch.kernels import os_spectrum as kb1
        else:   # --kernels on a tree from before B1
            kb1 = None
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
    try:
        from t41x_torch.utils.tracing import setup_seconds
        built = setup_seconds().get("kernel_load", 0.0)
    except ImportError:   # --kernels on a tree from before the tracer
        built = _build.build_seconds
    log(f"# build: {built:.1f} s (nvcc sm_90a, "
        f"{len(list(_build.SRC_DIR.glob('*.cu')))} sources)")

    counters = {"K1": (kfe.FusedFrontEnd, "launches"),
                "K2": (kagc.agc_block, "launches"),
                "K3": (kint.FusedInterp, "launches"),
                "K4": (kos.os_filter_matmul_kernel, "launches"),
                "K5": (kagc.agc_scan, "launches"),
                "K6": (ksam.sam_block, "launches"),
                "K7": (kxanr.xanr_block, "launches"),
                "K8": (knr.kim_gains, "launches"),
                "C1": (kcomp.launch, "launches")}
    if knb is not None:
        counters["N1"] = (knb.launch, "launches")
    if kspec is not None:
        counters["S1"] = (kspec.spectral_gains, "launches")
        counters["E1"] = (keq.eq_block, "launches")
    if kb1 is not None:
        counters["B1"] = (kb1.os_spectrum, "launches")

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
            plain_reps=REPS, plain_device=False, library=None, n_ch=N_CH):
        """One kernel's line: its device time (profiler), the wrapper's
        and the plain version's times (CUDA events), its bound from
        `flops` and the bytes of `ins` and `outs`, and the library call's
        device time where one PyTorch call computes the same.  `tol` is
        (rtol, atol), or the words of another criterion."""
        dev_us = device_us(fn_k, KERNEL_NAMES[name[:2]])
        wrapper_ms = time_ms(fn_k)
        plain_ms = time_ms(fn_p, plain_reps)
        plain_dev = device_us(fn_p) / 1e3 if plain_device else None
        lib_ms = device_us(library) / 1e3 if library is not None else None
        b = bound(flops, nbytes(ins, outs))
        share = b["bound_ms"] * 1e3 / dev_us
        rows.append(dict(name=name, route="cuda", source=src[0],
                         replaces=src[1], launches=0, blocks=0,
                         max_abs_err=err, ms=dev_us / 1e3,
                         wrapper_ms=wrapper_ms, plain_ms=plain_ms,
                         plain_device_ms=plain_dev, library_ms=lib_ms,
                         bound_share=share, **b))
        within = (tol if isinstance(tol, str)
                  else f"rtol {tol[0]}, atol {tol[1]}")
        log(f"# {name}: max |err| {err:.3g} within {within}; device "
            f"{dev_us:.2f} us a launch, bound "
            f"{b['bound_ms'] * 1e3:.2f} us ({b['bound_by']}; {b['flops']:.4g} "
            f"flop, {b['bytes']:.4g} B; {share:.1%} of the launch); wrapper "
            f"{wrapper_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms"
            + (f" ({plain_dev * 1e3:.2f} us on the device)"
               if plain_dev is not None else "")
            + (f", library call {lib_ms * 1e3:.2f} us" if lib_ms else "")
            + f" per call ({n_ch} channels, {card})")

    def finish(extra: dict) -> int:
        """The kernels' JSON line, the phases' lines, the card's line and
        the last line; raises if a kernel row launched on no main path."""
        for r in rows:
            r["launches_per_block"] = (r["launches"] / r["blocks"]
                                       if r["blocks"] else 0.0)
            del r["blocks"]
            if r["launches"] == 0:
                raise AssertionError(f"{r['name']}: launched on no main "
                                     "path")
        log(f"# profiler: {len(_spins_dropped)} sessions; spin records "
            f"dropped at a session's start, by count: "
            f"{dict(sorted(Counter(_spins_dropped).items()))}")
        print(json.dumps({"kernels": rows}))
        return last_lines(extra)

    def last_lines(extra: dict) -> int:
        """The phases' lines, the card's line and the last line."""
        for k, v in extra.items():
            print(json.dumps({k: v}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    count_fns = (reset_counts, read_counts)
    if txdec_only:
        return finish({"txdec": tx_decoders(dev, card, rows, row, time_ms,
                                            count_fns)})
    # --mesh, --tools: no kernel rows; the paths' launches are checked
    # and logged
    if mesh_only:
        return last_lines({"mesh": mesh_layer(
            dev, card, N_CH, count_fns, lambda *a: None, time_ms, kernel_us,
            rf_blocks, params)})
    if tools_only:
        return last_lines({"tools": tools_layer(dev, card, count_fns,
                                                lambda *a: None)})

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

    if hasattr(kagc, "agc_block_phases"):
        log_phases("K2", lambda: kagc.agc_block_phases(ap, st_k, x2)[2],
                   kagc.K2_PHASES, card, "recurrence", C.AUDIO_BLOCK)
        log_phases("K5", lambda: kagc.agc_scan_phases(ap, c_k, rm, ao)[2],
                   kagc.K5_PHASES, card, "recurrence", AGC_PIECE)

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
                   kint.K3_PHASES, card)

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

    # B1: the spectrum-tap band-pass at the chain's level scale, from a
    # random history over 3 streamed blocks, against the plain version
    # (the two GEMMs) within float32 rounding of the largest output;
    # timed at phase 3's 1024 channels and at the bulk cells' 4096, with
    # the torch.fft form of the same stage as its library call
    if kb1 is not None:
        ops = (rx.tensors["os_F"], rx.tensors["os_W2"],
               rx.tensors["os_mask_sq"])
        tab, mask_t, sc = rx.tensors["os_tab"], rx.tensors["mask"], \
            rx.vol_scale
        # from a generator of its own: the later stimuli stay those of
        # earlier trees
        gen_b1 = torch.Generator(device=dev).manual_seed(21)
        for n_ch in B1_CHANNELS:
            s_k = s_p = cnoise(n_ch, C.FFT_LENGTH // 2, scale=0.3, g=gen_b1)
            err = 0.0
            for b in range(3):
                x = cnoise(n_ch, C.FFT_LENGTH // 2, scale=0.3, g=gen_b1)
                s_k, y_k, sp_k = kb1.os_spectrum(s_k, x, *ops, tab, sc)
                s_p, y_p, sp_p = kb1.os_spectrum_plain(s_p, x, *ops, sc)
                err = max(err, close("B1 y", y_k, y_p, 1e-4,
                                     1e-5 * float(y_p.abs().max())))
                close("B1 spectrum", sp_k, sp_p, 1e-4,
                      1e-5 * float(sp_p.abs().max()))
                close("B1 state", s_k, s_p, 0.0, 0.0)
            row(f"B1 os_spectrum {n_ch}", B1,
                lambda: kb1.os_spectrum(s_k, x, *ops, tab, sc),
                lambda: kb1.os_spectrum_plain(s_k, x, *ops, sc), err,
                "rtol 1e-4, atol 1e-5 of the largest output",
                b1_flops(n_ch), (s_k, x),
                kb1.os_spectrum(s_k, x, *ops, tab, sc), plain_device=True,
                library=lambda: osfilter.os_filter(
                    s_k, x * sc, mask_t, return_spectrum=True), n_ch=n_ch)

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
                   ksam.K6_PHASES, card, "phase loop", C.AUDIO_BLOCK)

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
                       kxanr.K7_PHASES, card, "loop", C.AUDIO_BLOCK)

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

    # N1: audio frames at the chain's shape (1024 x 256), the tone with
    # 1-3 impulses a frame (`nb_stimulus`), then crowded impulse noise
    # (its slow path: long dependent walks).  Its decisions against the
    # plain version's (`parity.nb_decisions`), the silent frames passed
    # through
    if knb is not None:
        n = C.AUDIO_BLOCK
        # the crowded frames from a generator of their own, so that the
        # later phases' stimuli (drawn from `gen`) stay as they were
        gen_crowd = torch.Generator(device=dev).manual_seed(16)
        for kind, name, g in (("tone", "N1 nb", gen),
                              ("crowded", "N1 nb crowded", gen_crowd)):
            xa = nb_stimulus(kind, N_CH, n, g, dev)
            y_k, m_k = knb.launch_with_mask(xa)
            y_p = nb_mod.noise_blanker_plain(xa)
            m_p, margin = nb_mod.decision_margin(xa)
            torch.cuda.synchronize()
            rep = parity.nb_decisions(xa, y_k, m_k, y_p, m_p, margin)
            log(f"# {name} decisions against the plain version: {rep} "
                f"({N_CH} frames of {n}, {card})")
            if not (rep["ok"] and rep["blanked_samples"] > 0
                    and (kind != "tone" or torch.equal(y_k[8::16],
                                                       xa[8::16]))):
                raise AssertionError(f"{name} vs its plain version: {rep}")
            same = ~(m_k ^ m_p).any(dim=-1)
            row(name, N1, lambda: nb_mod.noise_blanker(xa),
                lambda: nb_mod.noise_blanker_plain(xa),
                float((y_k[same] - y_p[same]).abs().max()),
                f"{parity.AUDIO_SNR_MIN_DB} dB ({rep['snr_db']:.1f}), "
                f"{rep['mask_samples_differ']} mask samples differing",
                n1_flops(xa, m_p), (xa,), y_k, plain_reps=REPS_PLAIN)
            # where a frame's time goes, and the predictors' cycles a
            # blanked sample
            log_phases(name, lambda: knb.nb_phases(xa)[1], knb.N1_PHASES,
                       card, "predict", float(m_p.sum()) / N_CH)

    # S1: audio at the chain's rate through the NR's own transforms to
    # its bin powers, per channel a noise level of its own and a keyed
    # 700 Hz tone at 0-100 times it (the in-band ratio sweeps the five
    # widths), every 8th channel silent; from the initial state, so the
    # streams cross the 20 init hops: 32 blocks 2 hops a launch
    # (`spectral_nr`), then 8 launches of 16 (`spectral_nr_batch`),
    # each the kernel's and the plain version's own state carried.
    # The NN choices may differ only within parity.NR_MARGIN_MAX of a
    # boundary (`parity.nr_decisions`, counted); the states within
    # parity.NR_STATE_RTOL (bit for bit counted), the init flags equal
    if kspec is not None:
        spp = nr_mod.spectral_params(200.0, 3000.0)
        n_s1 = 32 + 8 * 8
        t = torch.arange(n_s1 * C.AUDIO_BLOCK, device=dev) / C.AUDIO_RATE
        lvl = 10.0 ** (3.0 * torch.rand(N_CH, 1, generator=gen,
                                        device=dev) - 3.0)
        keyed = (torch.rand(N_CH, n_s1, generator=gen, device=dev) < 0.5
                 ).repeat_interleave(C.AUDIO_BLOCK, dim=-1)
        amp = lvl * torch.tensor([0.0, 1.0, 10.0, 100.0], device=dev)[
            torch.randint(0, 4, (N_CH, 1), generator=gen, device=dev)]
        aud = lvl * torch.randn(N_CH, t.numel(), generator=gen, device=dev) \
            + amp * keyed * torch.sin(2 * np.pi * 700.0 * t)
        aud[4::8] = 0.0
        aud = aud.reshape(N_CH, n_s1, C.AUDIO_BLOCK).movedim(1, 0)
        sst = nr_mod.spectral_state((N_CH,), dev)
        g_k = g_p = (sst.xt, sst.pslp, sst.hk_old, sst.frames)
        last, b = sst.last_sample, 0
        window = nr_mod._window(nr_mod._sqrt_hann, aud)
        for hops, calls in ((2, 32), (16, 8)):
            rep_all, err, exact = Counter(), 0.0, True
            for _ in range(calls):
                xs = aud[b: b + hops // 2]
                b += hops // 2
                _, frames = nr_mod._hop_frames(last, xs)
                last = xs[-1, ..., nr_mod.HOP:]
                pw = nr_mod._half_spectra(frames * window)[2]
                nn_k = torch.empty(pw.shape[:-1], dtype=torch.int32,
                                   device=dev)
                g_k, y_k, i_k = kspec.spectral_gains(spp, g_k, pw, nn_k)
                nn_p, margin = nr_mod.spectral_decision_margin(spp, g_p, pw)
                g_p, y_p, i_p = kspec.spectral_gains_plain(spp, g_p, pw)
                rep = parity.nr_decisions(y_k, nn_k, y_p, nn_p, margin)
                if not (rep["ok"] and torch.equal(i_k, i_p)
                        and torch.equal(g_k[3], g_p[3])):
                    raise AssertionError(f"S1 vs its plain version: {rep}")
                for i, (a, r) in enumerate(zip(g_k[:3], g_p[:3])):
                    close(f"S1 state[{i}]", a, r, parity.NR_STATE_RTOL, 1e-30)
                    exact &= torch.equal(a, r)
                rep_all.update({k: v for k, v in rep.items()
                                if k not in ("ok", "finite", "max_abs_err")})
                err = max(err, rep["max_abs_err"])
            log(f"# S1 {hops} hops a launch, {calls} launches against the "
                f"plain version: {dict(rep_all)}, gains max |err| {err:.3g}, "
                f"states bit for bit: {exact} ({N_CH} channels, {card})")
            g_row = g_k
            row(S1_ROWS[hops], S1, lambda: kspec.spectral_gains(spp, g_row, pw),
                lambda: kspec.spectral_gains_plain(spp, g_row, pw), err,
                f"NN choices within {parity.NR_MARGIN_MAX} of a boundary "
                f"({rep_all['choices_differ']} differing), gains rtol "
                f"{parity.NR_GAIN_RTOL}, atol {parity.NR_GAIN_ATOL}",
                OPS_PER_ELEMENT["S1"] * pw.numel(), (pw, g_row),
                kspec.spectral_gains(spp, g_row, pw))
            # where a channel's time goes, and the recursion's cycles a
            # hop (trees before the stamped variant have none)
            if hasattr(kspec, "spectral_gains_phases"):
                log_phases(f"S1 {hops} hops",
                           lambda: kspec.spectral_gains_phases(spp, g_row,
                                                               pw)[3],
                           kspec.S1_PHASES, card, "recursion", hops)

    # E1: audio at every channel's level of its own (noise and tones at
    # three band centres), per-channel gains with one band at 0, from a
    # random state, 16 blocks of 256 each carrying its own state; and
    # one channel with shared (14,) gains (Radio.transmit_ssb).  Output
    # and state >= parity.EQ_SNR_MIN_DB from the plain version's every
    # block
    if keq is not None:
        eqd = eq_mod.EQDesign()
        centres = torch.tensor(eq_mod.band_centers(), device=dev,
                               dtype=torch.float32)
        for ch in (N_CH, 1):
            lead = (ch,) if ch > 1 else ()
            t = torch.arange(16 * C.AUDIO_BLOCK, device=dev) / C.AUDIO_RATE
            lvl = 10.0 ** (3.0 * torch.rand(ch, 1, generator=gen,
                                            device=dev) - 3.0)
            fc = centres[torch.randint(0, 14, (ch, 3), generator=gen,
                                       device=dev)]
            aud = lvl * (torch.randn(ch, t.numel(), generator=gen,
                                     device=dev)
                         + torch.sin(2 * np.pi * fc[..., None] * t).sum(1))
            aud = aud.reshape(ch, 16, C.AUDIO_BLOCK).movedim(1, 0)
            gains = torch.rand(ch, 14, generator=gen, device=dev)
            gains[torch.arange(ch), torch.arange(ch) % 14] = 0.0
            e_st = 0.1 * torch.randn(ch, 14, 2, 2, generator=gen, device=dev)
            aud, gains, e_st = (aud.reshape((16,) + lead + (-1,)),
                                gains.reshape(lead + (14,)),
                                e_st.reshape(lead + (14, 2, 2)))
            s_k = s_p = e_st
            worst, err = np.inf, 0.0
            for b in range(16):
                s_k, y_k = eqd.apply(s_k, aud[b], gains, use_kernels=True)
                s_p, y_p = eqd.apply_plain(s_p, aud[b], gains)
                if not bool(torch.isfinite(y_k).all()):
                    raise AssertionError("E1: non-finite output")
                worst = min(worst, parity.snr_db(y_p, y_k),
                            parity.snr_db(s_p, s_k))
                err = max(err, float((y_k - y_p).abs().max()))
            log(f"# E1 {ch} x {C.AUDIO_BLOCK} against the plain version over "
                f"16 blocks: worst {worst:.1f} dB (output and state), max "
                f"|err| {err:.3g} ({card})")
            if not worst >= parity.EQ_SNR_MIN_DB:
                raise AssertionError(f"E1 at {ch} channels: {worst} dB")
            x0 = aud[0]
            row(E1_ROWS["channels" if ch > 1 else "one"], E1,
                lambda: eqd.apply(s_k, x0, gains, use_kernels=True),
                lambda: eqd.apply_plain(s_k, x0, gains), err,
                f"{parity.EQ_SNR_MIN_DB} dB ({worst:.1f})", e1_flops(x0),
                (x0, s_k, gains), eqd.apply(s_k, x0, gains, use_kernels=True))
            if hasattr(keq, "eq_phases"):
                log_phases(f"E1 {ch} x {C.AUDIO_BLOCK}",
                           lambda: keq.eq_phases(eqd, s_k, x0, gains)[2],
                           keq.E1_PHASES, card, n_ch=ch)

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
        # C1's row (phase 6 (a)), then the flagship and headless blocks'
        # kernels, for kernel_ab.py
        c1_check(dev, card, rows, row)
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
        feed(counts, _variant_rows(kw), B)
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
            # the two paths' inputs differ too (K1's ~1e-8); on the kernel
            # path's own blanker input N1 (run again: the chain's output,
            # bit for bit) may decide otherwise than the plain blanker only
            # near the threshold (`parity.nb_decisions`)
            xb = pre_k["audio_24k"].reshape(-1, C.AUDIO_BLOCK).contiguous()
            y_n1, mask_n1 = knb.launch_with_mask(xb)
            m_b, margin = nb_mod.decision_margin(xb)
            rep = parity.nb_decisions(xb, y_n1, mask_n1,
                                      nb_mod.noise_blanker_plain(xb), m_b,
                                      margin)
            report["nb_decisions_on_the_kernel_path_input"] = rep
            if not (rep["ok"] and torch.equal(
                    y_n1, out_k["audio_24k"].reshape(xb.shape))):
                raise AssertionError(f"{name}: N1 on the chain's blanker "
                                     f"input: {rep}")
            # the eager block's wall, with N1 and with the plain loop
            for use_kernels in (True, False):
                chain = RxChain(ChainSpec(use_kernels=use_kernels, **kw),
                                device=dev)
                st = chain.block(pr, chain.init_state((N_CH,)), src[0])[0]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in range(B):
                    st = chain.block(pr, st, src[b])[0]
                torch.cuda.synchronize()
                report[f"nb_eager_block_ms_{'n1' if use_kernels else 'plain'}"
                       ] = (time.perf_counter() - t0) / B * 1e3
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
    runner = host_layers(dev, card, N_CH, stim, count_fns)

    # ---- 6. the transmit chains and the decoders ---------------------------
    txdec = tx_decoders(dev, card, rows, row, time_ms, count_fns)

    # ---- 7. the mesh layer ---------------------------------------------------
    mesh = mesh_layer(dev, card, N_CH, count_fns, feed, time_ms, kernel_us,
                      rf_blocks, params)

    # ---- 8. the measurement tools ----------------------------------------------
    tools = tools_layer(dev, card, count_fns, feed)
    return finish({"runner": runner, "txdec": txdec, "mesh": mesh,
                   "tools": tools})


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
