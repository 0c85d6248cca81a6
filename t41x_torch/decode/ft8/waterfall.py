"""FT8 waterfall front end (torch, device side), port of
`t41x.decode.ft8.waterfall`.

Re-expression of the reference's FT8 DSP front end (`extract_power`,
tmr4/T41_SDR `ft8.cpp:223-256`): a log-power waterfall over the 15 s
receive slot with 2x oversampling in both time and frequency, feeding
the Costas sync search and soft-bit extraction.

As in t41x (see its module docstring for the measurements behind each
choice): the 24 kHz demodulated audio directly, no q15 decimation to
6.4 kHz; float32 dB throughout; every time slot in ONE batched rFFT of
the (frames, 3840) gather, zero-padded to 7680 for the half-bin
frequency oversampling; a RECTANGULAR symbol window, the matched filter
of 6.25 Hz-spaced FSK tones.  The rFFT is `torch.fft.rfft` (t41x's
`kernels.mxu_fft.rfft` is `jnp.fft.rfft` off the TPU).

Output layout matches the reference indexing semantics:
power[slot, time_sub, freq_sub, bin] with bin spacing 6.25 Hz and
freq_sub selecting a 3.125 Hz half-bin offset.
"""

from __future__ import annotations

import torch

from t41x_torch import constants as C

SYMBOL_SECONDS = 0.16
TONE_SPACING = 6.25
MAX_FREQ_HZ = 3200.0  # search span (reference: 368 bins * 6.25 = 2300)


def waterfall_shape(n_audio: int, rate: float = C.AUDIO_RATE):
    hop = int(round(SYMBOL_SECONDS * rate / 2))     # 0.08 s
    win = 2 * hop                                    # one symbol window
    n_frames = max((n_audio - 2 * win) // hop + 1, 0)
    n_slots = n_frames // 2
    n_bins = int(MAX_FREQ_HZ / TONE_SPACING)
    return n_slots, n_bins


def compute_waterfall(audio: torch.Tensor, rate: float = C.AUDIO_RATE):
    """audio: (..., N) real audio at `rate`.

    Returns power (..., n_slots, 2, 2, n_bins) in dB — indexed like the
    reference's export_fft_power: [symbol slot, half-symbol time offset,
    half-bin freq offset, 6.25 Hz bin].
    """
    hop = int(round(SYMBOL_SECONDS * rate / 2))      # 1920 @ 24 kHz
    win = 2 * hop                                     # 3840 = 1 symbol
    fft_len = 2 * win                                 # zero-pad x2 for
    #                                                   3.125 Hz bins
    if audio.shape[-1] < win:   # no whole frame
        db = audio.new_zeros(audio.shape[:-1] + (0, fft_len // 2 + 1))
    else:
        frames = audio.unfold(-1, win, hop)           # (..., F, win)
        # rectangular window = the FSK matched filter (module docstring)
        spec = torch.fft.rfft(frames, n=fft_len, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        db = 10.0 * torch.log10(torch.clamp_min(power, 1e-12))
    n_frames = db.shape[-2]

    n_bins = int(MAX_FREQ_HZ / TONE_SPACING)
    # bin b (6.25 Hz) at freq_sub s (0 or 3.125 Hz offset):
    # fft bin index = 2*b + s  (fft resolution = rate/fft_len)
    res = rate / fft_len
    scale = TONE_SPACING / res
    base = (torch.arange(n_bins, device=audio.device) * scale).to(
        torch.int64)
    half = int(round(TONE_SPACING / 2 / res))
    n_slots = n_frames // 2
    # (..., 2 * n_slots, 2[freq_sub], n_bins) -> (..., n_slots, 2, 2, B)
    wf = torch.stack([db[..., base], db[..., base + half]], dim=-2)
    wf = wf[..., : n_slots * 2, :, :]
    return wf.reshape(wf.shape[:-3] + (n_slots, 2, 2, n_bins))
