"""Framework-wide signal constants.

These mirror the reference radio's fixed operating point (tmr4/T41_SDR:
`SDT.h:39,70`, `T41_SDR.ino:333-368`) so that t41x chains are drop-in
signal-compatible, while the *framework* treats them as defaults, not
hardwired globals — every chain is parameterized by a `ChainSpec`.
A copy of `t41x.constants`, so the port never imports JAX.
"""

from __future__ import annotations

# Input complex sample rate of one receiver channel (reference: 192 kHz I/Q).
SAMPLE_RATE = 192_000

# Overlap-save FFT length (reference `SDT.h:39` FFT_LENGTH = 512).
FFT_LENGTH = 512

# Two-stage decimation: 192k -> 48k -> 24k (reference `T41_SDR.ino:333-335`).
DF1 = 4
DF2 = 2
DF = DF1 * DF2

# Audio-rate sample rate after decimation.
AUDIO_RATE = SAMPLE_RATE // DF  # 24_000

# Samples ingested per processing block at the RF rate
# (reference BUFFER_SIZE * N_BLOCKS = 128 * 16 = 2048, `T41_SDR.ino:368`).
BLOCK_SIZE = FFT_LENGTH // 2 * DF  # 2048

# Audio samples produced per block (= FFT_LENGTH/2 = 256 @ 24 kHz).
AUDIO_BLOCK = BLOCK_SIZE // DF  # 256

# Real-time budget per block, seconds.
BLOCK_SECONDS = BLOCK_SIZE / SAMPLE_RATE  # ~10.667 ms

# Decimation anti-alias design targets (reference `T41_SDR.ino:336-345`).
N_ATT = 90.0           # stopband attenuation, dB
N_DESIRED_BW = 9.0     # kHz, max filter BW
N_SAMPLERATE = 176.0   # kHz, nominal pre-decimation rate used in tap estimate


def kaiser_tap_estimate(att_db: float, f_pass: float, f_stop: float) -> int:
    """Kaiser tap-count estimate, as used for the decimator prototypes
    (reference `T41_SDR.ino:344-345`): taps = 1 + att / (22 (fstop - fpass))."""
    return 1 + int(att_db / (22.0 * (f_stop - f_pass)))


def dec1_taps() -> int:
    fpass = N_DESIRED_BW / N_SAMPLERATE
    fstop = (N_SAMPLERATE / DF1 - N_DESIRED_BW) / N_SAMPLERATE
    return kaiser_tap_estimate(N_ATT, fpass, fstop)


def dec2_taps() -> int:
    fpass = N_DESIRED_BW / (N_SAMPLERATE / DF1)
    fstop = (N_SAMPLERATE / (DF1 * DF2) - N_DESIRED_BW) / (N_SAMPLERATE / DF1)
    return kaiser_tap_estimate(N_ATT, fpass, fstop)


# Interpolator tap counts (reference `T41_SDR.ino:595-616`).
INT1_TAPS = 48
INT2_TAPS = 32

# Spectrum display resolution (reference `Display.h:11`).
SPECTRUM_RES = 512
