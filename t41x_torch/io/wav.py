"""WAV file I/O (host side).

Covers what the reference's SD WAV reader provides for its test modes
(tmr4/T41_SDR `Utility.cpp:773-888` `load_wav`/`readWave`: PCM16 mono with
16/18/40-byte fmt chunks) plus stereo I/Q capture files, which t41x uses as
its golden-test fixture format.  Pure `struct`-based, no external deps.

A copy of `t41x.io.wav`, so the port never imports JAX
(`tests/test_torch_host_copies.py` pins the two equal).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class WavInfo:
    sample_rate: int
    num_channels: int
    bits_per_sample: int
    num_frames: int


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM16/PCM32/float32 WAV file.

    Returns (data, sample_rate) where data is float32 in [-1, 1) of shape
    (frames,) for mono or (frames, channels) otherwise.  Scaling of PCM16
    matches the reference's q15 semantics (x / 32768).
    """
    with open(path, "rb") as f:
        riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, csize = struct.unpack("<4sI", hdr)
            payload = f.read(csize + (csize & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload[:csize]
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _brate, _balign, bits = fmt
    if bits == 16:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 32 and audio_format == 3:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif bits == 32:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"{path}: unsupported bits_per_sample={bits}")
    if channels > 1:
        x = x[: len(x) // channels * channels].reshape(-1, channels)
    return x, rate


def write_wav(path: str, data: np.ndarray, sample_rate: int,
              bits: int = 16) -> None:
    """Write float data in [-1, 1) as a PCM16 (or float32) WAV file."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    channels = data.shape[1]
    if bits == 16:
        pcm = np.clip(np.round(data * 32768.0), -32768, 32767).astype("<i2")
        payload = pcm.tobytes()
        fmt_tag, balign = 1, 2 * channels
    elif bits == 32:
        payload = data.astype("<f4").tobytes()
        fmt_tag, balign = 3, 4 * channels
    else:
        raise ValueError(f"unsupported bits={bits}")
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(struct.pack("<4sI", b"fmt ", 16))
        f.write(struct.pack("<HHIIHH", fmt_tag, channels, sample_rate,
                            sample_rate * balign, balign, bits))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)


def read_iq_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a stereo WAV as a complex I/Q capture: L=I (real), R=Q (imag)."""
    x, rate = read_wav(path)
    if x.ndim != 2 or x.shape[1] != 2:
        raise ValueError(f"{path}: I/Q capture must be 2-channel")
    return (x[:, 0] + 1j * x[:, 1]).astype(np.complex64), rate


def write_iq_wav(path: str, iq: np.ndarray, sample_rate: int) -> None:
    """Write a complex I/Q array as a stereo WAV (L=I, R=Q)."""
    data = np.stack([iq.real, iq.imag], axis=-1)
    write_wav(path, data, sample_rate)
