"""Mic compressor (torch), port of `t41x.chain.compressor`.

Re-expression of the reference's TX audio compressor (open-audio
`AudioEffectCompressor`, configured in `SetupMyCompressors`
tmr4/T41_SDR `DSP_Fn.cpp:83-103`, driven from the SSB TX state machine
`T41_SDR.ino:1105-1113`): a feed-forward dB-domain compressor with
threshold (knee), ratio, and attack/release envelope smoothing.

The envelope is a per-sample recurrence whose attack/release choice
depends on the carried envelope, so it has no exact chunked or
associative form.  `compress_plain` runs it as a torch loop over the
samples, each operation rounded on its own in float32 (`level_db`, then
the coefficient, the envelope, the excess over the knee and the gain);
on a CUDA tensor `compress` launches the hand-written kernel C1
(`t41x_torch/kernels/compressor.py`), which keeps that order, unless the
caller asks for the plain loop (`use_kernel=False`, as
`TxSpec(use_kernels=False)` does).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from t41x_torch import constants as C


class CompressorParams(NamedTuple):
    thresh_dbfs: float = -10.0
    ratio: float = 5.0
    attack_coeff: float = 0.0
    release_coeff: float = 0.0
    makeup_db: float = 0.0


def compressor_params(thresh_dbfs: float = -10.0, ratio: float = 5.0,
                      attack_sec: float = 0.005,
                      release_sec: float = 0.200,
                      rate: float = C.SAMPLE_RATE,
                      makeup_db: float = 0.0) -> CompressorParams:
    return CompressorParams(
        thresh_dbfs=thresh_dbfs,
        ratio=ratio,
        attack_coeff=float(np.exp(-1.0 / (attack_sec * rate))),
        release_coeff=float(np.exp(-1.0 / (release_sec * rate))),
        makeup_db=makeup_db,
    )


class CompressorState(NamedTuple):
    env_db: torch.Tensor  # (...,) smoothed level estimate, dBFS


def compressor_state(channels: tuple[int, ...] = (),
                     device="cuda") -> CompressorState:
    return CompressorState(torch.full(channels, -120.0, dtype=torch.float32,
                                      device=device))


def gain_consts(p: CompressorParams) -> np.ndarray:
    """The float32 constants of the recurrence and the gain, as both
    versions round them: attack and release coefficients, 1 minus each,
    the knee, 1 - 1/ratio and the makeup gain."""
    a, r = np.float32(p.attack_coeff), np.float32(p.release_coeff)
    return np.asarray([a, r, np.float32(1.0) - a, np.float32(1.0) - r,
                       p.thresh_dbfs, 1.0 - 1.0 / p.ratio, p.makeup_db],
                      np.float32)


def compress_plain(p: CompressorParams, st: CompressorState,
                   x: torch.Tensor):
    """The compressor in plain torch ops (any device): x (..., N) audio.
    Returns (state, y)."""
    k = torch.from_numpy(gain_consts(p)).to(x.device)
    level_db = 20.0 * torch.log10(torch.clamp_min(x.abs(), 1e-9))
    env = st.env_db
    envs = []
    for n in range(x.shape[-1]):
        ldb = level_db[..., n]
        coeff = torch.where(ldb > env, k[0], k[1])
        env = coeff * env + (1.0 - coeff) * ldb
        envs.append(env)
    env_all = torch.stack(envs, dim=-1) if envs else level_db
    over = torch.clamp_min(env_all - k[4], 0.0)
    gain_db = -over * k[5] + k[6]
    # a divisor on the device: a Python scalar divisor becomes a product
    # with its reciprocal on CUDA, one rounding more than the kernel's
    y = x * torch.pow(10.0, gain_db / torch.full((), 20.0, device=x.device))
    return CompressorState(env), y


def compress(p: CompressorParams, st: CompressorState, x: torch.Tensor,
             use_kernel: bool = True):
    """x: (..., N) audio.  Returns (state, y).  CPU tensors, or
    `use_kernel=False`, take `compress_plain`; CUDA tensors launch C1
    (`t41x_torch.kernels.compressor.launch`), which raises if it cannot
    build or launch."""
    if not (x.is_cuda and use_kernel):
        return compress_plain(p, st, x)
    from t41x_torch.kernels import compressor as kcomp

    return kcomp.launch(p, st, x)
