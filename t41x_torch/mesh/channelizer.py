"""Wideband polyphase channelizer (torch), port of `t41x.mesh.channelizer`.

The reference receives ONE 192 kHz channel from analog hardware; the
channelizer decomposes a single wideband I/Q capture (K x 192 kHz wide)
into K critically-sampled 192 kHz channels, which then fan out over the
mesh's channel axis into the standard receive chain.

Classic critically-sampled polyphase DFT filter bank.  Channel k is
decimate-by-K of x[n] e^{-j2pi kn/K} filtered by the prototype h; with
n = tK + p:

    y_k[m] = sum_p e^{+j2pi kp/K} v_p[m]
    v_p[m] = sum_t h[tK+p] * u_p[m-t],   with  u_p[m] = x[mK - p]

so the commutator feeds the phases in reversed order with a one-sample
stagger.  The reversal is folded into the coefficients (`hp_r`) and the
DFT matrix (`E2`), so the frame tensor is one reshape (a view) of
[history | block]; the branch FIRs are P slice multiply-adds over a
(nf, 2K) real buffer holding re and im side by side, and the phase DFT is
one real (2K, 2K) product with `W2` in float32 (TF32 is off, see
`t41x_torch/__init__.py`).  The design in `__init__` is `t41x`'s NumPy
code, so every design array equals `t41x`'s bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.utils import windows as W


class Channelizer:
    """K-channel polyphase DFT bank.  It runs on the card unless the caller
    passes `device="cpu"`; with no card visible that default raises."""

    def __init__(self, num_channels: int, taps_per_phase: int = 12,
                 fs_channel: float = C.SAMPLE_RATE, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Channelizer: no CUDA card is visible; pass device=\"cpu\" "
                "to run it on the CPU")
        self.K = num_channels
        self.P = taps_per_phase
        self.fs_channel = fs_channel
        self.fs_in = num_channels * fs_channel
        n = num_channels * taps_per_phase
        # prototype lowpass: cutoff at the channel Nyquist
        beta = W.kaiser_beta(80.0)
        h = np.sinc(np.arange(n) / num_channels
                    - taps_per_phase / 2) * W.kaiser(n, beta)
        h /= h.sum()
        # polyphase decomposition: hp[p, t] = h[t*K + p]
        self.hp = (h.reshape(taps_per_phase, num_channels).T
                   * num_channels).astype(np.float32)
        # the commutator's reversed phase order folded into the
        # coefficients and the DFT matrix: hp_r[i, t] = hp[K-1-i, t] and
        # E2[k, i] = e^{+j 2pi k (K-1-i) / K}
        self.hp_r = self.hp[::-1, :].copy()
        kk = np.arange(num_channels)
        self.E2 = np.exp(2j * np.pi * np.outer(
            kk, num_channels - 1 - kk) / num_channels).astype(np.complex64)
        # the phase DFT as one real product: [vr | vi] @ W2 = [ch_r | ch_i]
        Er, Ei = self.E2.real, self.E2.imag
        self.W2 = np.block([[Er.T, Ei.T],
                            [-Ei.T, Er.T]]).astype(np.float32)
        # hp_r for the packed (re | im) lanes, tap-major: (P, 2K)
        hp2 = np.tile(self.hp_r[:, None], (2, 1, 1)).reshape(
            2 * num_channels, taps_per_phase)
        self._hp2 = torch.from_numpy(np.ascontiguousarray(hp2.T)).to(
            self.device)
        self._W2 = torch.from_numpy(self.W2).to(self.device)

    def init_state(self, batch: tuple[int, ...] = ()) -> torch.Tensor:
        """(..., P*K - 1) raw-sample history (commutator + FIR tails),
        complex64 on the channelizer's device."""
        return torch.zeros(batch + (self.P * self.K - 1,),
                           dtype=torch.complex64, device=self.device)

    def block(self, state: torch.Tensor, x: torch.Tensor):
        """x: (..., N) wideband complex64 at K*fs, N divisible by K.
        Returns (state, channels) with channels (..., K, N/K), a view with
        the last two axes swapped; channel k is centred at +k*fs_channel
        (k > K/2: negative frequencies)."""
        K, P = self.K, self.P
        L = P * K - 1
        n_out = x.shape[-1] // K
        xc = torch.cat([state, x], dim=-1)  # xc[j] = x[j - L]
        new_state = xc[..., -L:]

        # frame tensor U[mm, i] = x[(mm - P + 1)K + i - K + 1]: splitting
        # the contiguous last axis is a view, no copy
        nf = n_out + P - 1
        U = xc[..., : nf * K].reshape(x.shape[:-1] + (nf, K))
        U2 = torch.cat([U.real, U.imag], dim=-1)          # (.., nf, 2K)
        hp2 = self._hp2
        v = hp2[0] * U2[..., P - 1: P - 1 + n_out, :]
        for t in range(1, P):
            v = v + hp2[t] * U2[..., P - 1 - t: P - 1 - t + n_out, :]

        ch2 = torch.matmul(v, self._W2)                   # [ch_r | ch_i]
        ch = torch.complex(ch2[..., :K], ch2[..., K:])
        return new_state, ch.transpose(-1, -2)

    def channel_center_hz(self, k: int) -> float:
        """Centre frequency of channel k in the wideband capture."""
        k = k if k <= self.K // 2 else k - self.K
        return k * self.fs_channel
