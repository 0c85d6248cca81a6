"""14-band receive equalizer (torch), port of `t41x.dsp.eq`.

The reference's receive EQ (tmr4/T41_SDR `DoReceiveEQ`
`Filter.cpp:117-165`): 14 parallel 4-pole band-pass biquad cascades at
1/3-octave centers (fc_i = 125 * 2^((i+1)/3), 198 Hz ... 4 kHz,
`FIR.cpp:279-371`), each scaled by the user's per-band gain with the
sign of alternate bands flipped against the cascades' phase inversion,
and summed.  All 14 cascades are composed at design time into one
chunk operator (`dsp.chunk_ops.compose_cascade_ops`): per 32-sample
chunk, [x | 56 states] goes through two products, every band's output
and the next states — 8 chunks per 256-sample block.  The products are
plain `torch.matmul` in full fp32, as `t41x` leaves them to XLA
(`EQDesign.apply_plain`).  With `use_kernels`, CUDA tensors run the whole
block in the CUDA kernel E1 (`kernels.eq`), which takes the same chunk
operators from their nonzero blocks (`EQDesign.kernel_consts`).
"""

from __future__ import annotations

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.dsp.chunk_ops import compose_cascade_ops

NUM_BANDS = 14
_CHUNK = 32


def band_centers() -> np.ndarray:
    i = np.arange(1, NUM_BANDS + 1)
    return 125.0 * 2.0 ** ((i + 1) / 3.0)


def design_eq_bands(rate: float = C.AUDIO_RATE):
    """Returns (b, a) of shape (14, S, 3): per-band biquad cascades
    (4th-order Butterworth band-passes, ~0.3 fc wide)."""
    from scipy import signal

    bs, as_ = [], []
    for fc in band_centers():
        bw = 0.3045 * fc
        lo = max(fc - bw / 2.0, 10.0)
        hi = min(fc + bw / 2.0, rate / 2.0 * 0.98)
        sos = signal.butter(2, [lo, hi], btype="bandpass", fs=rate,
                            output="sos")
        bs.append(sos[:, :3])
        as_.append(sos[:, 3:])
    return (np.asarray(bs, np.float32), np.asarray(as_, np.float32))


# band signs: band 1 -, band 2 +, band 3 -, ... (Filter.cpp:136-149)
_SIGNS = np.asarray([(-1.0) ** (i + 1) * -1.0 for i in range(NUM_BANDS)],
                    np.float32)


class EQDesign:
    """The composed 14-band operator and `apply` over (state, audio)."""

    def __init__(self, rate: float = C.AUDIO_RATE, chunk: int = _CHUNK):
        self.b, self.a = design_eq_bands(rate)
        self.stages = S = self.b.shape[1]
        self.chunk = K = int(chunk)
        ns = 2 * S                               # states per band (4)
        NS = NUM_BANDS * ns                      # all states (56)
        # combined chunk operator over [x(K) | s(56)]:
        #   y_all  = z @ Wy   (K+56, 14*K)   every band's chunk output
        #   s_next = z @ Ws   (K+56, 56)
        Wy = np.zeros((K + NS, NUM_BANDS * K))
        Ws = np.zeros((K + NS, NS))
        for bi in range(NUM_BANDS):
            L, R, G, AK = compose_cascade_ops(self.b[bi], self.a[bi], K)
            yc = slice(bi * K, (bi + 1) * K)
            sc = slice(K + bi * ns, K + (bi + 1) * ns)
            Wy[:K, yc] = L.T
            Wy[sc, yc] = R.T
            Ws[:K, bi * ns:(bi + 1) * ns] = G
            Ws[sc, bi * ns:(bi + 1) * ns] = AK.T
        self.Wy = Wy.astype(np.float32)
        self.Ws = Ws.astype(np.float32)
        self.kernel_consts = self._kernel_consts()
        self._on_device = {}
        self._kernel_on_device = {}

    def _kernel_consts(self) -> np.ndarray:
        """E1's float32 constants, the nonzero blocks of Wy and Ws
        (their float32 values, so the kernel's products are the plain
        version's): each band's impulse response h (14, K) (its L is the
        Toeplitz matrix L[k, j] = h[k - j]), the state-to-output rows R
        (K, 56), each state's input column G (56, K), each state's row of
        its band's AK (56, 4), and the band signs (14,)."""
        K, ns = self.chunk, 2 * self.stages
        NS = NUM_BANDS * ns
        Wy, Ws = self.Wy, self.Ws
        h = Wy[0].reshape(NUM_BANDS, K)
        band = np.arange(NS) // ns
        R = np.stack([Wy[K + n, band[n] * K: (band[n] + 1) * K]
                      for n in range(NS)], axis=1)
        G = Ws[:K].T
        AK = np.stack([Ws[K + band[n] * ns: K + (band[n] + 1) * ns, n]
                       for n in range(NS)])
        return np.concatenate([h.ravel(), R.ravel(), G.ravel(), AK.ravel(),
                               _SIGNS]).astype(np.float32)

    def init_state(self, channels: tuple[int, ...] = (),
                   device=None) -> torch.Tensor:
        """(..., 14, S, 2) per-band cascade states (normal form)."""
        return torch.zeros(channels + (NUM_BANDS, self.stages, 2),
                           dtype=torch.float32, device=device)

    def _ops(self, device):
        if device not in self._on_device:
            self._on_device[device] = [torch.from_numpy(a).to(device)
                                       for a in (self.Wy, self.Ws, _SIGNS)]
        return self._on_device[device]

    def kernel_ops(self, device) -> torch.Tensor:
        """`kernel_consts` on `device`, copied there once."""
        if device not in self._kernel_on_device:
            self._kernel_on_device[device] = torch.from_numpy(
                self.kernel_consts).to(device)
        return self._kernel_on_device[device]

    def apply(self, state: torch.Tensor, x: torch.Tensor,
              gains: torch.Tensor, use_kernels: bool = False):
        """x: (..., N) audio; gains: (..., 14) in 0..1 (user setting/100).
        Returns (state, y).  Odd bands are negated like the reference
        (`Filter.cpp:136-149`).  With `use_kernels`, CUDA tensors launch
        E1; CPU tensors always take the plain version."""
        if use_kernels:
            from t41x_torch.kernels.eq import eq_block
            return eq_block(self, state, x, gains)
        return self.apply_plain(state, x, gains)

    def apply_plain(self, state: torch.Tensor, x: torch.Tensor,
                    gains: torch.Tensor):
        """`apply` in plain torch ops (any device): the chunk scan of
        `t41x.dsp.eq.EQDesign.apply`, two fp32 products a chunk."""
        K = self.chunk
        lead = x.shape[:-1]
        n = x.shape[-1]
        assert n % K == 0, (n, K)
        nc = n // K
        Wy, Ws, signs = self._ops(x.device)
        s = state.reshape(lead + (-1,)).to(x.dtype)
        xs = x.reshape(lead + (nc, K))
        ys = []
        for c in range(nc):
            z = torch.cat([xs[..., c, :], s], dim=-1)   # (..., K+56)
            s, y = z @ Ws, z @ Wy                      # next state, outs
            ys.append(y)
        yb = torch.stack(ys, dim=-2).reshape(lead + (nc, NUM_BANDS, K))
        yb = yb.movedim(-2, -3).reshape(lead + (NUM_BANDS, n))
        y = torch.sum(yb * (signs * gains)[..., None], dim=-2)
        return s.reshape(lead + (NUM_BANDS, self.stages, 2)), y
