"""Full-chain golden parity of the port: its receive chain (the plain
versions, on the CPU) against an independent NumPy oracle built from the
same filter designs, the mirror of `tests/test_golden_parity.py`.  With
no runnable reference firmware the oracle plays the recorded golden
output; every stage is composed from first-principles NumPy ops, not
the port's stages."""

import numpy as np
import pytest
import torch

from t41x_torch import constants as C
from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.io import signals

torch.set_num_threads(2)


def oracle_chain(iq: np.ndarray, chain: RxChain,
                 nco_freq: float = 0.0) -> np.ndarray:
    """NumPy reference: Fs/4 shift -> NCO -> x4 -> x2 decimation ->
    overlap-save band-pass (as direct convolution) -> real part."""
    x = iq.astype(np.complex128)
    n = len(x)
    x = x * (1j ** (np.arange(n) % 4))
    # NCO mix down (phase convention of the chain's nco: theta_n uses n+1)
    w = 2 * np.pi * nco_freq / C.SAMPLE_RATE
    x = 1.1 * x * np.exp(-1j * w * np.arange(1, n + 1))

    def decim(sig, h, m):
        # causal filter, then keep phase m-1 (CMSIS convention)
        return np.convolve(sig, h)[: len(sig)][m - 1:: m]

    def decim_c(sig, h, m):
        return decim(sig.real, h, m) + 1j * decim(sig.imag, h, m)

    x = decim_c(x, chain.h1.astype(np.float64), C.DF1)
    x = decim_c(x, chain.h2.astype(np.float64), C.DF2)
    x = x * chain.vol_scale
    # overlap-save == plain linear convolution with the complex taps
    taps = np.fft.ifft(chain.mask.astype(np.complex128))[:257]
    return np.convolve(x, taps)[: len(x)].real


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("n_blocks,nco,bound", [(24, 0.0, 55.0),
                                                (16, 4000.0, 50.0)])
def test_full_chain_matches_numpy_oracle(use_kernels, n_blocks, nco, bound):
    """The bounds of tests/test_golden_parity.py: 55 dB on band-limited
    random I/Q around the USB audio band, 50 dB with the NCO at 4 kHz."""
    n = n_blocks * C.BLOCK_SIZE
    if nco:
        iq = signals.usb_signal([1200.0], n, nco=nco) * 0.3
    else:
        iq = (signals.usb_signal([400.0, 900.0, 1700.0, 2600.0], n,
                                 amps=[1.0, 0.7, 0.5, 0.3]) * 0.2
              + signals.awgn(n, 0.01, seed=3))
    chain = RxChain(ChainSpec(mode="usb", agc_mode=0, spectrum_taps=False,
                              interpolate_out=False,
                              use_kernels=use_kernels), device="cpu")
    got = chain.run(np.asarray(iq, np.complex64), params=default_params(
        (), nco_freq=nco, device="cpu"))["audio_24k"].numpy()
    # AGC off applies fixed_gain 20
    want = oracle_chain(np.asarray(iq), chain, nco_freq=nco) * 20.0
    err = got[256:] - want[256:]
    snr = 10 * np.log10(np.mean(want[256:] ** 2) / np.mean(err ** 2))
    assert snr > bound, snr
