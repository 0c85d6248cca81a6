"""SAM under a spread fine tune: the loop's own sensitivity, not a fault
of the port.

With `nco_freq` over -500..700 Hz (tests/test_torch_rx_chain.py's
spread) and chip_smoke.py's AM stimulus (a carrier 30 Hz above the
tuning, 30% modulated at 400 Hz), the carrier lands 30 - nco_freq Hz
from the PLL.  Within ~250 Hz the loop locks firmly; farther out it
sits at the edge of its pull-in range or slews.  On the card the port's
kernel and plain chains part there by up to 48 dB of audio PSD.  t41x
parts from itself as far: its scan against the same scan on the capture
moved by one float32 ulp a sample, and its scan against its own Pallas
kernel (interpret mode), differ by tens of dB on the far channels.  On
the near ones, the port's chain, t41x's and the perturbed runs agree
within the 3 dB PSD bound and 0.1 Hz of carrier.  So chip_smoke.py
drives sam with every channel tuned to the carrier.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.chain import ChainSpec as JSpec, RxChain as JChain
from t41x.chain import default_params as jparams
from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.utils import convert, parity

torch.set_num_threads(1)

CH, BLOCKS = 8, 12
KW = dict(mode="sam", f_lo=-3000.0, f_hi=3000.0)
NCO = np.linspace(-500.0, 700.0, CH).astype(np.float32)
NEAR = np.abs(30.0 - NCO) < 250.0   # channels 2-4: the loop locks
FAR = ~NEAR


def _params():
    return jparams((CH,))._replace(
        nco_freq=NCO, rf_gain_db=np.linspace(-3.0, 6.0, CH).astype(np.float32),
        iq_amp=np.linspace(0.97, 1.03, CH).astype(np.float32),
        iq_phase=np.linspace(-0.02, 0.02, CH).astype(np.float32))


@functools.cache
def _captures():
    """chip_smoke.py's AM stimulus, and the same moved by one float32 ulp
    a sample, up or down at random (K1's kernel and plain version differ
    by ~1e-8 on its ~0.1-1 outputs: about that)."""
    rng = np.random.default_rng(17)
    t = np.arange(BLOCKS * C.BLOCK_SIZE) / C.SAMPLE_RATE
    env = 0.4 * (1.0 + 0.3 * np.cos(2 * np.pi * 400.0 * t))
    sig = env * np.exp(2j * np.pi * (-C.SAMPLE_RATE / 4 + 30.0) * t)
    noise = rng.standard_normal((CH, t.size)) \
        + 1j * rng.standard_normal((CH, t.size))
    iq = (sig + 0.01 * noise).astype(np.complex64)

    def ulp(a):
        up = rng.integers(0, 2, a.shape).astype(bool)
        inf = np.float32(np.inf)
        return np.where(up, np.nextafter(a, inf), np.nextafter(a, -inf))

    moved = (ulp(iq.real) + 1j * ulp(iq.imag)).astype(np.complex64)
    return iq, moved


def _blocks(iq):
    return [np.ascontiguousarray(iq[:, b * C.BLOCK_SIZE:
                                    (b + 1) * C.BLOCK_SIZE])
            for b in range(BLOCKS)]


@functools.cache
def _t41x(moved: bool, pallas: bool):
    jc = JChain(JSpec(use_pallas=pallas, **KW))
    step = jax.jit(jc.block)
    st, outs = jc.init_state((CH,)), []
    for blk in _blocks(_captures()[moved]):
        st, o = step(_params(), st, blk)
        outs.append((np.asarray(o["audio_24k"]),
                     np.asarray(o["sam_carrier_hz"])))
    return tuple(np.stack(a) for a in zip(*outs))


@functools.cache
def _port():
    tc = RxChain(ChainSpec(use_kernels=False, **KW), device="cpu")
    tp = convert.params_from_numpy(_params(), device="cpu")
    st, outs = tc.init_state((CH,)), []
    for blk in _blocks(_captures()[0]):
        st, o = tc.block(tp, st, torch.from_numpy(blk))
        outs.append((o["audio_24k"].numpy(), o["sam_carrier_hz"].numpy()))
    return tuple(np.stack(a) for a in zip(*outs))


def _psd(a, b, chans):
    return parity.psd_err_db(a[:, chans], b[:, chans])


def _carrier(a, b, chans):
    return float(np.abs(a[-1, chans] - b[-1, chans]).max())


@pytest.mark.parametrize("other", ["t41x moved one ulp", "t41x Pallas"])
def test_t41x_parts_from_itself_on_the_far_channels(other):
    """t41x against itself on the far channels: beyond the 3 dB bound
    (by more than 9 dB), as the card's kernel and plain chains part."""
    ref = _t41x(False, False)
    got = _t41x(True, False) if other.endswith("ulp") else \
        _t41x(False, True)
    assert _psd(ref[0], got[0], FAR) > 3 * parity.PSD_ERR_MAX_DB


@pytest.mark.parametrize("other", ["t41x", "t41x moved one ulp",
                                   "t41x Pallas"])
def test_port_holds_the_near_channels(other):
    """Where the loop locks, the port's plain chain is within the PSD and
    carrier bounds of t41x's scan, of its Pallas path and of its run on
    the moved capture; t41x's scan is within them of the two too."""
    ref = {"t41x": _t41x(False, False),
           "t41x moved one ulp": _t41x(True, False),
           "t41x Pallas": _t41x(False, True)}[other]
    for got in (_port(),) + ((_t41x(False, False),) if other != "t41x"
                             else ()):
        assert _psd(ref[0], got[0], NEAR) <= parity.PSD_ERR_MAX_DB
        assert _carrier(ref[1], got[1], NEAR) <= 0.1
    # and the near channels did lock: their carrier is the tuning error
    np.testing.assert_allclose(ref[1][-1, NEAR], (30.0 - NCO)[NEAR],
                               atol=1.0)
