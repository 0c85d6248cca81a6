"""Value parity of the `ChainSpec` options that no spec table covers:
`mode="lsb"`, `agc_mode` 0, 1, 3 and 4, `use_matmul_osfilter=False`,
and in mode cw `cw_decode=False` and `cw_tone_hz=600`.  Each runs in the
port and in t41x on the same numpy-seeded capture (2 channels, 3
blocks), kernels (plain versions on the CPU) against t41x's Pallas path
in interpret mode, and plain against plain.  The outputs are held at
tests/test_torch_rx_chain.py's tolerances (rf_spectrum rtol 2e-4 / atol
2e-3 of its peak, the rest rtol 2e-4 / atol 2e-5), the audio at >= 55
dB SNR and the displayed spectra within 0.5 dB; `cw_keyed` and the clip
taps are equal.  `test_torch_rx_options.py` checks every option for
keys and shapes."""

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

CH, BLOCKS = 2, 3
SPECS = {
    "lsb": dict(mode="lsb"),
    "agc0": dict(mode="usb", agc_mode=0),
    "agc1": dict(mode="usb", agc_mode=1),
    "agc3": dict(mode="usb", agc_mode=3),
    "agc4": dict(mode="usb", agc_mode=4),
    "fft_osfilter": dict(mode="usb", use_matmul_osfilter=False),
    "cw_no_decode": dict(mode="cw", cw_decode=False),
    "cw_tone600": dict(mode="cw", cw_tone_hz=600.0),
}
EXACT = ("adc_half_clip", "adc_quarter_clip", "cw_keyed")


def _iq(kw, seed=13):
    """Tones 1500 Hz above and 1100 Hz below the Fs/4-shifted tuning in
    noise (the lsb spec hears the lower one), or in mode cw a carrier at
    the spec's sidetone, keyed on for 2 blocks and off for 1."""
    rng = np.random.default_rng(seed)
    n = BLOCKS * C.BLOCK_SIZE
    t = np.arange(n) / C.SAMPLE_RATE
    noise = (rng.standard_normal((CH, n))
             + 1j * rng.standard_normal((CH, n))) * 0.05
    if kw["mode"] == "cw":
        key = np.arange(n) < 2 * C.BLOCK_SIZE
        tone = kw.get("cw_tone_hz", 750.0)
        sig = 0.3 * key * np.exp(2j * np.pi * (-C.SAMPLE_RATE / 4 + tone)
                                 * t)
        noise *= 0.2
    else:
        sig = sum(a * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + f) * t)
                  for a, f in ((0.3, 1500.0), (0.2, -1100.0)))
    return (sig + noise).astype(np.complex64)


def _params(cw):
    """Spread fine tune, gain and IQ correction; in mode cw every channel
    tuned to the carrier."""
    p = jparams((CH,))
    if cw:
        return p
    return p._replace(
        nco_freq=np.linspace(-200.0, 300.0, CH).astype(np.float32),
        rf_gain_db=np.linspace(-3.0, 6.0, CH).astype(np.float32),
        iq_amp=np.linspace(0.97, 1.03, CH).astype(np.float32),
        iq_phase=np.linspace(-0.02, 0.02, CH).astype(np.float32))


def _assert_close(got, ref, k, msg):
    if k in EXACT:
        np.testing.assert_array_equal(got, ref, err_msg=f"{msg} {k}")
    elif k == "rf_spectrum":
        np.testing.assert_allclose(got, ref, rtol=2e-4,
                                   atol=2e-3 * float(np.max(ref)),
                                   err_msg=f"{msg} {k}")
        assert parity.spectrum_err_db(ref, got) \
            <= parity.SPECTRUM_ERR_MAX_DB, k
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5,
                                   err_msg=f"{msg} {k}")
        if k == "audio_spectrum":
            assert parity.spectrum_err_db(ref, got) \
                <= parity.SPECTRUM_ERR_MAX_DB, k
        elif k.startswith("audio"):
            assert parity.snr_db(ref, got) >= parity.AUDIO_SNR_MIN_DB, k


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_option_values_match_t41x(spec, kernels):
    kw = SPECS[spec]
    jc = JChain(JSpec(use_pallas=kernels, **kw))
    tc = RxChain(ChainSpec(use_kernels=kernels, **kw), device="cpu")
    assert (tc.fused_fe is not None) == kernels
    jp = _params(kw["mode"] == "cw")
    tp = convert.params_from_numpy(jp, device="cpu")
    step = jax.jit(jc.block)
    js, ts = jc.init_state((CH,)), tc.init_state((CH,))
    iq = _iq(kw)
    keyed = []
    for b in range(BLOCKS):
        blk = np.ascontiguousarray(iq[:, b * C.BLOCK_SIZE:
                                      (b + 1) * C.BLOCK_SIZE])
        js, jo = step(jp, js, blk)
        ts, to = tc.block(tp, ts, torch.from_numpy(blk))
        assert set(to) == set(jo)
        for k, v in jo.items():
            got, ref = to[k].numpy(), np.asarray(v)
            assert got.shape == ref.shape and got.dtype == ref.dtype, k
            _assert_close(got, ref, k, f"{spec} block {b}")
        if "cw_keyed" in to:
            keyed.append(to["cw_keyed"].numpy())
    if keyed:  # the keyed carrier is heard, as t41x hears it
        assert np.asarray(keyed).any(), keyed
    fa = jax.tree.leaves(convert.state_to_numpy(ts))
    fb = jax.tree.leaves(js)
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        b = np.asarray(b)
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        np.testing.assert_allclose(np.asarray(a), b, rtol=2e-3,
                                   atol=max(5e-4, 1e-3 * scale))
