"""The port's receive chain with the zoom 2^z panadapter against t41x's:
zoom 1, 3 and 7, zoom 1 with q15 ingest, and the spec `t41x.radio.Radio`
builds from a default `RadioConfig` (zoom 1, no output interpolation);
kernels (the plain version of K1's zoom variant on the CPU) against
t41x's Pallas path in interpret mode, and plain against plain.

Outputs are held at the tolerances of tests/test_torch_rx_chain.py
(rf_spectrum rtol 2e-4 / atol 2e-3 of its peak, the rest rtol 2e-4 /
atol 2e-5), the audio at >= 55 dB and the displayed spectrum within
0.5 dB; the carried `ZoomState` crosses between the packages mid-stream.
"""

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

SPECS = {
    "zoom1": dict(mode="usb", spectrum_zoom=1),
    "zoom3": dict(mode="usb", spectrum_zoom=3),
    "zoom7": dict(mode="usb", spectrum_zoom=7),
    "zoom1_q15": dict(mode="usb", spectrum_zoom=1, q15_input=True),
    # Radio.chain's spec for a default RadioConfig (t41x/radio.py:209-228)
    "radio_default": dict(mode="usb", f_lo=200.0, f_hi=3000.0, agc_mode=2,
                          spectrum_zoom=1, interpolate_out=False),
}


def _params(ch):
    p = jparams((ch,))
    return p._replace(
        nco_freq=np.linspace(-500.0, 700.0, ch).astype(np.float32),
        rf_gain_db=np.linspace(-3.0, 6.0, ch).astype(np.float32),
        iq_amp=np.linspace(0.97, 1.03, ch).astype(np.float32),
        iq_phase=np.linspace(-0.02, 0.02, ch).astype(np.float32))


def _blocks(ch, blocks, q15, seed=11):
    """A tone at Fs/4 + 1500 Hz plus one inside every zoom's span, in
    noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * C.BLOCK_SIZE) / C.SAMPLE_RATE
    iq = (0.3 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + 1500.0) * t)
          + 0.2 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 - 400.0) * t)
          + (rng.standard_normal((ch, t.size))
             + 1j * rng.standard_normal((ch, t.size))) * 0.05
          ).astype(np.complex64)
    out = []
    for b in range(blocks):
        x = iq[:, b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
        out.append(tuple(np.clip(np.round(a * 32768.0), -32768, 32767
                                 ).astype(np.int16) for a in (x.real, x.imag))
                   if q15 else np.ascontiguousarray(x))
    return out


def _torch_blk(blk):
    return (tuple(map(torch.from_numpy, blk)) if isinstance(blk, tuple)
            else torch.from_numpy(blk))


def _assert_close(got, ref, k, msg=""):
    if k == "rf_spectrum":
        np.testing.assert_allclose(got, ref, rtol=2e-4,
                                   atol=2e-3 * float(np.max(ref)),
                                   err_msg=f"{msg} {k}")
        assert parity.spectrum_err_db(ref, got) \
            <= parity.SPECTRUM_ERR_MAX_DB, k
    elif k == "audio_spectrum":
        assert parity.spectrum_err_db(ref, got) \
            <= parity.SPECTRUM_ERR_MAX_DB, k
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5,
                                   err_msg=f"{msg} {k}")
        if k.startswith("audio"):
            assert parity.snr_db(ref, got) >= parity.AUDIO_SNR_MIN_DB, k


def _assert_state_close(sa, sb):
    fa, fb = jax.tree.leaves(sa), jax.tree.leaves(sb)
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        np.testing.assert_allclose(a, b, rtol=2e-3,
                                   atol=max(5e-4, 1e-3 * scale))


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_zoom_specs_match_t41x(spec, kernels):
    ch = 3
    kw = SPECS[spec]
    jc = JChain(JSpec(use_pallas=kernels, **kw))
    tc = RxChain(ChainSpec(use_kernels=kernels, **kw), device="cpu")
    assert (tc.fused_fe is not None) == kernels
    if kernels:
        assert tc.fused_fe.zoom == kw["spectrum_zoom"]
    jp = _params(ch)
    tp = convert.params_from_numpy(jp, device="cpu")
    step = jax.jit(jc.block)
    js, ts = jc.init_state((ch,)), tc.init_state((ch,))
    for b, blk in enumerate(_blocks(ch, 2, kw.get("q15_input", False))):
        js, jo = step(jp, js, blk)
        ts, to = tc.block(tp, ts, _torch_blk(blk))
        assert set(to) == set(jo)
        for k, v in jo.items():
            got, ref = to[k].numpy(), np.asarray(v)
            assert got.shape == ref.shape and got.dtype == ref.dtype, k
            _assert_close(got, ref, k, f"block {b}")
    _assert_state_close(convert.state_to_numpy(ts), js)


def test_zoom_state_moves_between_t41x_and_port_mid_stream():
    """2 blocks in t41x, 1 in the port (zoom kernel's plain version),
    then t41x again: the ZoomState crosses both ways as the port's
    NamedTuple, and the stream matches t41x's throughout."""
    ch = 3
    kw = SPECS["zoom3"]
    jc = JChain(JSpec(use_pallas=True, **kw))
    tc = RxChain(ChainSpec(use_kernels=True, **kw), device="cpu")
    jp = _params(ch)
    tp = convert.params_from_numpy(jp, device="cpu")
    step = jax.jit(jc.block)
    ref, mix = jc.init_state((ch,)), jc.init_state((ch,))
    for b, blk in enumerate(_blocks(ch, 4, False, seed=5)):
        ref, out_ref = step(jp, ref, blk)
        if b == 2:
            st = convert.state_from_numpy(jax.tree.map(np.asarray, mix),
                                          device="cpu")
            assert type(st.zoom).__module__ == "t41x_torch.dsp.spectrum"
            st, out = tc.block(tp, st, torch.from_numpy(blk))
            mix = convert.state_to_numpy(st)
            out = {k: v.numpy() for k, v in out.items()}
        else:
            mix, out = step(jp, mix, blk)
        for k, v in out_ref.items():
            _assert_close(np.asarray(out[k]), np.asarray(v), k, f"block {b}")
    _assert_state_close(mix, ref)
