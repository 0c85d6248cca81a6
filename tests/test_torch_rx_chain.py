"""The slice end to end: t41x_torch's RxChain vs t41x's on the same
numpy-seeded capture, for the bench rx spec (zoom-x1 panadapter +
audio-spectrum taps + x8 interpolation), the `__graft_entry__.entry()`
spec (no display taps: the OS-filter kernel) and q15 ingest with clip
taps; kernels (plain versions on the CPU) against t41x's Pallas path in
interpret mode, and plain against plain.  Tolerances are those of
tests/test_frontend_fused.py; the North-star bounds (audio >= 55 dB,
displayed spectrum <= 0.5 dB) are asserted with the formulas
chip_smoke.py uses."""

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
    "rx": dict(mode="usb", spectrum_zoom=0),
    "entry": dict(mode="usb", spectrum_taps=False),
    "q15_clip": dict(mode="usb", spectrum_zoom=0, q15_input=True,
                     clip_taps=True),
}
EXACT = ("adc_half_clip", "adc_quarter_clip")


def _params(ch):
    p = jparams((ch,))
    return p._replace(
        nco_freq=np.linspace(-500.0, 700.0, ch).astype(np.float32),
        rf_gain_db=np.linspace(-3.0, 6.0, ch).astype(np.float32),
        iq_amp=np.linspace(0.97, 1.03, ch).astype(np.float32),
        iq_phase=np.linspace(-0.02, 0.02, ch).astype(np.float32))


def _iq(ch, blocks, seed=11):
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * C.BLOCK_SIZE) / C.SAMPLE_RATE
    tone = 0.3 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + 1500.0) * t)
    noise = (rng.standard_normal((ch, t.size))
             + 1j * rng.standard_normal((ch, t.size))) * 0.05
    # a few samples near full scale so the clip taps see both answers
    noise[::2, 100] = 0.7
    return (tone + noise).astype(np.complex64)


def _blocks(iq, q15):
    for b in range(iq.shape[-1] // C.BLOCK_SIZE):
        x = iq[:, b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
        if q15:
            yield tuple(np.clip(np.round(a * 32768.0), -32768,
                                32767).astype(np.int16)
                        for a in (x.real, x.imag))
        else:
            yield np.ascontiguousarray(x)


def _torch_blk(blk):
    return (tuple(map(torch.from_numpy, blk)) if isinstance(blk, tuple)
            else torch.from_numpy(blk))


def _assert_state_close(sa, sb, rtol=2e-3, atol=5e-4):
    fa, fb = jax.tree.leaves(sa), jax.tree.leaves(sb)
    assert len(fa) == len(fb)
    for a, b in zip(fa, fb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=max(atol, 1e-3 * scale))


def _assert_outputs_close(to, jo):
    assert set(to) == set(jo)
    for k, v in jo.items():
        got, ref = to[k].numpy(), np.asarray(v)
        if k in EXACT:
            np.testing.assert_array_equal(got, ref, err_msg=k)
        elif k == "rf_spectrum":
            np.testing.assert_allclose(got, ref, rtol=2e-4,
                                       atol=2e-3 * float(np.max(ref)),
                                       err_msg=k)
            assert parity.spectrum_err_db(ref, got) \
                <= parity.SPECTRUM_ERR_MAX_DB, k
        else:
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5,
                                       err_msg=k)
            if k.startswith("audio") and k != "audio_spectrum":
                assert parity.snr_db(ref, got) >= parity.AUDIO_SNR_MIN_DB, k


@pytest.mark.parametrize("ch,blocks", [(8, 3), (5, 2)])
@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_port_chain_matches_t41x(spec, kernels, ch, blocks):
    kw = SPECS[spec]
    jc = JChain(JSpec(use_pallas=kernels, **kw))
    tc = RxChain(ChainSpec(use_kernels=kernels, **kw), device="cpu")
    assert (tc.fused_fe is not None) == kernels
    jp = _params(ch)
    tp = convert.params_from_numpy(jp, device="cpu")
    step = jax.jit(jc.block)
    js, ts = jc.init_state((ch,)), tc.init_state((ch,))
    for blk in _blocks(_iq(ch, blocks), kw.get("q15_input", False)):
        js, jo = step(jp, js, blk)
        ts, to = tc.block(tp, ts, _torch_blk(blk))
        _assert_outputs_close(to, jo)
    _assert_state_close(convert.state_to_numpy(ts), js)


def test_state_moves_between_t41x_and_port_mid_stream():
    """2 blocks in t41x, 1 in the port, then t41x again: the carried
    state crosses both ways and the stream matches t41x throughout."""
    ch, blocks = 4, 4
    kw = SPECS["rx"]
    jc = JChain(JSpec(use_pallas=True, **kw))
    tc = RxChain(ChainSpec(use_kernels=True, **kw), device="cpu")
    jp = _params(ch)
    tp = convert.params_from_numpy(jp, device="cpu")
    step = jax.jit(jc.block)
    ref, mix = jc.init_state((ch,)), jc.init_state((ch,))
    for b, blk in enumerate(_blocks(_iq(ch, blocks, seed=5), False)):
        ref, out_ref = step(jp, ref, blk)
        if b == 2:
            st = convert.state_from_numpy(jax.tree.map(np.asarray, mix),
                                          device="cpu")
            st, out = tc.block(tp, st, _torch_blk(blk))
            mix = convert.state_to_numpy(st)
            out = {k: v.numpy() for k, v in out.items()}
        else:
            mix, out = step(jp, mix, blk)
        for k in ("audio", "audio_24k", "rf_spectrum"):
            r = np.asarray(out_ref[k])
            np.testing.assert_allclose(
                np.asarray(out[k]), r, rtol=2e-4,
                atol=2e-3 * float(np.max(r)) if k == "rf_spectrum" else 2e-5,
                err_msg=f"block {b} {k}")
    _assert_state_close(mix, ref)


def test_run_streams_a_capture():
    ch, blocks = 3, 2
    tc = RxChain(ChainSpec(use_kernels=False, **SPECS["rx"]), device="cpu")
    out = tc.run(_iq(ch, blocks))
    assert out["audio"].shape == (ch, blocks * C.BLOCK_SIZE)
    assert out["audio_24k"].shape == (ch, blocks * C.AUDIO_BLOCK)
    assert out["rf_spectrum"].shape == (ch, blocks * C.SPECTRUM_RES)
    assert out["smeter_avg"].shape == (ch, blocks)
    ref = JChain(JSpec(**SPECS["rx"])).run(_iq(ch, blocks))
    for k in ("audio", "audio_24k"):
        assert parity.snr_db(ref[k], out[k]) >= parity.AUDIO_SNR_MIN_DB
