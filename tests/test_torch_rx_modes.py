"""The port's receive chain in the modes and options of its second slice
against t41x's: AM, SAM, NFM (with and without display taps), the three
NR modes, the automatic notch, and the ft8/psk31 chain modes; kernels
(plain versions on the CPU) against t41x's Pallas path in interpret
mode, and plain against plain.

Waveform specs hold every output at rtol 2e-4 / atol 2e-5 and the audio
at >= 55 dB.  The adaptive specs (SAM PLL, LMS NR, notch) are held in
steady state by tests/test_torch_rx_adaptive.py.  The carried state
also crosses between the packages mid-stream.
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

SAM_BAND = dict(f_lo=-3000.0, f_hi=3000.0)
WAVEFORM = {
    "am": dict(mode="am"),
    "nfm": dict(mode="nfm"),
    "nfm_headless": dict(mode="nfm", spectrum_taps=False),
    "nr_kim": dict(mode="usb", nr_mode=1),
    "nr_spectral": dict(mode="usb", nr_mode=2),
    "ft8": dict(mode="ft8"),
    "psk31": dict(mode="psk31"),
}
ADAPTIVE = {
    "sam": dict(mode="sam", **SAM_BAND),
    "nr_lms": dict(mode="usb", nr_mode=3),
    "notch": dict(mode="usb", notch_on=True),
}


def _iq(ch, blocks, am, seed=7):
    """tools/chipcheck.py's stimuli: an AM carrier near baseband (so the
    PLL locks), else a tone at Fs/4 + 1500 Hz, in noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * C.BLOCK_SIZE) / C.SAMPLE_RATE
    if am:
        env = 1.0 + 0.3 * np.cos(2 * np.pi * 400.0 * t)
        sig = 0.4 * env * np.exp(2j * np.pi * (-C.SAMPLE_RATE / 4 + 30.0) * t)
        noise = 0.01
    else:
        sig = 0.3 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + 1500.0) * t)
        noise = 0.05
    iq = sig + (rng.standard_normal((ch, t.size))
                + 1j * rng.standard_normal((ch, t.size))) * noise
    return np.split(iq.astype(np.complex64), blocks, axis=-1)


def _pair(kw, kernels):
    return (JChain(JSpec(use_pallas=kernels, **kw)),
            RxChain(ChainSpec(use_kernels=kernels, **kw), device="cpu"))


def _stream(jc, tc, blocks, ch):
    """Both chains over the same blocks; per-block outputs as numpy."""
    jp = jparams((ch,))
    tp = convert.params_from_numpy(jp, device="cpu")
    step = jax.jit(jc.block)
    js, ts = jc.init_state((ch,)), tc.init_state((ch,))
    jo, to = [], []
    for blk in blocks:
        js, o = step(jp, js, blk)
        jo.append({k: np.asarray(v) for k, v in o.items()})
        ts, o = tc.block(tp, ts, torch.from_numpy(np.ascontiguousarray(blk)))
        to.append({k: v.numpy() for k, v in o.items()})
    return js, ts, jo, to


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("spec", sorted(WAVEFORM))
def test_waveform_modes_match_t41x(spec, kernels):
    ch = 4
    kw = WAVEFORM[spec]
    jc, tc = _pair(kw, kernels)
    blocks = _iq(ch, 3, am=spec == "am")
    js, ts, jo, to = _stream(jc, tc, blocks, ch)
    for b, (j, t) in enumerate(zip(jo, to)):
        assert set(t) == set(j), b
        for k, ref in j.items():
            got = t[k]
            assert got.shape == ref.shape and got.dtype == ref.dtype, k
            if k == "audio_spectrum":
                assert parity.spectrum_err_db(ref, got) \
                    <= parity.SPECTRUM_ERR_MAX_DB, k
                continue
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5,
                                       err_msg=f"block {b} {k}")
            if k.startswith("audio"):
                assert parity.snr_db(ref, got) >= parity.AUDIO_SNR_MIN_DB, k
    if spec == "psk31":
        assert "iq_baseband" in to[0]
    for a, b in zip(jax.tree.leaves(convert.state_to_numpy(ts)),
                    jax.tree.leaves(js)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(
            a, b, rtol=2e-3, atol=max(5e-4, 1e-3 * float(np.abs(b).max())))


@pytest.mark.parametrize("kw", [ADAPTIVE["sam"], WAVEFORM["nr_kim"],
                                ADAPTIVE["nr_lms"]],
                         ids=["sam", "nr_kim", "nr_lms"])
def test_state_moves_between_t41x_and_port_mid_stream(kw):
    """2 blocks in t41x, 1 in the port, then t41x again: the SAM, Kim and
    LMS states cross both ways as the port's NamedTuples, and the stream
    matches t41x's throughout."""
    ch = 3
    jc, tc = _pair(kw, True)
    jp = jparams((ch,))
    tp = convert.params_from_numpy(jp, device="cpu")
    step = jax.jit(jc.block)
    ref, mix = jc.init_state((ch,)), jc.init_state((ch,))
    for b, blk in enumerate(_iq(ch, 4, am=kw["mode"] == "sam", seed=5)):
        ref, out_ref = step(jp, ref, blk)
        if b == 2:
            st = convert.state_from_numpy(jax.tree.map(np.asarray, mix),
                                          device="cpu")
            assert type(st.sam).__module__ == "t41x_torch.demod.sam"
            if kw.get("nr_mode"):
                assert type(st.nr).__module__ == "t41x_torch.dsp.nr"
            st, out = tc.block(tp, st, torch.from_numpy(blk))
            mix = convert.state_to_numpy(st)
            out = {k: v.numpy() for k, v in out.items()}
        else:
            mix, out = step(jp, mix, blk)
        for k in ("audio", "audio_24k"):
            np.testing.assert_allclose(np.asarray(out[k]),
                                       np.asarray(out_ref[k]), rtol=2e-4,
                                       atol=2e-5, err_msg=f"block {b} {k}")


@pytest.mark.parametrize("spec", ["nr_spectral", "nr_kim"])
def test_block_batch_matches_block_and_t41x(spec):
    """`block_batch` (spectral NR batched across blocks, every other spec
    a loop of `block`) equals B calls of `block`, and t41x's
    block_batch."""
    ch, B = 3, 3
    kw = WAVEFORM[spec]
    jc, tc = _pair(kw, False)
    blocks = np.stack(_iq(ch, B, am=False, seed=9))
    tp = convert.params_from_numpy(jparams((ch,)), device="cpu")
    st_b, out_b = tc.block_batch(tp, tc.init_state((ch,)),
                                 torch.from_numpy(blocks))
    st = tc.init_state((ch,))
    for b in range(B):
        st, out = tc.block(tp, st, torch.from_numpy(blocks[b]))
        for k, v in out.items():
            np.testing.assert_allclose(out_b[k][b].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    _, jo = jax.jit(jc.block_batch)(jparams((ch,)), jc.init_state((ch,)),
                                    blocks)
    for k in ("audio", "audio_24k"):
        np.testing.assert_allclose(out_b[k].numpy(), np.asarray(jo[k]),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


def test_psd_err_db_sees_a_changed_spectrum():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 2, 256))
    assert parity.psd_err_db(a, a) == 0.0
    assert parity.psd_err_db(a, a * 1.5) > parity.PSD_ERR_MAX_DB
