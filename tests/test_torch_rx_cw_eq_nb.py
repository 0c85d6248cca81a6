"""The port's receive chain with the audio stages of its third slice
against t41x's: mode cw with the narrow CW filter and the detector, the
14-band receive EQ and the noise blanker; kernels (plain versions on the
CPU) against t41x's Pallas path in interpret mode, and plain against
plain.  tests/test_torch_rx_zoom.py holds the zoom 2^z panadapter.

Outputs are held at the tolerances of tests/test_torch_rx_chain.py
(rf_spectrum rtol 2e-4 / atol 2e-3 of its peak, the rest rtol 2e-4 /
atol 2e-5), the audio at >= 55 dB and the displayed spectrum within
0.5 dB; `cw_keyed` is equal.  The carried state crosses between the
packages mid-stream, and `block_batch` equals B calls of `block`.
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
    "cw": dict(mode="cw", cw_filter_index=2),
    "eq": dict(mode="usb", eq_on=True),
    "nb": dict(mode="usb", nb_on=True),
}
EXACT = ("cw_keyed",)


def _params(ch, eq=False, tuned=False):
    """Spread fine tune, gain and IQ correction, or with `tuned` every
    channel tuned to the carrier (the cw stimulus)."""
    p = jparams((ch,))
    if not tuned:
        p = p._replace(
            nco_freq=np.linspace(-500.0, 700.0, ch).astype(np.float32),
            rf_gain_db=np.linspace(-3.0, 6.0, ch).astype(np.float32),
            iq_amp=np.linspace(0.97, 1.03, ch).astype(np.float32),
            iq_phase=np.linspace(-0.02, 0.02, ch).astype(np.float32))
    if eq:  # per-channel EQ gains that are not all 1
        g = np.random.default_rng(4).random((ch, 14)).astype(np.float32)
        p = p._replace(eq_gains=g)
    return p


def _iq(spec, ch, blocks, seed=11):
    """The chain tests' tone at Fs/4 + 1500 Hz in noise; for cw a 750 Hz
    keyed carrier, on and off every 2 blocks; for nb tone plus impulses in
    noise."""
    rng = np.random.default_rng(seed)
    n = blocks * C.BLOCK_SIZE
    t = np.arange(n) / C.SAMPLE_RATE
    noise = (rng.standard_normal((ch, n))
             + 1j * rng.standard_normal((ch, n))) * 0.05
    if spec == "cw":
        key = (np.arange(n) // (2 * C.BLOCK_SIZE)) % 2 == 0
        # the sidetone's carrier, 750 Hz above the Fs/4-shifted tuning
        sig = 0.3 * key * np.exp(2j * np.pi * (-C.SAMPLE_RATE / 4 + 750.0)
                                 * t)
        noise *= 0.2
    else:
        sig = 0.3 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + 1500.0) * t)
    if spec == "nb":
        noise[:, 700::2900] += 4.0  # impulses, off the block grid
    return (sig + noise).astype(np.complex64)


def _blocks(iq):
    return [np.ascontiguousarray(iq[:, b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE])
            for b in range(iq.shape[-1] // C.BLOCK_SIZE)]


def _assert_close(got, ref, k, msg=""):
    if k in EXACT:
        np.testing.assert_array_equal(got, ref, err_msg=f"{msg} {k}")
    elif k == "rf_spectrum":
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


def _pair(kw, kernels):
    return (JChain(JSpec(use_pallas=kernels, **kw)),
            RxChain(ChainSpec(use_kernels=kernels, **kw), device="cpu"))


@pytest.mark.parametrize("kernels", [True, False])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_cw_eq_nb_specs_match_t41x(spec, kernels):
    ch, blocks = 3, 4 if spec == "cw" else 2
    kw = SPECS[spec]
    jc, tc = _pair(kw, kernels)
    assert (tc.fused_fe is not None) == kernels
    jp = _params(ch, eq=spec == "eq", tuned=spec == "cw")
    tp = convert.params_from_numpy(jp, device="cpu")
    step = jax.jit(jc.block)
    js, ts = jc.init_state((ch,)), tc.init_state((ch,))
    keyed = []
    for b, blk in enumerate(_blocks(_iq(spec, ch, blocks))):
        js, jo = step(jp, js, blk)
        ts, to = tc.block(tp, ts, torch.from_numpy(blk))
        assert set(to) == set(jo)
        for k, v in jo.items():
            got, ref = to[k].numpy(), np.asarray(v)
            assert got.shape == ref.shape and got.dtype == ref.dtype, k
            _assert_close(got, ref, k, f"block {b}")
        if spec == "cw":
            np.testing.assert_allclose(to["cw_combined"].numpy(),
                                       np.asarray(jo["cw_combined"]),
                                       rtol=1e-4)
            keyed.append(to["cw_keyed"].numpy())
    if spec == "cw":  # the keyed carrier is seen on, then off (one block
        keyed = np.asarray(keyed)  # late: the AGC and filter delays)
        assert keyed[1].all() and not keyed[3].any(), keyed
    _assert_state_close(convert.state_to_numpy(ts), js)


def test_cw_chain_decodes_like_t41x():
    """A Morse message through both chains: the port's keyed envelope
    equals t41x's and decodes to t41x's text (tests/test_cw.py)."""
    from t41x.decode import cw_text
    from t41x.io import signals

    text = "CQ TEST"
    n_blocks = 440  # the full message at 18 wpm
    iq = signals.cw_signal(text, 18.0, n_blocks * C.BLOCK_SIZE,
                           tone_offset=750.0) * 0.5
    kw = dict(mode="cw", f_lo=200.0, f_hi=3000.0, interpolate_out=False,
              agc_mode=0)
    ref = JChain(JSpec(**kw)).run(np.asarray(iq))
    out = RxChain(ChainSpec(use_kernels=False, **kw),
                  device="cpu").run(np.asarray(iq))
    keyed = out["cw_keyed"].numpy().astype(bool)
    np.testing.assert_array_equal(keyed, np.asarray(ref["cw_keyed"]))
    want = cw_text.decode_envelope(np.asarray(ref["cw_keyed"]).astype(bool))
    got = cw_text.decode_envelope(keyed)
    assert got == want and got.replace(" ", "") == text.replace(" ", "")


def test_state_moves_between_t41x_and_port_mid_stream():
    """2 blocks in t41x, 1 in the port, then t41x again: the CW detector,
    CW filter and EQ states cross both ways, and the stream matches
    t41x's throughout."""
    ch = 3
    kw = dict(mode="cw", cw_filter_index=1, eq_on=True)
    jc, tc = _pair(kw, True)
    jp = _params(ch, eq=True, tuned=True)
    tp = convert.params_from_numpy(jp, device="cpu")
    step = jax.jit(jc.block)
    ref, mix = jc.init_state((ch,)), jc.init_state((ch,))
    for b, blk in enumerate(_blocks(_iq("cw", ch, 4, seed=5))):
        ref, out_ref = step(jp, ref, blk)
        if b == 2:
            st = convert.state_from_numpy(jax.tree.map(np.asarray, mix),
                                          device="cpu")
            assert type(st.cw).__module__ == "t41x_torch.demod.cw"
            st, out = tc.block(tp, st, torch.from_numpy(blk))
            mix = convert.state_to_numpy(st)
            out = {k: v.numpy() for k, v in out.items()}
        else:
            mix, out = step(jp, mix, blk)
        for k, v in out_ref.items():
            _assert_close(np.asarray(out[k]), np.asarray(v), k, f"block {b}")
    _assert_state_close(mix, ref)


def test_block_batch_matches_block_for_zoom_cw_eq():
    """`block_batch` equals B calls of `block` with the new stages on,
    and t41x's block_batch."""
    ch, B = 3, 3
    kw = dict(mode="cw", cw_filter_index=0, eq_on=True, nb_on=True,
              spectrum_zoom=2)
    jc, tc = _pair(kw, False)
    blocks = np.stack(_blocks(_iq("cw", ch, B, seed=9)))
    jp = _params(ch, eq=True, tuned=True)
    tp = convert.params_from_numpy(jp, device="cpu")
    st_b, out_b = tc.block_batch(tp, tc.init_state((ch,)),
                                 torch.from_numpy(blocks))
    st = tc.init_state((ch,))
    for b in range(B):
        st, out = tc.block(tp, st, torch.from_numpy(blocks[b]))
        for k, v in out.items():
            np.testing.assert_array_equal(out_b[k][b].numpy(), v.numpy(), k)
    _, jo = jax.jit(jc.block_batch)(jp, jc.init_state((ch,)), blocks)
    for k in ("audio", "audio_24k", "rf_spectrum", "cw_keyed"):
        _assert_close(out_b[k].numpy(), np.asarray(jo[k]), k)
