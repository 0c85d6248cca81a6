"""Golden CW and PSK31 decodes through the port against the INDEPENDENT
generators `tests/fixtures/cw_gen.py` and `tests/fixtures/psk31_gen.py`,
on the CPU: the mirror of tests/test_golden_cw_psk31.py, with the same
texts and bounds, through `t41x_torch`'s `RxChain(device="cpu")`,
`cw_text` and `psk31`.

The port's own CW/PSK31 tests synthesize with its own encoders (copies of
t41x's), so a drift shared by encoder and decoder would cancel; these
signals share nothing with either package."""

import numpy as np
import torch

from t41x_torch import constants as C
from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.decode import cw_text, psk31
from tests.fixtures import cw_gen, psk31_gen

torch.set_num_threads(1)


def _cw_decode(iq: np.ndarray) -> str:
    chain = RxChain(ChainSpec(mode="cw", f_lo=200.0, f_hi=3000.0,
                              interpolate_out=False, agc_mode=0),
                    device="cpu")
    n = (len(iq) // C.BLOCK_SIZE) * C.BLOCK_SIZE
    out = chain.run(np.asarray(iq[:n]))
    return cw_text.decode_envelope(out["cw_keyed"].numpy().astype(bool))


def test_cw_decodes_independent_clean_keying():
    text = "CQ TEST W1AW"
    iq = cw_gen.synth_iq(text, wpm=18.0) * 1.0
    got = _cw_decode(iq)
    assert got.replace(" ", "") == text.replace(" ", ""), got


def test_cw_decodes_independent_jittered_fist():
    """8% per-element timing jitter, a human fist; the decoder's adaptive
    histograms (reference `DoSignalHistogram`, `CWProcessing.cpp:759`)
    must absorb it."""
    text = "VVV VVV CQ DE N0T41"
    iq = cw_gen.synth_iq(text, wpm=15.0, jitter=0.08, seed=5)
    got = _cw_decode(iq).replace(" ", "")
    assert got.endswith("CQDEN0T41"), got


def test_psk31_decodes_independent_signal():
    text = "CQ DE T41X"
    iq = psk31_gen.synth_iq(text, tone_hz=1000.0)
    n = (len(iq) // C.BLOCK_SIZE) * C.BLOCK_SIZE
    chain = RxChain(ChainSpec(mode="psk31", interpolate_out=False),
                    device="cpu")
    out = chain.run(np.asarray(iq[:n]))
    got = psk31.decode_capture(out["iq_baseband"].numpy(), tone_hz=1000.0,
                               device="cpu")
    assert text in got, got


def test_psk31_independent_bitstreams_match_port():
    """Same text through both varicode transcriptions must produce the
    same bit stream (catches a drift in either table)."""
    text = "Hello, PSK31? 73!"
    mine = psk31_gen.bitstream(text, idle=32)
    port_bits = psk31.encode_psk31(text)
    np.testing.assert_array_equal(np.asarray(mine), np.asarray(port_bits))
