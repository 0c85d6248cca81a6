"""FT8 weak-signal sensitivity and impairment envelope through the port,
on the CPU: the mirror of tests/test_ft8_weak.py, with the same trials
and bounds, its slots made by `t41x_torch.tools.ft8_sensitivity`'s
`make_slot` (seed 0) and decoded by the port's `decode_audio`.

  * clean decodes at -18 dB SNR (2.5 kHz convention), the WSJT-X BP-only
    threshold;
  * decodes survive +-2 Hz/slot drift, +-20 ppm sample-rate offset and
    fading at moderate SNR;
  * per-decode calibrated SNR and grid distance are reported.

`make_slot` itself equals the JAX test's to within 1e-6 under every
condition."""

import numpy as np
import pytest
import torch

from t41x_torch.decode import locator
from t41x_torch.decode.ft8 import decode as ft8_decode
from t41x_torch.tools.ft8_sensitivity import make_slot as port_make_slot
from tests.test_ft8_weak import make_slot as t41x_make_slot

torch.set_num_threads(1)


def make_slot(snr_db: float, cond: str, trial: int):
    return port_make_slot(snr_db, cond, trial, seed=0)


def _decode(slot, **kw):
    return ft8_decode.decode_audio(slot, device="cpu", **kw)


@pytest.mark.parametrize("cond", ["clean", "drift", "sro", "fading"])
def test_make_slot_equals_t41x_tests(cond):
    for snr, trial in ((-18.0, 0), (-16.0, 1), (-10.0, 8)):
        got, msg = make_slot(snr, cond, trial)
        ref, ref_msg = t41x_make_slot(snr, cond, trial)
        assert msg == ref_msg
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_clean_decodes_at_minus_18_db():
    """-18 dB is the 50% point of the measured curve (FT8_SENS.json);
    these three trials are deterministic decoding points of it."""
    for trial in (0, 1, 8):
        slot, msg = make_slot(-18.0, "clean", trial)
        got = _decode(slot)
        match = [d for d in got if d.text == msg]
        assert match, (trial, [d.text for d in got])
        # calibrated SNR estimate lands near the true -18 dB
        assert -22.0 <= match[0].snr_db <= -14.0, match[0].snr_db


def test_impairment_envelope_points():
    """One deterministic decode under each off-air impairment:
    +-2 Hz/slot drift and +-20 ppm SRO at -16 dB, 0.2 Hz-Doppler fading
    at -10 dB."""
    for cond, snr in (("drift", -16.0), ("sro", -16.0),
                      ("fading", -10.0)):
        slot, msg = make_slot(snr, cond, 0)
        got = _decode(slot)
        assert any(d.text == msg for d in got), \
            (cond, snr, [d.text for d in got])


def test_decode_reports_snr_and_distance():
    """Per-decode SNR and great-circle distance to the message grid."""
    slot, msg = make_slot(-10.0, "clean", 0)   # "CQ K1ABC FN42"
    got = _decode(slot, my_grid="EM77tr")
    match = [d for d in got if d.text == msg]
    assert match
    d = match[0]
    grid = ft8_decode.grid_of_message(msg)
    assert grid == "FN42"
    expect = locator.distance_km("EM77tr", grid)
    assert d.distance_km is not None
    assert abs(d.distance_km - expect) <= 1.0, (d.distance_km, expect)
    assert -13.0 <= d.snr_db <= -7.0, d.snr_db

    # no grid in the message -> no distance
    assert ft8_decode.grid_of_message("W9XYZ K1ABC R-08") is None
    assert ft8_decode.grid_of_message("K1ABC W9XYZ RR73") is None
