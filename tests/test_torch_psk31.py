"""The port's PSK31 decoder against t41x's on the CPU.

`symbol_phases` (T7: float32 time axis and mixing phase, as t41x's)
within 1e-4 rad wherever the integrator's magnitude exceeds 1e-3 of its
largest (the angle of a near-zero sum is noise), magnitudes within 1e-5
of the largest; the decoded text equal at baseband and through the
receive chain; `Radio.decode_psk31`; and `python -m t41x_torch.cli psk31
--device cpu` against `t41x.cli psk31`.  The varicode tables and the
host decoder are copies of t41x's (`tests/test_torch_host_copies.py`).
"""

import contextlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x import cli as j_cli
from t41x import constants as C
from t41x.decode import psk31 as jp
from t41x.radio import Radio as JRadio
from t41x_torch.decode import psk31 as tp
from t41x_torch.io import wav as t_wav
from t41x_torch.radio import Radio

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASE_TOL = 1e-4


@pytest.mark.parametrize("tone", [0.0, 1000.0, 1234.5])
@pytest.mark.parametrize("seconds", [2.0, 60.0])
def test_symbol_phases(tone, seconds):
    rng = np.random.default_rng(int(tone) + int(seconds))
    n = int(seconds * C.AUDIO_RATE)
    z = (rng.standard_normal((2, n)) + 1j * rng.standard_normal((2, n))
         ).astype(np.complex64)
    pj, mj = (np.asarray(a) for a in jp.symbol_phases(jnp.asarray(z), tone))
    pt, mt = tp.symbol_phases(torch.from_numpy(z), tone)
    assert pt.dtype == mt.dtype == torch.float32
    pt, mt = pt.numpy(), mt.numpy()
    assert pt.shape == pj.shape == (2, n // 48)
    big = mj > 1e-3 * mj.max()
    d = np.angle(np.exp(1j * (pt - pj)))[big]
    assert np.abs(d).max() <= PHASE_TOL
    assert np.abs(mt - mj).max() <= 1e-5 * mj.max()


@pytest.mark.parametrize("text", ["CQ DE T41", "HELLO, WORLD! 123"])
def test_baseband_decode(text):
    iq = jp.synth_psk31(text, tone_hz=0.0, rate=C.AUDIO_RATE,
                        nco=C.AUDIO_RATE / 4.0)
    np.testing.assert_array_equal(
        tp.synth_psk31(text, tone_hz=0.0, rate=C.AUDIO_RATE,
                       nco=C.AUDIO_RATE / 4.0), iq)
    np.testing.assert_array_equal(tp.encode_psk31(text),
                                  jp.encode_psk31(text))
    want = jp.decode_capture(iq, tone_hz=0.0)
    assert want == text
    assert tp.decode_capture(iq, tone_hz=0.0, device="cpu") == want


def _capture(text="CQ CQ DE T41", tone=1000.0):
    iq = jp.synth_psk31(text, tone_hz=tone)
    return iq[: len(iq) // C.BLOCK_SIZE * C.BLOCK_SIZE]


def test_radio_decode_psk31():
    iq = _capture()
    j, t = JRadio(), Radio(device="cpu")
    want = j.decode_psk31(iq, tone_hz=1000.0)
    assert "CQ CQ DE T41" in want
    assert t.decode_psk31(iq, tone_hz=1000.0) == want
    assert t.config.to_dict() == j.config.to_dict()


def test_cli_psk31_matches_t41x(tmp_path):
    cap = str(tmp_path / "cap.wav")
    t_wav.write_iq_wav(cap, _capture("TEST DE K1ABC", 1200.0), 192_000)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_cli.main(["psk31", "--in", cap, "--tone", "1200"]) == 0
    res = subprocess.run(
        [sys.executable, "-m", "t41x_torch.cli", "psk31", "--device", "cpu",
         "--in", cap, "--tone", "1200"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "TEST DE K1ABC" in out.getvalue()
    assert res.stdout == out.getvalue()
