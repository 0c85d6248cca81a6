"""t41x_torch.radio.Radio against t41x.radio.Radio on the CPU.

One sequence of control calls (band, mode, filter, fine tune with
recentring, VFO, EQ, favourites, auto RF gain, ...) leaves both configs
equal after every call; the chain specs are equal field for field (with
`use_kernels` where t41x has `use_pallas`, both off on the CPU) and the
per-channel parameters equal in value.  `receive` on a 6-block capture
at 3 channels holds the North-star bounds (audio >= 55 dB SNR, displayed
spectrum <= 0.5 dB); `decode_cw` reads the same text.  The decoder and
transmit entry points, which raised until their slice came, answer as
t41x's on the same input (tests/test_torch_{tx,ft8_radio,psk31}.py hold
them on real signals).
"""

import ast
import dataclasses
import inspect
import textwrap

import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.io import signals
from t41x import radio as j_radio
from t41x.radio import Radio as JRadio
from t41x_torch import radio as t_radio
from t41x_torch.radio import Radio
from t41x_torch.utils import parity

torch.set_num_threads(1)

CONTROLS = [
    ("set_band", "40M"), ("set_mode", "usb"), ("set_filter", 300, 2700),
    ("set_fine_tune", 1200.0), ("set_zoom", 3), ("set_fine_tune", 11_000.0),
    ("set_zoom", 0), ("set_fine_tune", 150_000.0), ("set_fine_tune", -900.0),
    ("toggle_vfo",), ("set_split", True), ("set_volume", 130),
    ("set_agc", 4), ("set_nr", 1), ("change_freq_increment", 3),
    ("change_ft_increment", -1), ("set_noise_floor", 12),
    ("set_eq", "rx", True), ("set_eq_band", "rx", 4, 35),
    ("set_eq_band", "tx", 13, 140), ("set_mic_gain", -60),
    ("set_mic_compression", 2.5), ("save_favorite", 2), ("set_band", 4),
    ("recall_favorite", 2), ("set_transmit_power", 33.0),
    ("set_auto_rf_gain", True), ("set_band", "20M"), ("set_mode", "am"),
    ("set_mode", "lsb"), ("toggle_vfo",),
]


def _method_code(cls, name):
    src = textwrap.dedent(inspect.getsource(getattr(cls, name)))
    return ast.dump(ast.parse(src)).replace("t41x_torch", "t41x")


def test_control_surface_is_t41x_line_for_line():
    """Every control method of the port's Radio is t41x's, the config
    imports read as t41x's."""
    names = [n for n, v in vars(j_radio.Radio).items()
             if inspect.isfunction(v) and (n.startswith(("set_", "change_"))
                                           or n in ("toggle_vfo",
                                                    "save_favorite",
                                                    "recall_favorite"))]
    assert len(names) == 21
    for name in names:
        assert _method_code(t_radio.Radio, name) == \
            _method_code(j_radio.Radio, name), name


def test_control_sequence_gives_equal_configs():
    j, t = JRadio(), Radio(device="cpu")
    assert t.config.to_dict() == j.config.to_dict()
    for name, *args in CONTROLS:
        assert getattr(t, name)(*args) == getattr(j, name)(*args), name
        assert t.config.to_dict() == j.config.to_dict(), name
    for bad in (("set_eq", "xx", True), ("set_eq_band", "rx", 14, 1),
                ("save_favorite", 13), ("recall_favorite", 5)):
        for r in (t, j):
            with pytest.raises(ValueError):
                getattr(r, bad[0])(*bad[1:])


@pytest.mark.parametrize("steps", [2, 12, len(CONTROLS)])
def test_chain_spec_and_params_equal(steps):
    j, t = JRadio(), Radio(device="cpu")
    for name, *args in CONTROLS[:steps]:
        getattr(t, name)(*args)
        getattr(j, name)(*args)
    js, ts = dataclasses.asdict(j.chain.spec), dataclasses.asdict(
        t.chain.spec)
    assert ts.pop("use_kernels") is js.pop("use_pallas") is False
    assert ts == js
    assert t.chain.device.type == "cpu"
    for ch in ((), (3,), (2, 2)):
        tp, jp = t.params(ch), j.params(ch)
        assert tp._fields == jp._fields
        for f, a, b in zip(tp._fields, tp, jp):
            b = np.asarray(b)
            assert a.device.type == "cpu" and a.dtype == torch.float32, f
            assert tuple(a.shape) == b.shape, f
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)


def _capture(ch=3, blocks=6, seed=21):
    rng = np.random.default_rng(seed)
    n = blocks * C.BLOCK_SIZE
    sig = signals.usb_signal([700.0, 1800.0], n, amps=[0.2, 0.1])
    noise = 0.02 * (rng.standard_normal((ch, n))
                    + 1j * rng.standard_normal((ch, n)))
    return (sig[None] * np.linspace(0.5, 1.5, ch)[:, None]
            + noise).astype(np.complex64)


def test_receive_holds_the_north_star_bounds():
    iq = _capture()
    j, t = JRadio(), Radio(device="cpu")
    for r in (j, t):
        r.set_fine_tune(250.0)
        r.set_volume(70)
    want, got = j.receive(iq), t.receive(iq)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert isinstance(got[k], np.ndarray)
    for k in ("audio", "audio_24k"):
        assert parity.snr_db(want[k], got[k]) >= parity.AUDIO_SNR_MIN_DB, k
    assert parity.spectrum_err_db(want["rf_spectrum"], got["rf_spectrum"]) \
        <= parity.SPECTRUM_ERR_MAX_DB
    assert parity.spectrum_err_db(want["audio_spectrum"],
                                  got["audio_spectrum"]) \
        <= parity.SPECTRUM_ERR_MAX_DB
    assert t.metrics.keys() == j.metrics.keys()
    assert t.metrics["input_samples"] == iq.size
    assert t.metrics["mode"] == "usb"


def test_decode_cw_reads_the_same_text():
    # AGC off: the plain AGC recurrence runs sample by sample on the CPU
    n = int(3.0 * C.SAMPLE_RATE) // C.BLOCK_SIZE * C.BLOCK_SIZE
    iq = (signals.cw_signal("TEST", 18.0, n) * 0.3
          + signals.awgn(n, 0.003, seed=5)).astype(np.complex64)
    j, t = JRadio(), Radio(device="cpu")
    for r in (j, t):
        r.set_agc(0)
    want = j.decode_cw(iq)
    assert want == "TEST"
    assert t.decode_cw(iq) == want
    assert t.config.to_dict() == j.config.to_dict()


@pytest.mark.parametrize("call", [
    ("decode_ft8", np.zeros(2048, np.complex64)),
    ("decode_psk31", np.zeros(2048, np.complex64)),
    ("transmit_ssb", np.zeros(2048, np.float32)),
    ("transmit_cw", "CQ"), ("transmit_ft8", "CQ K1ABC FN42")])
def test_missing_slices_raise(call):
    """The entry points the decoder and TX slice brought: t41x's answer
    on the same input (one block is too short for FT8's candidate pool,
    and both raise ValueError)."""
    j, t = JRadio(), Radio(device="cpu")
    name, arg = call
    if name == "decode_ft8":
        for r in (j, t):
            with pytest.raises(ValueError, match="k"):
                r.decode_ft8(arg)
    else:
        want, got = getattr(j, name)(arg), getattr(t, name)(arg)
        assert type(got) is type(want)
        if name == "transmit_ssb":
            assert got.dtype == want.dtype and got.shape == want.shape
            np.testing.assert_allclose(got, want, atol=1e-6)
        elif isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert parity.snr_db(want, got) >= parity.AUDIO_SNR_MIN_DB
        else:
            assert got == want
    assert t.config.to_dict() == j.config.to_dict()


def test_cuda_radio_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        Radio()
