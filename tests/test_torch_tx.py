"""The port's transmit chains against t41x's on the CPU.

The mic compressor from random carried envelopes (both the attack and
the release branch); the SSB exciter in every combination of sideband,
TX EQ, compressor and IQ phase sign, at channels () and (3,), held at
I/Q SNR >= 100 dB (the North-star bound is 55 dB); the CW exciter and
the CW power polynomial; the Hilbert taps bit for bit; states that cross
between the packages mid-stream in both directions; `Radio.transmit_ssb`
(the default config, which runs the compressor) and `transmit_cw`; and
the operator session's `cal tx` through a loopback, which must answer
as t41x's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.chain import compressor as jcomp, tx as jtx
from t41x.dsp import firdesign as jfd
from t41x.io import repl as j_repl, signals
from t41x.radio import Radio as JRadio
from t41x.runner import StreamRunner as JRunner
from t41x_torch.chain import compressor as tcomp, tx as ttx
from t41x_torch.dsp import firdesign as tfd
from t41x_torch.io import repl as t_repl
from t41x_torch.radio import Radio
from t41x_torch.runner import StreamRunner
from t41x_torch.utils import convert, parity

torch.set_num_threads(1)

TX_SNR_MIN_DB = 100.0  # what holds on the CPU (the contract is 55 dB)


def _mic(channels, n_blocks, seed=0):
    """A 1 kHz tone plus noise at three levels across the channels:
    below, near and far above the compressor's -10 dBFS knee."""
    rng = np.random.default_rng(seed)
    n = n_blocks * C.BLOCK_SIZE
    tone = 0.3 * np.sin(2 * np.pi * 1000.0 * np.arange(n) / C.SAMPLE_RATE)
    level = np.array([0.1, 1.0, 3.0])[: max(int(np.prod(channels)), 1)]
    mic = tone * level[:, None] + 0.01 * rng.standard_normal((len(level), n))
    return mic.reshape(channels + (n,)).astype(np.float32)


def _blocks(mic):
    return [mic[..., b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
            for b in range(mic.shape[-1] // C.BLOCK_SIZE)]


def _j_params(channels, phase, seed=1):
    rng = np.random.default_rng(seed)
    amp = np.linspace(0.97, 1.03, max(int(np.prod(channels)), 1))
    return jtx.default_tx_params(channels)._replace(
        iq_amp=amp.reshape(channels).astype(np.float32),
        iq_phase=np.full(channels, phase, np.float32),
        eq_gains=rng.uniform(0, 1, channels + (14,)).astype(np.float32))


def _run_j(ex, p, st, blocks):
    out = []
    for b in blocks:
        st, iq = ex.block(p, st, jnp.asarray(b))
        out.append(np.asarray(iq))
    return st, np.concatenate(out, axis=-1)


def _run_t(ex, p, st, blocks):
    out = []
    for b in blocks:
        st, iq = ex.block(p, st, torch.from_numpy(np.ascontiguousarray(b)))
        out.append(iq.numpy())
    return st, np.concatenate(out, axis=-1)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def test_compress_both_branches():
    rng = np.random.default_rng(2)
    p = jcomp.compressor_params(rate=C.SAMPLE_RATE)
    # random carried envelopes, levels from near silence to +10 dBFS
    env0 = rng.uniform(-80.0, 10.0, 6).astype(np.float32)
    x = (rng.standard_normal((6, 2 * C.BLOCK_SIZE))
         * np.logspace(-3, 0.5, 6)[:, None]).astype(np.float32)
    js = jcomp.CompressorState(env0)
    ts = tcomp.CompressorState(torch.from_numpy(env0))
    tp = tcomp.compressor_params(rate=C.SAMPLE_RATE)
    assert tuple(tp) == tuple(p)
    np.testing.assert_array_equal(tcomp.gain_consts(tp)[:2], np.float32(
        [p.attack_coeff, p.release_coeff]))
    for b in range(2):
        blk = x[:, b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
        js, jy = jcomp.compress(p, js, jnp.asarray(blk))
        ts, ty = tcomp.compress(tp, ts, torch.from_numpy(blk))
        # each sample's rounding rides the 2048-step recurrence on
        np.testing.assert_allclose(ts.env_db.numpy(), np.asarray(js.env_db),
                                   rtol=0, atol=0.01)
        assert parity.snr_db(np.asarray(jy), ty.numpy()) >= TX_SNR_MIN_DB
    # both branches ran, and the knee reduced the loud rows' gain
    ldb = 20 * np.log10(np.maximum(np.abs(x), 1e-9))
    env, attack = env0.astype(np.float64), 0
    for n in range(x.shape[-1]):
        up = ldb[:, n] > env
        attack += int(up.sum())
        c = np.where(up, p.attack_coeff, p.release_coeff)
        env = c * env + (1 - c) * ldb[:, n]
    assert 0 < attack < x.size
    assert (np.abs(ty.numpy()) < np.abs(x[:, C.BLOCK_SIZE:]) - 1e-6).any()


def test_compress_empty_block():
    st = tcomp.compressor_state((2,), "cpu")
    st2, y = tcomp.compress(tcomp.compressor_params(), st,
                            torch.zeros(2, 0))
    assert y.shape == (2, 0)
    torch.testing.assert_close(st2.env_db, st.env_db)


def test_tx_designs_equal():
    for lp in (None, 3000.0, 12000.0):
        for a, b in zip(tfd.decimation_prototypes(lp),
                        jfd.decimation_prototypes(lp)):
            np.testing.assert_array_equal(a, b)
    for taps in (101, 64, 31):
        spec = dict(hilbert_taps=taps)
        j = jtx.SSBExciter(jtx.TxSpec(**spec))
        t = ttx.SSBExciter(ttx.TxSpec(**spec), device="cpu")
        for name in ("h1", "h2", "hi1", "hi2", "hilbert", "delay_taps"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype == np.float32, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert len(t.hilbert) == taps | 1


@pytest.mark.parametrize("channels", [(), (3,)])
@pytest.mark.parametrize("phase", [0.02, -0.03])
@pytest.mark.parametrize("comp", [False, True])
@pytest.mark.parametrize("eq", [False, True])
@pytest.mark.parametrize("sideband", ["usb", "lsb"])
def test_ssb_exciter_matches_t41x(sideband, eq, comp, phase, channels):
    kw = dict(sideband=sideband, eq_on=eq, compressor_on=comp)
    j, t = jtx.SSBExciter(jtx.TxSpec(**kw)), ttx.SSBExciter(
        ttx.TxSpec(**kw), device="cpu")
    jp = _j_params(channels, phase)
    tp = convert.tx_params_from_numpy(jp, "cpu")
    blocks = _blocks(_mic(channels, 3))
    js, want = _run_j(j, jp, j.init_state(channels), blocks)
    ts, got = _run_t(t, tp, t.init_state(channels), blocks)
    assert got.dtype == np.complex64 and got.shape == want.shape
    assert parity.snr_db(want, got) >= TX_SNR_MIN_DB
    assert ts._fields == js._fields
    for a, b in zip(_leaves(convert.state_to_numpy(ts)), _leaves(js)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_iq_correction_order():
    """T2: on the negative-phase branch the amplitude-corrected I feeds
    Q; on the positive one Q feeds I.  Both signs against t41x, and each
    against its closed form on the uncorrected I/Q pair."""
    j, t = jtx.SSBExciter(), ttx.SSBExciter(device="cpu")
    blocks = _blocks(_mic((), 2))
    base = _run_t(t, convert.tx_params_from_numpy(
        _j_params((), 0.0)._replace(iq_amp=np.float32(1.0)), "cpu"),
        t.init_state(), blocks)[1]
    for phase in (0.05, -0.05):
        jp = _j_params((), phase)._replace(iq_amp=np.float32(0.9))
        got = _run_t(t, convert.tx_params_from_numpy(jp, "cpu"),
                     t.init_state(), blocks)[1]
        want = _run_j(j, jp, j.init_state(), blocks)[1]
        assert parity.snr_db(want, got) >= TX_SNR_MIN_DB
        # the interpolators are linear: correct the uncorrected output
        i0, q0 = base.real, base.imag
        i_c = 0.9 * i0
        if phase >= 0:
            ref = (i_c + phase * q0) + 1j * q0
        else:
            ref = i_c + 1j * (q0 + phase * i_c)
        assert parity.snr_db(ref, got) >= 90.0


@pytest.mark.parametrize("kind", ["ssb", "cw"])
def test_states_cross_mid_stream(kind):
    """T4: a stream starts in one package and ends in the other, both
    ways, against either package's unbroken stream."""
    if kind == "ssb":
        kw = dict(sideband="usb", eq_on=True, compressor_on=True)
        j, t = jtx.SSBExciter(jtx.TxSpec(**kw)), ttx.SSBExciter(
            ttx.TxSpec(**kw), device="cpu")
        jp = _j_params((2,), -0.02)
        tp = convert.tx_params_from_numpy(jp, "cpu")
        blocks = _blocks(_mic((2,), 4))

        def jrun(st, bl):
            return _run_j(j, jp, st, bl)

        def trun(st, bl):
            return _run_t(t, tp, st, bl)
    else:
        j, t = jtx.CWExciter(), ttx.CWExciter(device="cpu")
        keys = [np.array([1.0, 0.0]), np.array([1.0, 1.0]),
                np.array([0.0, 1.0]), np.array([0.0, 0.0])]

        def jrun(st, bl):
            out = []
            for k in bl:
                st, iq = j.block(st, jnp.asarray(k), 0.8)
                out.append(np.asarray(iq))
            return st, np.concatenate(out, -1)

        def trun(st, bl):
            out = []
            for k in bl:
                st, iq = t.block(st, torch.from_numpy(k), 0.8)
                out.append(iq.numpy())
            return st, np.concatenate(out, -1)
        blocks = keys
    _, whole = jrun(j.init_state((2,)), blocks)
    # t41x -> port
    js, a = jrun(j.init_state((2,)), blocks[:2])
    ts = convert.tx_state_from_numpy(js, "cpu")
    assert type(ts).__module__ == ttx.__name__
    if kind == "ssb":
        assert type(ts.comp) is tcomp.CompressorState
    _, b = trun(ts, blocks[2:])
    assert parity.snr_db(whole, np.concatenate([a, b], -1)) >= TX_SNR_MIN_DB
    # port -> t41x
    ts, a = trun(t.init_state((2,)), blocks[:2])
    _, b = jrun(convert.state_to_numpy(ts), blocks[2:])
    assert parity.snr_db(whole, np.concatenate([a, b], -1)) >= TX_SNR_MIN_DB


def test_cw_exciter_and_power_scale():
    j, t = jtx.CWExciter(tone_hz=700.0), ttx.CWExciter(tone_hz=700.0,
                                                       device="cpu")
    js, ts = j.init_state(), t.init_state()
    want, got = [], []
    for key in [1, 1, 1, 0, 0, 1, 0, 0]:
        js, a = j.block(js, jnp.asarray(float(key)), 0.7)
        ts, b = t.block(ts, float(key), 0.7)
        want.append(np.asarray(a))
        got.append(b.numpy())
        np.testing.assert_allclose(ts.env.numpy(), np.asarray(js.env),
                                   atol=1e-6)
        np.testing.assert_allclose(ts.phase.numpy(), np.asarray(js.phase),
                                   atol=1e-5)
    want, got = np.concatenate(want), np.concatenate(got)
    assert got.dtype == np.complex64
    assert parity.snr_db(want, got) >= TX_SNR_MIN_DB
    watts = np.float32([0.0, 2.5, 10.0, 20.0])
    np.testing.assert_allclose(
        ttx.cw_power_scale(torch.from_numpy(watts), 1.1).numpy(),
        np.asarray(jtx.cw_power_scale(jnp.asarray(watts), 1.1)), rtol=1e-6)
    assert ttx.cw_power_scale(10.0) == pytest.approx(
        float(jtx.cw_power_scale(10.0)), rel=1e-6)


@pytest.mark.parametrize("setup", ["default", "lsb_eq_nocomp"])
def test_radio_transmit_ssb(setup, monkeypatch):
    """The default config runs the mic compressor (t41x turns it on for
    mic_compression < 0, and the default is -10)."""
    calls = []
    compress = tcomp.compress
    monkeypatch.setattr(tcomp, "compress",
                        lambda *a: calls.append(1) or compress(*a))
    j, t = JRadio(), Radio(device="cpu")
    assert t.config.mic_compression < 0
    if setup != "default":
        for r in (j, t):
            r.set_mode("lsb")
            r.set_eq("tx", True)
            r.set_eq_band("tx", 3, 20)
            r.set_mic_compression(3.0)
            r.config.band.iq_amp_correction_tx = 1.02
            r.config.band.iq_phase_correction_tx = -0.01
    mic = signals.voice_proxy(5 * C.BLOCK_SIZE + 100, fs_audio=C.SAMPLE_RATE,
                              f_lo=300.0, f_hi=2700.0)
    want, got = j.transmit_ssb(mic), t.transmit_ssb(mic)
    assert got.dtype == want.dtype and got.shape == want.shape \
        == (5 * C.BLOCK_SIZE,)
    assert parity.snr_db(want, got) >= TX_SNR_MIN_DB
    assert len(calls) == (5 if setup == "default" else 0)


def test_radio_transmit_cw():
    j, t = JRadio(), Radio(device="cpu")
    for r in (j, t):
        r.config.cw_power = 7.5
    want, got = j.transmit_cw("TEST", wpm=25), t.transmit_cw("TEST", wpm=25)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert parity.snr_db(want, got) >= TX_SNR_MIN_DB


def _tx_hardware(iq):
    """A QSE with an IQ impairment, seen through the cal loopback."""
    i, q = iq.real, iq.imag
    return (1.04 * i + 0.03 * q) + 1j * q


def test_cal_tx_answers_as_t41x():
    jr, tr = JRunner(JRadio()), StreamRunner(Radio(device="cpu"))
    js = j_repl.OperatorSession(jr, loopback=_tx_hardware)
    ts = t_repl.OperatorSession(tr, loopback=_tx_hardware)
    want = js.execute("cal tx 1000")
    assert "TX cal" in want and "image rejection" in want
    assert ts.execute("cal tx 1000") == want
    assert tr.radio.config.to_dict() == jr.radio.config.to_dict()
