"""t41x_torch plain stages vs their t41x twins: the same numpy-seeded
blocks streamed through both with state carried, at the tolerances of
the matching t41x tests (tests/test_kernels.py, test_agc_oracle.py,
test_pallas_kernels.py, test_frontend_fused.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x.chain import rx as jrx
from t41x.dsp import agc as jagc, fir as jfir, firdesign as jfd, iir as jiir
from t41x.dsp import nco as jnco, osfilter as josf, spectrum as jspec
from t41x_torch.chain import rx as trx
from t41x_torch.dsp import agc as tagc, fir as tfir, iir as tiir
from t41x_torch.dsp import nco as tnco, osfilter as tosf, spectrum as tspec

torch.set_num_threads(1)

CH, BLOCKS = 5, 3
T = torch.from_numpy


def _cx(rng, *shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _close(got, ref, rtol, atol, msg=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


@pytest.mark.parametrize("factor,taps,fs", [(4, 28, 192000.0),
                                            (2, 46, 48000.0)])
def test_fir_decimate_streams_like_t41x(factor, taps, fs):
    rng = np.random.default_rng(1)
    h = jfd.fir_kaiser(taps, 3000.0, 90.0, "lowpass", fs=fs).astype(
        np.float32)
    js = jfir.fir_state(taps, (CH,), np.complex64)
    ts = T(js.copy())
    for _ in range(BLOCKS):
        x = _cx(rng, CH, 512)
        js, jy = jfir.fir_decimate(js, jnp.asarray(x), jnp.asarray(h),
                                   factor)
        ts, ty = tfir.fir_decimate(ts, T(x), T(h), factor)
        _close(ty, jy, 1e-5, 1e-6)
        _close(ts, js, 1e-5, 1e-6)


@pytest.mark.parametrize("case", ["real", "complex"])
def test_decimate_reference_matches_t41x(case):
    """The port's copy of the NumPy oracle against t41x's, on the inputs
    of tests/test_kernels.py:19,46; and the port's streaming decimator
    against it, as that file holds t41x's."""
    rng = np.random.default_rng(42)
    if case == "real":
        h = jfd.fir_kaiser(28, 9000.0, 90.0, "lowpass",
                           fs=192000.0).astype(np.float32)
        xs = [rng.standard_normal(256).astype(np.float32)]
    else:
        h = np.ones(8, np.float32) / 8
        x = (rng.standard_normal((3, 64)) + 1j * rng.standard_normal(
            (3, 64))).astype(np.complex64)
        xs = list(x)
    for x in xs:
        got = tfir.decimate_reference(x, h, 4)
        ref = jfir.decimate_reference(x, h, 4)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        _, y = tfir.fir_decimate(tfir.fir_state(len(h), dtype=T(x).dtype),
                                 T(x), T(h), 4)
        _close(y, got, 1e-4, 1e-5)


@pytest.mark.parametrize("factor,taps", [(2, 48), (4, 32)])
def test_fir_interpolate_streams_like_t41x(factor, taps):
    rng = np.random.default_rng(2)
    h = jfd.fir_kaiser(taps, 3000.0, 90.0, "lowpass",
                       fs=24000.0 * factor).astype(np.float32)
    js = np.zeros((CH, taps // factor - 1), np.float32)
    ts = T(js.copy())
    for _ in range(BLOCKS):
        x = rng.standard_normal((CH, 256)).astype(np.float32)
        js, jy = jfir.fir_interpolate(js, jnp.asarray(x), jnp.asarray(h),
                                      factor)
        ts, ty = tfir.fir_interpolate(ts, T(x), T(h), factor)
        _close(ty, jy, 1e-5, 1e-6)
        _close(ts, js, 1e-5, 1e-6)


def test_fs4_and_nco_stream_like_t41x():
    rng = np.random.default_rng(3)
    freq = np.linspace(-700.0, 900.0, CH).astype(np.float32)
    jph = np.zeros(CH, np.float32)
    tph = T(jph.copy())
    for _ in range(BLOCKS):
        x = _cx(rng, CH, 2048)
        jx = jnco.fs4_shift(jnp.asarray(x))
        tx = tnco.fs4_shift(T(x))
        _close(tx, jx, 1e-6, 1e-6)
        jph, jy = jnco.nco_mix(jph, jx, jnp.asarray(freq))
        tph, ty = tnco.nco_mix(tph, tx, T(freq))
        _close(ty, jy, 1e-3, 1e-4)
        _close(tph, jph, 1e-5, 1e-6)


@pytest.mark.parametrize("n", [4, 2048])
def test_fs4_pattern_made_once_per_device(n):
    """Two calls multiply by one cached j**n tensor (no host upload a
    call), and the values equal t41x's exactly."""
    rng = np.random.default_rng(30)
    tnco._fs4_pattern.cache_clear()
    outs = []
    for _ in range(2):
        x = _cx(rng, CH, n)
        outs.append(tnco.fs4_shift(T(x)))
        np.testing.assert_array_equal(outs[-1].numpy(),
                                      np.asarray(jnco.fs4_shift(
                                          jnp.asarray(x))))
    info = tnco._fs4_pattern.cache_info()
    assert (info.misses, info.hits) == (1, 1)
    assert tnco._fs4_pattern(n, torch.device("cpu")) is \
        tnco._fs4_pattern(n, outs[0].device)


def test_biquad_chunked_streams_like_t41x():
    rng = np.random.default_rng(4)
    b, a = jfd.dc_block_biquad()
    lp_b, lp_a = jfd.biquad_rbj(2500.0, 1.3, 24000.0, "lowpass")
    bs, as_ = np.array([b, lp_b]), np.array([a, lp_a])
    jop, top = jiir.BiquadChunked(bs, as_, 128), tiir.BiquadChunked(
        bs, as_, 128)
    js = np.zeros((CH, 2, 2, 2), np.float32)
    ts = T(js.copy())
    for _ in range(BLOCKS):
        x = (rng.standard_normal((CH, 2, 2048)) + 0.3).astype(np.float32)
        js, jy = jop.apply(js, jnp.asarray(x))
        ts, ty = top.apply(ts, T(x))
        _close(ty, jy, 1e-4, 1e-5)
        _close(ts, js, 2e-3, 5e-4)


def test_biquad_apply_matches_t41x_and_scipy():
    """The per-sample df2T oracle against t41x's and SciPy's lfilter
    (the bounds of tests/test_kernels.py's biquad tests), streamed over
    (CH,) channels."""
    scipy_signal = pytest.importorskip("scipy.signal")
    rng = np.random.default_rng(6)
    b, a = jfd.biquad_rbj(3000.0, 1.3, 24000.0, "lowpass")
    x = rng.standard_normal((CH, 500)).astype(np.float32)
    st = np.zeros((CH, 1, 2), np.float32)
    js, jy = jiir.biquad_apply(st, jnp.asarray(x), jnp.asarray([b]),
                               jnp.asarray([a]))
    ts, ty = tiir.biquad_apply(T(st), T(x), [b], [a])
    _close(ty, jy, 1e-5, 1e-6)
    _close(ts, js, 1e-5, 1e-6)
    _close(ty, scipy_signal.lfilter(b, a, x, axis=-1), 1e-3, 1e-4)


def test_biquad_cascade_streaming_and_oracles():
    """Two stages streamed in two halves equal one pass, the NumPy oracle
    (`biquad_reference`, equal to t41x's bit for bit) and the chunked
    operator the chain runs, from zero states."""
    rng = np.random.default_rng(7)
    b1, a1 = jfd.biquad_rbj(2000.0, 0.707, 24000.0, "lowpass")
    b2, a2 = jfd.biquad_rbj(1000.0, 5.0, 24000.0, "notch")
    b, a = np.stack([b1, b2]), np.stack([a1, a2])
    x = rng.standard_normal(256).astype(np.float32)
    s, y1 = tiir.biquad_apply(tiir.biquad_state(stages=2), T(x[:128]), b, a)
    _, y2 = tiir.biquad_apply(s, T(x[128:]), b, a)
    _, yall = tiir.biquad_apply(tiir.biquad_state(stages=2), T(x), b, a)
    _close(torch.cat([y1, y2]), yall.numpy(), 1e-4, 1e-5)
    ref = tiir.biquad_reference(x, b, a)
    np.testing.assert_array_equal(ref, jiir.biquad_reference(x, b, a))
    _close(yall, ref, 1e-3, 1e-4)
    _, yc = tiir.BiquadChunked(b, a, 128).apply(
        tiir.biquad_state(stages=2), T(x))
    _close(yc, yall.numpy(), 1e-3, 1e-4)


def test_one_pole_dc_block_matches_t41x():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((CH, 2048)) + 5.0).astype(np.float32)
    w0 = rng.standard_normal(CH).astype(np.float32)
    jw, jy = jiir.one_pole_dc_block(jnp.asarray(w0), jnp.asarray(x))
    tw, ty = tiir.one_pole_dc_block(T(w0), T(x))
    _close(tw, jw, 1e-6, 0.0)
    # y = w - w_old cancels: its error is that of w (~500 here, where XLA
    # may fuse pole * w_old + x), a few float32 ulps of |w|
    _close(ty, jy, 0.0, 4 * np.spacing(np.abs(np.asarray(jw)).max()))
    # it removes the DC
    _, y = tiir.one_pole_dc_block(torch.zeros(()), T(x[0]))
    assert abs(float(y[500:].mean())) < 0.1


def test_os_filters_stream_like_t41x():
    rng = np.random.default_rng(5)
    mask = jfd.bandpass_mask(200.0, 3000.0)
    W = josf.os_matmul_operator(mask)
    F, W2, msq = josf.os_spectrum_operators(mask)
    m64 = mask.astype(np.complex64)
    js = [josf.os_state((CH,))] * 3
    ts = [T(s.copy()) for s in js]
    for _ in range(BLOCKS):
        x = _cx(rng, CH, 256, scale=0.3)
        jx, tx = jnp.asarray(x), T(x)
        j0 = josf.os_filter(js[0], jx, jnp.asarray(m64), return_spectrum=True)
        t0 = tosf.os_filter(ts[0], tx, T(m64), return_spectrum=True)
        j1 = josf.os_filter_matmul(js[1], jx, jnp.asarray(W))
        t1 = tosf.os_filter_matmul(ts[1], tx, T(W))
        j2 = josf.os_filter_matmul_spectrum(js[2], jx, jnp.asarray(F),
                                            jnp.asarray(W2), jnp.asarray(msq))
        t2 = tosf.os_filter_matmul_spectrum(ts[2], tx, T(F), T(W2), T(msq))
        for jo, to in ((j0, t0), (j1, t1), (j2, t2)):
            _close(to[1], jo[1], 2e-3, 2e-4)
            _close(to[0], jo[0], 0.0, 0.0)
            if len(jo) == 3:
                ref = np.asarray(jo[2])
                _close(to[2], ref, 2e-4, 2e-3 * float(ref.max()))
        js = [j0[0], j1[0], j2[0]]
        ts = [t0[0], t1[0], t2[0]]


def test_sliding_window_max_exact():
    rng = np.random.default_rng(6)
    a = rng.random((CH, 352)).astype(np.float32)
    for width in (1, 5, 96):
        np.testing.assert_array_equal(
            tagc._sliding_window_max(T(a), width).numpy(),
            np.asarray(jagc._sliding_window_max(jnp.asarray(a), width)))


def test_agc_step_branch_for_branch():
    """Every (state, decay_type, hang counter, attack) combination."""
    rng = np.random.default_rng(7)
    p = jagc.agc_params(2)
    n = 4000
    volts = rng.uniform(1e-3, 1.0, n).astype(np.float32)
    carry = (volts,
             (volts * rng.uniform(0.5, 1.5, n)).astype(np.float32),
             rng.uniform(0.0, 0.5, n).astype(np.float32),
             rng.uniform(0.0, 0.5, n).astype(np.float32),
             rng.integers(0, 3, n).astype(np.int32),
             rng.integers(0, 2, n).astype(np.int32),
             rng.integers(0, 5, n).astype(np.int32))
    rm = (volts * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    ao = rng.uniform(0.0, 1.0, n).astype(np.float32)
    jout = jagc.agc_step(p, tuple(map(jnp.asarray, carry)),
                         jnp.asarray(rm), jnp.asarray(ao))
    tout = tagc.agc_step(p, tuple(map(T, carry)), T(rm), T(ao))
    for i, (t, j) in enumerate(zip(tout, jout)):
        assert t.dtype == (torch.int32 if i >= 4 else torch.float32)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=i)


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 4])
def test_agc_apply_streams_like_t41x(mode):
    rng = np.random.default_rng(8 + mode)
    p = jagc.agc_params(mode)
    japply = jax.jit(functools.partial(jagc.agc_apply, p))
    js = jagc.agc_state(p, (CH,))
    ts = tagc.AGCState(*map(lambda a: T(a.copy()), js))
    for b in range(BLOCKS):  # levels that move the gain through its states
        x = _cx(rng, CH, 256, scale=(0.02, 0.5, 0.005)[b])
        js, jy = japply(js, jnp.asarray(x))
        ts, ty = tagc.agc_apply(p, ts, T(x))
        _close(ty, jy, 1e-6, 1e-7)
        for f in ts._fields:
            _close(getattr(ts, f), getattr(js, f), 1e-6, 1e-7, f)


def test_zoom1_spectrum_streams_like_t41x():
    rng = np.random.default_rng(9)
    js = np.zeros((CH, jspec.RES), np.float32)
    ts = T(js.copy())
    for _ in range(BLOCKS):
        x = _cx(rng, CH, 2048, scale=0.3)
        js, jp = jspec.zoom1_spectrum(js, jnp.asarray(x))
        ts, tp = tspec.zoom1_spectrum(ts, T(x))
        ref = np.asarray(jp)
        _close(tp, ref, 2e-4, 2e-3 * float(ref.max()))
    np.testing.assert_array_equal(tspec._hann(512), jspec._hann(512))


def test_iq_correction_and_volume_like_t41x():
    rng = np.random.default_rng(10)
    i, q = rng.standard_normal((2, CH, 64)).astype(np.float32)
    amp = np.linspace(0.97, 1.03, CH).astype(np.float32)
    ph = np.linspace(-0.02, 0.02, CH).astype(np.float32)
    _close(trx.iq_correction(T(i), T(q), T(amp), T(ph)),
           jrx.iq_correction(i, q, amp, ph), 1e-6, 1e-7)
    vol = np.linspace(0.0, 100.0, 11).astype(np.float32)
    _close(trx.volume_to_amplification(T(vol)),
           jrx.volume_to_amplification(jnp.asarray(vol)), 1e-6, 1e-7)
