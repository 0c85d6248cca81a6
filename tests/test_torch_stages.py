"""The stages of the port's third slice against their t41x twins on the
same numpy-seeded input, with state carried over the blocks:
`ZoomFFT` (block, prefilter + spectrum), `EQDesign.apply` (and against
the per-band biquad oracle of tests/test_nr_eq_spectrum.py),
`CWDetector.block`, `levinson`, `noise_blanker`, `fir_apply`, and the
display helpers `pixels_db` and `smeter_dbm`.  Tolerances: rtol 2e-4 /
atol 2e-5 on waveforms (the chain's), the zoom spectrum at rtol 2e-4 /
atol 2e-3 of its peak, and 1e-5 relative on the LPC coefficients."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.demod import cw as jcw
from t41x.dsp import eq as jeq, fir as jfir, iir as jiir, nb as jnb
from t41x.dsp import spectrum as jspec
from t41x_torch.demod import cw as tcw
from t41x_torch.dsp import eq as teq, fir as tfir, nb as tnb
from t41x_torch.dsp import spectrum as tspec

torch.set_num_threads(1)
T = torch.from_numpy


def _close(got, ref, rtol=2e-4, atol=2e-5, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _cx(rng, *shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


@pytest.mark.parametrize("zoom", [1, 2, 5, 7])
def test_zoomfft_matches_t41x(zoom):
    rng = np.random.default_rng(40 + zoom)
    ch = 3
    jz, tz = jspec.ZoomFFT(zoom), tspec.ZoomFFT(zoom)
    js, ts = jz.init_state((ch,)), tz.init_state((ch,))
    t = np.arange(4 * C.BLOCK_SIZE) / C.SAMPLE_RATE
    iq = (0.5 * np.exp(2j * np.pi * 700.0 * t)
          + _cx(rng, ch, t.size, scale=0.05)).astype(np.complex64)
    for b in range(4):
        x = iq[:, b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
        js, jp = jz.block(js, jnp.asarray(x))
        ts, tp = tz.block(ts, T(x))
        ref = np.asarray(jp)
        _close(tp, ref, 2e-4, 2e-3 * float(ref.max()), f"power block {b}")
        for f in ts._fields:
            r = np.asarray(getattr(js, f))
            _close(getattr(ts, f), r, 2e-3,
                   max(5e-4, 1e-3 * float(np.abs(r).max())), f)
    # the two halves compose to the whole
    ts2, xd = tz.prefilter(tz.init_state((ch,)), T(iq[:, :C.BLOCK_SIZE]))
    assert xd.shape == (ch, C.BLOCK_SIZE // (1 << zoom))
    _, p2 = tz.spectrum_from_decimated(ts2, xd)
    _, p1 = tz.block(tz.init_state((ch,)), T(iq[:, :C.BLOCK_SIZE]))
    assert torch.equal(p1, p2)


def test_display_helpers_match_t41x():
    rng = np.random.default_rng(41)
    p = (rng.random((3, 512)) ** 4).astype(np.float32)
    p[0, :3] = 0.0  # the 1e-30 floor
    for kw in (dict(), dict(db_scale=20.0, base_offset=-3.0,
                            pixel_offset=7.0)):
        _close(tspec.pixels_db(T(p), **kw), jspec.pixels_db(jnp.asarray(p),
                                                            **kw),
               1e-6, 1e-5)
    a = (rng.random(5) * 400.0).astype(np.float32)
    for kw in (dict(), dict(gain_correction=2.0, attenuator=10.0,
                            rf_gain=3.0, rf_gain_all=-4.0)):
        _close(tspec.smeter_dbm(T(a), **kw),
               jspec.smeter_dbm(jnp.asarray(a), **kw), 1e-6, 1e-5)


def test_eq_matches_t41x_and_per_band_oracle():
    """The composed chunk operator against t41x's, and both against the
    per-band df2T cascades (t41x.dsp.iir.biquad_apply) with the
    alternating signs and gains, streamed over 3 blocks."""
    rng = np.random.default_rng(17)
    ch, n, blocks = 3, 256, 3
    je, te = jeq.EQDesign(), teq.EQDesign()
    gains = rng.random((ch, teq.NUM_BANDS)).astype(np.float32)
    x = rng.standard_normal((ch, blocks * n)).astype(np.float32) * 0.3
    js = jnp.asarray(je.init_state((ch,)))
    ts = te.init_state((ch,))
    st_ref = np.zeros((ch, teq.NUM_BANDS, te.stages, 2), np.float32)
    signs = np.asarray([(-1.0) ** (i + 1) * -1.0
                        for i in range(teq.NUM_BANDS)], np.float32)
    for bi in range(blocks):
        blk = x[:, bi * n:(bi + 1) * n]
        js, jy = je.apply(js, jnp.asarray(blk), jnp.asarray(gains))
        ts, ty = te.apply(ts, T(blk), T(gains))
        _close(ty, jy, msg=f"block {bi}")
        _close(ts, js, 2e-4, 2e-5, f"state block {bi}")
        y_ref = np.zeros_like(blk)
        new_ref = np.empty_like(st_ref)
        for b in range(teq.NUM_BANDS):
            sb, yb = jiir.biquad_apply(jnp.asarray(st_ref[:, b]),
                                       jnp.asarray(blk), te.b[b], te.a[b])
            new_ref[:, b] = np.asarray(sb)
            y_ref += signs[b] * gains[:, b:b + 1] * np.asarray(yb)
        st_ref = new_ref
        # the bound of tests/test_nr_eq_spectrum.py's oracle test
        _close(ty, y_ref, 2e-4, 2e-4, f"oracle block {bi}")


def test_cw_detector_matches_t41x():
    """A 750 Hz carrier keyed on and off every 2 blocks, in noise: keyed
    equal, combined and the carried state within the waveform bounds."""
    rng = np.random.default_rng(42)
    ch, nb_ = 4, 12
    jd, td = jcw.CWDetector(), tcw.CWDetector()
    js, ts = jd.init_state((ch,)), td.init_state((ch,))
    t = np.arange(nb_ * 256) / C.AUDIO_RATE
    key = (np.arange(t.size) // 512) % 2 == 0
    audio = (0.5 * key * np.sin(2 * np.pi * 750.0 * t)
             * np.linspace(0.2, 1.0, ch)[:, None]
             + 0.02 * rng.standard_normal((ch, t.size))).astype(np.float32)
    keyed = []
    for b in range(nb_):
        a = audio[:, b * 256:(b + 1) * 256]
        js, jk, jc = jd.block(js, jnp.asarray(a))
        ts, tk, tc = td.block(ts, T(a))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        _close(tc, jc, 1e-4, 1e-4, f"combined block {b}")
        for f in ts._fields:
            _close(getattr(ts, f), getattr(js, f), 1e-4, 1e-4, f)
        keyed.append(tk.numpy())
    keyed = np.asarray(keyed)
    assert keyed.any() and (~keyed).any()


def _nb_frames(rng, ch):
    """Tone plus impulses in noise, one 256-sample frame per channel."""
    t = np.arange(256) / C.AUDIO_RATE
    x = (0.3 * np.sin(2 * np.pi * 600.0 * t)
         + 0.02 * rng.standard_normal((ch, 256))).astype(np.float32)
    for c in range(ch):
        for pos in rng.choice(np.arange(30, 220), size=c % 3 + 1,
                              replace=False):
            x[c, pos] += 1.5 * (-1) ** c
    return x


def test_levinson_matches_t41x():
    rng = np.random.default_rng(43)
    x = _nb_frames(rng, 5)
    r = np.stack([np.sum(x[:, : 256 - i] * x[:, i:], axis=-1)
                  for i in range(tnb.ORDER + 1)], axis=-1).astype(np.float32)
    _close(tnb.levinson(T(r)), jnb.levinson(jnp.asarray(r)), 1e-5, 1e-6)


def test_noise_blanker_matches_t41x():
    rng = np.random.default_rng(44)
    x = _nb_frames(rng, 6)
    ty = tnb.noise_blanker(T(x))
    jy = np.asarray(jnb.noise_blanker(jnp.asarray(x)))
    _close(ty, jy)
    blanked = ty.numpy() != x
    assert blanked.any(axis=-1).all()   # every frame had an impulse
    # the blanked mask equals t41x's
    np.testing.assert_array_equal(blanked, jy != x)


def test_distance_from_start_is_the_scan():
    rng = np.random.default_rng(45)
    m = rng.random((4, 300)) < 0.4
    want = np.zeros(m.shape, np.float32)
    for c in range(m.shape[0]):
        run = 0
        for i in range(m.shape[1]):
            run = run + 1 if m[c, i] else 0
            want[c, i] = run
    got = tnb._distance_from_start(T(m))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_fir_apply_matches_t41x():
    rng = np.random.default_rng(46)
    h = rng.standard_normal(64).astype(np.float32)
    js = jfir.fir_state(64, (3,))
    ts = tfir.fir_state(64, (3,))
    for b in range(3):
        x = rng.standard_normal((3, 256)).astype(np.float32)
        js, jy = jfir.fir_apply(js, jnp.asarray(x), jnp.asarray(h))
        ts, ty = tfir.fir_apply(ts, T(x), T(h))
        _close(ty, jy, 2e-5, 2e-5, f"block {b}")
        _close(ts, js, 0.0, 0.0, "history")
