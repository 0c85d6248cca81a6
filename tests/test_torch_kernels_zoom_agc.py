"""The plain versions of K1's zoom variant (K1z) and of K5 against t41x's
Pallas kernels in interpret mode (their default on the CPU), with state
carried, at 5 channels and at 130 (not a multiple of any tile).  Their
`gpu` cases are in tests/test_torch_kernels.py.

* K1z: `FusedFrontEnd` at zoom 1, 3 and 7, complex64 and q15 ingest,
  over 3 blocks: the 24 kHz output at K1's bounds (2e-4 / 2e-5), the
  decimated zoom stream and the zoom state at the state bounds of
  tests/test_frontend_fused.py (rtol 2e-3, atol max(5e-4, 1e-3 scale)).
* K5: `agc_scan` over 4 pieces of 64 samples (shorter than the 96-sample
  delay line) at the bound of tests/test_pallas_kernels.py (1e-6 / 1e-7).
"""

import numpy as np
import pytest
import torch

from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.chain import default_params as tparams
from t41x_torch.dsp import agc as tagc
from t41x_torch.dsp.spectrum import ZoomFFT
from t41x_torch.kernels import agc as tk_agc
from t41x_torch.kernels.frontend import FusedFrontEnd as TFront

torch.set_num_threads(1)

BLOCKS = 3
CHAIN = RxChain(ChainSpec(), device="cpu")
T = torch.from_numpy


@pytest.fixture(scope="module")
def jx():
    import jax.numpy as jnp

    from t41x.kernels.agc_pallas import agc_scan_pallas
    from t41x.kernels.frontend_pallas import FusedFrontEnd
    return jnp, FusedFrontEnd, agc_scan_pallas


def _cx(rng, *shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _q15(x):
    def cv(a):
        return np.clip(np.round(a * 32768.0), -32768, 32767).astype(np.int16)
    return cv(x.real), cv(x.imag)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _close(got, ref, rtol, atol, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _state_close(got, ref, msg=""):
    for a, b in zip(_leaves(got), _leaves(ref)):
        b = np.asarray(b)
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        _close(a, b, 2e-3, max(5e-4, 1e-3 * scale), msg)


@pytest.mark.parametrize("ch", [5, 130])
@pytest.mark.parametrize("fmt", ["c64", "q15"])
@pytest.mark.parametrize("zoom", [1, 3, 7])
def test_frontend_zoom_plain_matches_pallas(jx, zoom, fmt, ch):
    """K1z: the plain version (per-stage zoom IIR + decimator) against
    t41x's composed in-kernel zoom tap."""
    jnp, JFront, _ = jx
    rng = np.random.default_rng(29)
    z = ZoomFFT(zoom)  # designs pinned equal to t41x's
    args = (CHAIN.h1, CHAIN.h2, CHAIN.dc_b[0], CHAIN.dc_a[0])
    kw = dict(zoom=zoom, zoom_sos=(z.iir_b, z.iir_a), zoom_h=z.h)
    jf, tf = JFront(*args, **kw), TFront(*args, **kw)
    lin = lambda a, b: torch.linspace(a, b, ch)  # noqa: E731
    tp = tparams((ch,), device="cpu")._replace(
        nco_freq=lin(-500.0, 700.0), rf_gain_db=lin(-3.0, 6.0),
        iq_amp=lin(0.97, 1.03), iq_phase=lin(-0.02, 0.02))
    jp = tp._replace(**{f: jnp.asarray(getattr(tp, f).numpy())
                        for f in tp._fields})
    js = jf.init_state((ch,))
    ts = tuple(T(a.copy()) for a in js)
    zst = z.init_state((ch,))
    tz = (zst.iir, zst.dec)
    jz = tuple(jnp.asarray(a.numpy()) for a in tz)
    for _ in range(BLOCKS):
        x = _cx(rng, ch, 2048, scale=0.3)
        if fmt == "q15":
            jin = tuple(map(jnp.asarray, _q15(x)))
            tx = tuple(map(T, _q15(x)))
        else:
            jin, tx = jnp.asarray(x), T(x)
        jo, to = jf.block(jp, js, jin, jz), tf.block(tp, ts, tx, tz)
        js, ts, jz, tz = jo[0], to[0], jo[3:], to[3:]
        _close(to[1], jo[1], 2e-4, 2e-5, "x")
        _state_close(to[2], jo[2], "zoom stream")
        _state_close(ts, js)
        _state_close(tz, jz, "zoom state")


@pytest.mark.parametrize("ch", [5, 130])
def test_agc_scan_plain_matches_pallas(jx, ch):
    """K5: the plain recurrence against agc_scan_pallas, the prework
    (delay line, window peak) formed as agc_apply forms it."""
    jnp, _, agc_scan_pallas = jx
    rng = np.random.default_rng(30)
    p = tagc.agc_params(2)
    st = tagc.agc_state(p, (ch,))
    b = p.attack_buffsize
    tc = (st.volts, st.save_volts, st.fast_backaverage,
          st.hang_backaverage, st.hang_counter, st.decay_type, st.state)
    jc = tuple(jnp.asarray(c.numpy()) for c in tc)
    ring, abs_ring = st.ring, st.abs_ring
    for blk in range(4):  # K2's stimulus levels: the gain walks its states
        x = T(_cx(rng, ch, 64, scale=(0.02, 0.5, 0.005, 0.1)[blk]))
        full = torch.cat([ring, x], dim=-1)
        abs_full = torch.cat([abs_ring, x.abs()], dim=-1)
        rm = tagc._sliding_window_max(abs_full, b)[..., 1:65].T.contiguous()
        ao = abs_full[..., :64].T.contiguous()
        ring, abs_ring = full[..., 64:], abs_full[..., 64:]
        jc, jv = agc_scan_pallas(p, jc, jnp.asarray(rm.numpy()),
                                 jnp.asarray(ao.numpy()), interpret=True)
        tc, tv = tk_agc.agc_scan(p, tc, rm, ao)
        _close(tv, jv, 1e-6, 1e-7, f"volts piece {blk}")
        for i, (a, r) in enumerate(zip(tc, jc)):
            _close(a, r, 1e-6, 1e-7, f"carry[{i}] piece {blk}")
