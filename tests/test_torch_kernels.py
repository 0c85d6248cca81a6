"""t41x_torch kernel modules vs the t41x Pallas kernels.

On the CPU each wrapper takes its plain torch version; those are held
against the JAX Pallas wrappers run in interpret mode (their default on
CPU), over 3 streamed blocks with state carried, at 5 channels and at
130 (not a multiple of any tile); tests/test_torch_kernels_zoom_agc.py
does the same for K1's zoom variant and K5.  The `gpu` cases hold each
CUDA kernel, those two included, against its plain version on the card
and skip without one.
"""

import math
import types

import numpy as np
import pytest
import torch

from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.chain import default_params as tparams
from t41x_torch.demod import sam as tsam
from t41x_torch.dsp import agc as tagc, nr as tnr, osfilter as tosf
from t41x_torch.dsp.spectrum import ZoomFFT
from t41x_torch.kernels import _build
from t41x_torch.kernels import agc as tk_agc
from t41x_torch.kernels import nr_gain as tk_nr
from t41x_torch.kernels import os_filter as tk_os
from t41x_torch.kernels import sam as tk_sam
from t41x_torch.kernels import xanr as tk_xanr
from t41x_torch.kernels.frontend import FusedFrontEnd as TFront
from t41x_torch.kernels.interp import FusedInterp as TInterp

torch.set_num_threads(1)

BLOCKS = 3
CHAIN = RxChain(ChainSpec(), device="cpu")  # designs pinned equal to t41x's
T = torch.from_numpy


@pytest.fixture(scope="module")
def jx():
    """The JAX reference: t41x's Pallas wrappers (interpret mode on the
    CPU).  The card's machine has no JAX, so its kernel cases below run
    without this fixture."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from t41x.dsp import agc
    from t41x.kernels import os_filter_matmul_pallas
    from t41x.kernels.agc_pallas import agc_block_pallas
    from t41x.kernels.frontend_pallas import FusedFrontEnd
    from t41x.kernels.interp_pallas import FusedInterp
    from t41x.kernels.nr_gain_pallas import kim_gains_pallas
    from t41x.kernels.sam_pallas import sam_block_pallas
    from t41x.kernels.xanr_pallas import xanr_block_pallas
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, agc=agc, os_filter=os_filter_matmul_pallas,
        agc_block=agc_block_pallas, Front=FusedFrontEnd, Interp=FusedInterp,
        sam_block=sam_block_pallas, xanr_block=xanr_block_pallas,
        kim_gains=kim_gains_pallas)


def _cx(rng, *shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _q15(x):
    def cv(a):
        return np.clip(np.round(a * 32768.0), -32768, 32767).astype(np.int16)
    return cv(x.real), cv(x.imag)


def _params(ch, device="cpu"):
    lin = lambda a, b: torch.linspace(a, b, ch, device=device)  # noqa: E731
    return tparams((ch,), device=device)._replace(
        nco_freq=lin(-500.0, 700.0), rf_gain_db=lin(-3.0, 6.0),
        iq_amp=lin(0.97, 1.03), iq_phase=lin(-0.02, 0.02))


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _close(got, ref, rtol, atol, msg=""):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=msg)


def _state_close(got, ref, msg=""):
    # tests/test_frontend_fused.py::_assert_state_close bounds
    for a, b in zip(_leaves(got), _leaves(ref)):
        b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        _close(a, b, 2e-3, max(5e-4, 1e-3 * scale), msg)


def _front(cls, zoom):
    kw = {}
    if zoom is not None and zoom >= 1:
        z = ZoomFFT(zoom)  # designs pinned equal to t41x's
        kw = dict(zoom_sos=(z.iir_b, z.iir_a), zoom_h=z.h)
    return cls(CHAIN.h1, CHAIN.h2, CHAIN.dc_b[0], CHAIN.dc_a[0], zoom=zoom,
               **kw)


def _zoom_state(zoom, ch, device=None):
    """(iir, dec) of a fresh ZoomState."""
    st = ZoomFFT(zoom).init_state((ch,), device)
    return st.iir, st.dec


# a near-silence, a burst, a deeper silence, a moderate level: from
# random states (_agc_rand_state) these reach all five AGC states
_AGC_LEVELS = (0.001, 0.3, 0.0005, 0.05)


def _agc_rand_state(rng, p, ch):
    """A random AGCState on the CPU: any of the five states, live hang
    counters, either decay type, volts from min_volts up."""
    ring = _cx(rng, ch, p.attack_buffsize, scale=0.1)
    u = lambda lo, hi: T(rng.uniform(lo, hi, ch).astype(np.float32))  # noqa
    ri = lambda hi: T(rng.integers(0, hi, ch).astype(np.int32))  # noqa
    return tagc.AGCState(T(ring), T(np.abs(ring)), u(p.min_volts, 1.5),
                         u(0.0, 1.5), u(0.0, 0.5), u(0.0, 0.1), ri(300),
                         ri(2), ri(5))


def _agc_stream(rng, ch, n, blocks, mode=2):
    """K5's inputs for `blocks` pieces of n samples: the AGC params, a
    random carry and, per piece, the time-major ring-max and |out|
    streams as agc_apply forms them."""
    p = tagc.agc_params(mode)
    st = _agc_rand_state(rng, p, ch)
    pieces = []
    for b in range(blocks):
        x = T(_cx(rng, ch, n, scale=_AGC_LEVELS[b % 4]))
        full = torch.cat([st.ring, x], dim=-1)
        abs_full = torch.cat([st.abs_ring, x.abs()], dim=-1)
        rm = tagc._sliding_window_max(abs_full, p.attack_buffsize)[
            ..., 1: 1 + n]
        pieces.append((rm.T.contiguous(), abs_full[..., :n].T.contiguous()))
        st = st._replace(ring=full[..., n:], abs_ring=abs_full[..., n:])
    carry = (st.volts, st.save_volts, st.fast_backaverage,
             st.hang_backaverage, st.hang_counter, st.decay_type, st.state)
    return p, carry, pieces


def _sam_y(rng, ch, b):
    """Block b of an AM carrier at 120 Hz with per-channel levels and
    light noise (tests/test_pallas_kernels.py's SAM stimulus)."""
    t = (np.arange(256) + 256 * b) / 24000.0
    y = np.exp(2j * np.pi * 120.0 * t) * (1.0 + 0.4 * np.cos(
        2 * np.pi * 400.0 * t)) * np.linspace(0.5, 1.0, ch)[:, None]
    return (y + _cx(rng, ch, 256, scale=0.01)).astype(np.complex64)


def _audio(rng, ch, scale=0.2):
    return (rng.standard_normal((ch, 256)) * scale).astype(np.float32)


def _lidx0(ch):
    """Leak indices alternating 120 and 200: the two fixed points of the
    lidx quirk (clamped at the minimum; pinned at the maximum), so both
    branches run.  Between them every step of lidx hangs on nev < nel,
    whose two sides differ by ~two_mu * ngamma * y, below one float32
    ulp: there the count of steps follows rounding, not the algorithm."""
    return np.where(np.arange(ch) % 2 == 0, 120.0, 200.0).astype(np.float32)


@pytest.mark.parametrize("ch", [5, 130])
@pytest.mark.parametrize("fmt", ["c64", "q15"])
@pytest.mark.parametrize("zoom", [None, 0])
def test_frontend_plain_matches_pallas(jx, zoom, fmt, ch):
    rng = np.random.default_rng(21)
    jnp = jx.jnp
    jf, tf = _front(jx.Front, zoom), _front(TFront, zoom)
    tp = _params(ch)
    jp = tp._replace(**{f: jnp.asarray(getattr(tp, f).numpy())
                        for f in tp._fields})
    js = jf.init_state((ch,))
    ts = tuple(T(a.copy()) for a in js)
    for _ in range(BLOCKS):
        x = _cx(rng, ch, 2048, scale=0.3)
        if fmt == "q15":
            jin = tuple(map(jnp.asarray, _q15(x)))
            tx = tuple(map(T, _q15(x)))
        else:
            jin, tx = jnp.asarray(x), T(x)
        jo, to = jf.block(jp, js, jin), tf.block(tp, ts, tx)
        js, ts = jo[0], to[0]
        _close(to[1], jo[1], 2e-4, 2e-5, "x")
        if zoom == 0:
            _close(to[2], jo[2], 2e-4, 2e-5, "seg")
        _state_close(ts, js)


@pytest.mark.parametrize("ch", [5, 130])
def test_agc_block_plain_matches_pallas(jx, ch):
    rng = np.random.default_rng(22)
    jnp = jx.jnp
    p = jx.agc.agc_params(2)
    js = jx.jax.tree.map(jnp.asarray, jx.agc.agc_state(p, (ch,)))
    ts = tagc.agc_state(p, (ch,))
    for b in range(BLOCKS):
        x = _cx(rng, ch, 256, scale=(0.02, 0.5, 0.005)[b])
        js, jy = jx.agc_block(p, js, jnp.asarray(x), interpret=True)
        ts, ty = tk_agc.agc_block(p, ts, T(x))
        _close(ty, jy, 1e-6, 1e-7, "y")
        for f in ts._fields:
            if f in ("hang_counter", "decay_type", "state"):
                np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                              np.asarray(getattr(js, f)), f)
            else:
                _close(getattr(ts, f), getattr(js, f), 1e-6, 1e-7, f)


@pytest.mark.parametrize("ch", [5, 130])
def test_interp_plain_matches_pallas(jx, ch):
    rng = np.random.default_rng(23)
    jnp = jx.jnp
    jfi = jx.Interp(CHAIN.hi1, CHAIN.hi2)
    tfi = TInterp(CHAIN.hi1, CHAIN.hi2)
    vol = np.linspace(0.5, 2.0, ch).astype(np.float32)
    j1 = np.zeros((ch, tfi.sub1 - 1), np.float32)
    j2 = np.zeros((ch, tfi.sub2 - 1), np.float32)
    t1, t2 = T(j1.copy()), T(j2.copy())
    apply = jx.jax.jit(jfi.apply)
    for _ in range(BLOCKS):
        a = rng.standard_normal((ch, 256)).astype(np.float32) * 0.4
        j1, j2, jy = apply(jnp.asarray(a), j1, j2, jnp.asarray(vol))
        t1, t2, ty = tfi.apply(T(a), t1, t2, T(vol))
        _close(ty, jy, 2e-5, 2e-6, "y")
        _close(t1, j1, 0.0, 0.0, "int1")
        _close(t2, j2, 2e-5, 2e-6, "int2")


def test_interp_cpu_branch_takes_a_strided_real_row():
    """On the CPU, K3's wrapper gives the same for the chain's `y.real`
    (element stride 2) as for a contiguous copy of it."""
    rng = np.random.default_rng(29)
    tfi = TInterp(CHAIN.hi1, CHAIN.hi2)
    ch = 5
    vol = T(rng.uniform(0.5, 2.0, ch).astype(np.float32))
    h = (T(rng.standard_normal((ch, 23)).astype(np.float32)),
         T(rng.standard_normal((ch, 7)).astype(np.float32)))
    for n in (1, 7, 256):
        a = _interp_audio(rng, ch, n, "real")
        assert a.stride(-1) == 2
        got = tfi.apply(a, *h, vol)
        ref = tfi.apply(a.contiguous(), *h, vol)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


@pytest.mark.parametrize("form", ["contiguous", "real", "batched real",
                                  "every third"])
def test_interp_launch_passes_rows_as_they_lie(monkeypatch, form):
    """K3's launch arguments, through an emulation of its C entry point
    that reads the audio at the (pitch, step) it is given: a contiguous
    row and `y.real` (leading dims too) go to the kernel as they lie, a
    stride it does not take is copied first; the result is the plain
    version's."""
    import ctypes
    rng = np.random.default_rng(30)
    tfi = TInterp(CHAIN.hi1, CHAIN.hi2)
    lead, n = ((2, 3) if form == "batched real" else (4,)), 19
    z = T(_cx(rng, *lead, 3 * n, scale=0.4))
    a = {"contiguous": z.real[..., :n].contiguous(),
         "real": z.real[..., :n], "batched real": z.real[..., :n],
         "every third": z.real[..., ::3]}[form]
    h1 = T(rng.standard_normal(lead + (23,)).astype(np.float32))
    h2 = T(rng.standard_normal(lead + (7,)).astype(np.float32))
    vol = T(rng.uniform(0.5, 2.0, lead).astype(np.float32))
    seen = {}

    def view(t, count):
        # a tensor argument: its data pointer, as the C entry point gets it
        ptr = t.data_ptr() if isinstance(t, torch.Tensor) else t
        return np.ctypeslib.as_array((ctypes.c_float * count).from_address(
            ptr))

    def fake_launch(name, argtypes, device, audio, pitch, step, i1, i2, v,
                    hp1, hp2, sub1, sub2, channels, nn, y, n1, n2):
        assert name == "t41x_interp" and len(argtypes) == 16
        assert device == a.device
        assert (sub1, sub2, nn) == (24, 8, n)
        seen.update(pitch=pitch, step=step, channels=channels)
        rows = np.stack([view(audio.data_ptr() + 4 * c * pitch,
                              (n - 1) * step + 1)
                         [::step] for c in range(channels)])
        ref = tfi.plain(T(rows.copy()), T(view(i1, channels * 23).reshape(
            channels, 23).copy()), T(view(i2, channels * 7).reshape(
                channels, 7).copy()), T(view(v, channels).copy()))
        for ptr, r in zip((n1, n2, y), ref):
            view(ptr, r.numel())[:] = r.numpy().ravel()

    monkeypatch.setattr(_build, "launch", fake_launch)
    n0 = TInterp.launches
    got = tfi._launch(a, h1, h2, vol)
    ref = tfi.plain(a, h1, h2, vol)
    assert TInterp.launches == n0 + 1
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g, r)
    want = {"contiguous": (n, 1), "real": (6 * n, 2),
            "batched real": (6 * n, 2), "every third": (n, 1)}[form]
    assert (seen["pitch"], seen["step"]) == want
    assert seen["channels"] == math.prod(lead)


@pytest.mark.parametrize("ch", [5, 130])
def test_os_filter_plain_matches_pallas(jx, ch):
    rng = np.random.default_rng(24)
    jnp = jx.jnp
    W = CHAIN.os_W
    js = jnp.zeros((ch, 256), jnp.complex64)
    ts = torch.zeros(ch, 256, dtype=torch.complex64)
    for _ in range(BLOCKS):
        x = _cx(rng, ch, 256, scale=0.3)
        js, jy = jx.os_filter(js, jnp.asarray(x), jnp.asarray(W),
                              interpret=True)
        ts, ty = tk_os.os_filter_matmul_kernel(ts, T(x), T(W))
        _close(ty, jy, 2e-3, 2e-4, "y")
        _close(ts, js, 0.0, 0.0, "state")


@pytest.mark.parametrize("ch", [5, 130])
def test_sam_plain_matches_pallas(jx, ch):
    rng = np.random.default_rng(26)
    jnp = jx.jnp
    p = tsam.sam_params()
    js = tuple(jnp.zeros(ch, jnp.float32) for _ in range(5))
    from t41x.demod.sam import SAMState as JSAMState
    js, ts = JSAMState(*js), tsam.sam_state((ch,))
    for b in range(BLOCKS):
        y = _sam_y(rng, ch, b)
        js, ja = jx.sam_block(p, js, jnp.asarray(y), interpret=True)
        ts, ta = tk_sam.sam_block(p, ts, T(y))
        _close(ta, ja, 1e-4, 1e-5, f"audio block {b}")
        for f in ts._fields:
            _close(getattr(ts, f), getattr(js, f), 1e-4, 1e-5, f)


@pytest.mark.parametrize("ch", [5, 130])
@pytest.mark.parametrize("notch", [False, True])
def test_xanr_plain_matches_pallas(jx, notch, ch):
    rng = np.random.default_rng(27)
    jnp = jx.jnp
    p = tnr.XanrParams(notch=notch)
    ts = tnr.xanr_state(p, (ch,))._replace(lidx=T(_lidx0(ch)))
    js = jx.jax.tree.map(lambda t: jnp.asarray(t.numpy()), ts)
    for b in range(BLOCKS):
        x = _audio(rng, ch)
        js, jy = jx.xanr_block(p, js, jnp.asarray(x), interpret=True)
        ts, ty = tk_xanr.xanr_block(p, ts, T(x))
        _close(ty, jy, 1e-4, 1e-5, f"y block {b}")
        for f in ts._fields:
            _close(getattr(ts, f), getattr(js, f), 1e-4, 1e-5, f)


@pytest.mark.parametrize("ch", [5, 130])
def test_kim_gains_plain_matches_pallas(jx, ch):
    """Two hops per block over 9 blocks, past the 15-slot ring wrap."""
    rng = np.random.default_rng(28)
    jnp = jx.jnp
    p = tnr.kim_params(200.0, 3000.0)
    tst = tnr.kim_state((ch,))
    tg = (tst.X, tst.E, tst.Gts, tst.idx)
    jg = tuple(jnp.asarray(t.numpy()) for t in tg)
    for b in range(9):
        pw = (rng.random((2, ch, 128)) * (1.0 + 9.0 * (b % 3))
              ).astype(np.float32)
        jg, jgain = jx.kim_gains(p, jg, jnp.asarray(pw), interpret=True)
        tg, tgain = tk_nr.kim_gains(p, tg, T(pw))
        # XLA's CPU code rounds some products and sums differently (1-ulp
        # steps, grown where 1 - lam / E cancels): the tolerance of
        # tests/test_pallas_kernels.py's kernel-vs-XLA check
        _close(tgain, jgain, 1e-5, 1e-6, f"gains block {b}")
        for a, r in zip(tg, jg):
            _close(a, r, 1e-5, 1e-6, f"state block {b}")


def test_wrappers_take_plain_version_on_cpu():
    """CPU tensors never reach the CUDA library: no build, no launch."""
    counts = (TFront.launches, tk_agc.agc_block.launches,
              tk_agc.agc_scan.launches,
              TInterp.launches, tk_os.os_filter_matmul_kernel.launches,
              tk_sam.sam_block.launches, tk_xanr.xanr_block.launches,
              tk_nr.kim_gains.launches)
    rng = np.random.default_rng(25)
    tp = _params(2)
    for zoom in (0, 2):
        tf = _front(TFront, zoom)
        tf.block(tp, tf.init_state((2,)), T(_cx(rng, 2, 2048)),
                 _zoom_state(zoom, 2) if zoom else None)
    p = tagc.agc_params(2)
    tk_agc.agc_block(p, tagc.agc_state(p, (2,)), T(_cx(rng, 2, 256)))
    tagc.agc_apply(p, tagc.agc_state(p, (2,)), T(_cx(rng, 2, 64)),
                   use_kernels=True)
    tfi = TInterp(CHAIN.hi1, CHAIN.hi2)
    tfi.apply(torch.zeros(2, 256), torch.zeros(2, tfi.sub1 - 1),
              torch.zeros(2, tfi.sub2 - 1), torch.ones(2))
    tk_os.os_filter_matmul_kernel(tosf.os_state((2,)), T(_cx(rng, 2, 256)),
                                  T(CHAIN.os_W))
    tk_sam.sam_block(tsam.sam_params(), tsam.sam_state((2,)),
                     T(_cx(rng, 2, 256)))
    xp = tnr.XanrParams()
    tk_xanr.xanr_block(xp, tnr.xanr_state(xp, (2,)), T(_audio(rng, 2)))
    ks = tnr.kim_state((2,))
    tk_nr.kim_gains(tnr.kim_params(), (ks.X, ks.E, ks.Gts, ks.idx),
                    torch.ones(2, 2, 128))
    assert counts == (TFront.launches, tk_agc.agc_block.launches,
                      tk_agc.agc_scan.launches, TInterp.launches, tk_os.os_filter_matmul_kernel.launches,
                      tk_sam.sam_block.launches, tk_xanr.xanr_block.launches,
                      tk_nr.kim_gains.launches)
    assert _build._lib is None
    with pytest.raises(ValueError, match="attack_buffsize"):
        tk_agc.agc_block(p, tagc.agc_state(p, (2,)), torch.zeros(
            2, 64, dtype=torch.complex64))


# ---- on the card: each CUDA kernel against its plain version -------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [130, 1000])
@pytest.mark.parametrize("fmt", ["c64", "q15"])
@pytest.mark.parametrize("zoom", [None, 0])
def test_frontend_kernel_matches_plain_on_card(cuda, zoom, fmt, ch):
    rng = np.random.default_rng(31)
    tf = _front(TFront, zoom)
    tp = _params(ch, cuda)
    sk = sp = tf.init_state((ch,), cuda)
    n0 = TFront.launches
    for _ in range(BLOCKS):
        x = _cx(rng, ch, 2048, scale=0.3)
        tx = (tuple(T(a).to(cuda) for a in _q15(x)) if fmt == "q15"
              else T(x).to(cuda))
        ok, op = tf.block(tp, sk, tx), tf.plain(tp, sp, tx)
        sk, sp = ok[0], op[0]
        _close(ok[1], op[1].cpu(), 2e-4, 2e-5, "x")
        if zoom == 0:
            _close(ok[2], op[2].cpu(), 2e-4, 2e-5, "seg")
        _state_close([s.cpu() for s in sk], [s.cpu() for s in sp])
    assert TFront.launches == n0 + BLOCKS


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [130, 1000])
@pytest.mark.parametrize("fmt", ["c64", "q15"])
@pytest.mark.parametrize("zoom", [1, 3, 7])
def test_frontend_zoom_kernel_matches_plain_on_card(cuda, zoom, fmt, ch):
    """K1z: the composed zoom tap in the kernel against the per-stage
    plain version, state carried over the blocks."""
    rng = np.random.default_rng(38)
    tf = _front(TFront, zoom)
    tp = _params(ch, cuda)
    sk = sp = tf.init_state((ch,), cuda)
    zk = zp = _zoom_state(zoom, ch, cuda)
    n0 = TFront.launches
    for _ in range(BLOCKS):
        x = _cx(rng, ch, 2048, scale=0.3)
        tx = (tuple(T(a).to(cuda) for a in _q15(x)) if fmt == "q15"
              else T(x).to(cuda))
        ok, op = tf.block(tp, sk, tx, zk), tf.plain(tp, sp, tx, zp)
        sk, sp, zk, zp = ok[0], op[0], ok[3:], op[3:]
        _close(ok[1], op[1].cpu(), 2e-4, 2e-5, "x")
        _state_close(ok[2].cpu(), op[2].cpu(), "zoom stream")
        _state_close([s.cpu() for s in sk], [s.cpu() for s in sp])
        _state_close([s.cpu() for s in zk], [s.cpu() for s in zp],
                     "zoom state")
    assert TFront.launches == n0 + BLOCKS


def _equal(got, ref, msg=""):
    """Bit for bit (K2, K5, K6 and K7 round every operation as their
    plain versions do)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, msg
    assert torch.equal(got, ref), (
        f"{msg}: max |d| {float((got - ref).abs().max())}")


# ragged around K2's and K5's 8 channels per thread block
AGC_CHANNELS = [1, 7, 130, 1024]


@pytest.mark.gpu
@pytest.mark.parametrize("ch", AGC_CHANNELS)
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_agc_scan_kernel_matches_plain_on_card(cuda, mode, ch):
    """K5 at piece lengths 1, 64 and 95 (agc_apply sends it blocks
    shorter than the 96-sample delay line), from random states."""
    rng = np.random.default_rng(39 + mode)
    for n in (1, 64, 95):
        p, carry, pieces = _agc_stream(rng, ch, n, 4, mode)
        ck = cp = tuple(c.to(cuda) for c in carry)
        n0 = tk_agc.agc_scan.launches
        for rm, ao in pieces:
            rm, ao = rm.to(cuda), ao.to(cuda)
            ck, vk = tk_agc.agc_scan(p, ck, rm, ao)
            cp, vp = tk_agc.agc_scan_plain(p, cp, rm, ao)
            _equal(vk, vp, f"volts n {n}")
            for i, (a, r) in enumerate(zip(ck, cp)):
                _equal(a, r, f"carry[{i}] n {n}")
        assert tk_agc.agc_scan.launches == n0 + len(pieces)


@pytest.mark.gpu
@pytest.mark.parametrize("ch", AGC_CHANNELS)
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_agc_kernel_matches_plain_on_card(cuda, mode, ch):
    """K2 from random states, bit for bit: y, the seven states, and the
    new delay line (x's newest 96 samples) with its magnitudes, which
    the kernel writes itself."""
    rng = np.random.default_rng(32 + mode)
    p = tagc.agc_params(mode)
    b = p.attack_buffsize
    sk = sp = tagc.AGCState(*(t.to(cuda)
                              for t in _agc_rand_state(rng, p, ch)))
    n0 = tk_agc.agc_block.launches
    for blk in range(BLOCKS):
        x = T(_cx(rng, ch, 256, scale=_AGC_LEVELS[blk])).to(cuda)
        sk, yk = tk_agc.agc_block(p, sk, x)
        sp, yp = tk_agc.agc_block_plain(p, sp, x)
        _equal(yk, yp, "y")
        for f in sp._fields:
            _equal(getattr(sk, f), getattr(sp, f), f)
        _equal(sk.ring, x[..., -b:], "ring")
        _equal(sk.abs_ring, sk.ring.abs(), "abs_ring")
    assert tk_agc.agc_block.launches == n0 + BLOCKS


def _interp_audio(rng, ch, n, form, device="cpu"):
    """A block of audio as the chain hands it to K3: the real part of a
    complex64 block (`y.real`, element stride 2), or a contiguous row."""
    z = T(_cx(rng, ch, n, scale=0.4)).to(device)
    return z.real if form == "real" else z.real.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["contiguous", "real"])
@pytest.mark.parametrize("n", [1, 7, 256, 1000])
@pytest.mark.parametrize("ch", [1, 7, 130, 1024])
def test_interp_kernel_matches_plain_on_card(cuda, ch, n, form):
    """K3 bit for bit (each output an fmaf chain from 0 over its taps,
    oldest sample first, as cuDNN's convolutions sum with TF32 off): y
    and both histories, from random histories, one launch a block, over
    blocks shorter than the x2 history and longer than a segment."""
    rng = np.random.default_rng(33)
    tfi = TInterp(CHAIN.hi1, CHAIN.hi2)
    vol = T(rng.uniform(0.5, 2.0, ch).astype(np.float32)).to(cuda)
    hk = hp = (T(rng.standard_normal((ch, tfi.sub1 - 1)).astype(
        np.float32)).to(cuda), T(rng.standard_normal(
            (ch, tfi.sub2 - 1)).astype(np.float32)).to(cuda))
    n0 = TInterp.launches
    for b in range(BLOCKS):
        a = _interp_audio(rng, ch, n, form, cuda)
        *hk, yk = tfi.apply(a, *hk, vol)
        *hp, yp = tfi.plain(a, *hp, vol)
        _equal(yk, yp, f"y block {b}")
        _equal(hk[0], hp[0], f"int1 block {b}")
        _equal(hk[1], hp[1], f"int2 block {b}")
    assert TInterp.launches == n0 + BLOCKS


@pytest.mark.gpu
def test_interp_kernel_raises_on_other_taps(cuda):
    """K3 is built for the chain's 48 x2 and 32 x4 taps: other designs
    raise on the card (the plain version takes any)."""
    a = torch.zeros(2, 256, device=cuda)
    for h1, h2 in ((np.ones(40, np.float32), CHAIN.hi2),
                   (CHAIN.hi1, np.ones(36, np.float32))):
        tfi = TInterp(h1, h2)
        z1 = torch.zeros(2, tfi.sub1 - 1, device=cuda)
        z2 = torch.zeros(2, tfi.sub2 - 1, device=cuda)
        n0 = TInterp.launches
        with pytest.raises(ValueError, match="48 x2 taps and 32 x4 taps"):
            tfi.apply(a, z1, z2, torch.ones(2, device=cuda))
        assert TInterp.launches == n0
        tfi.plain(a, z1, z2, torch.ones(2, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [130, 1000])
def test_os_filter_kernel_matches_plain_on_card(cuda, ch):
    rng = np.random.default_rng(34)
    W = T(CHAIN.os_W).to(cuda)
    sk = sp = tosf.os_state((ch,), device=cuda)
    n0 = tk_os.os_filter_matmul_kernel.launches
    for _ in range(BLOCKS):
        x = T(_cx(rng, ch, 256, scale=0.3)).to(cuda)
        sk, yk = tk_os.os_filter_matmul_kernel(sk, x, W)
        sp, yp = tosf.os_filter_matmul(sp, x, W)
        _close(yk, yp.cpu(), 2e-3, 2e-4, "y")
        _close(sk, sp.cpu(), 0.0, 0.0, "state")
    assert tk_os.os_filter_matmul_kernel.launches == n0 + BLOCKS


@pytest.mark.gpu
def test_os_filter_kernel_follows_each_chains_passband(cuda):
    """Headless chains of other passbands, each built after the last is
    freed, filter through their own packed W: K4 on each chain's path
    against the plain version with that chain's W."""
    rng = np.random.default_rng(35)
    ch = 130
    last = None
    for f_lo, f_hi in ((200.0, 3000.0), (500.0, 1500.0), (200.0, 2400.0)):
        chain = RxChain(ChainSpec(f_lo=f_lo, f_hi=f_hi, spectrum_taps=False),
                        device=cuda)
        W = chain.tensors["os_W"]
        sk = sp = tosf.os_state((ch,), device=cuda)
        for _ in range(BLOCKS):
            x = T(_cx(rng, ch, 256, scale=0.3)).to(cuda)
            sk, yk, _ = chain._os_filter(sk, x)
            sp, yp = tosf.os_filter_matmul(sp, x, W)
            _close(yk, yp.cpu(), 2e-3, 2e-4, f"y {f_lo}-{f_hi} Hz")
        if last is not None:
            assert not torch.equal(W, last)
        last = W.clone()
        del chain, W


# ragged around K6's and K7's 8 channels per thread block
SERIAL_CHANNELS = [1, 7, 33, 130, 1024]


def _sam_rand_state(rng, p, ch):
    """Phases outside [0, 2 pi), omega2 inside and at both clips."""
    u = lambda lo, hi: rng.uniform(lo, hi, ch).astype(np.float32)  # noqa
    om2 = u(p.omega_min, p.omega_max)
    om2[::3], om2[1::3] = p.omega_max, p.omega_min
    return tsam.SAMState(*map(T, (u(-8.0, 20.0), u(-1.0, 1.0), om2,
                                  u(-0.5, 0.5), u(0.0, 1.0))))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [64, 256, tk_sam._MAX_N])
@pytest.mark.parametrize("fade", [0, 1])
@pytest.mark.parametrize("ch", SERIAL_CHANNELS)
def test_sam_kernel_matches_plain_on_card(cuda, ch, fade, n):
    """K6 bit for bit from random carried states, n up to the largest
    block its shared memory holds."""
    rng = np.random.default_rng(35)
    p = tsam.sam_params(fade_leveler=fade)
    sk = sp = tsam.SAMState(*(t.to(cuda)
                              for t in _sam_rand_state(rng, p, ch)))
    n0 = tk_sam.sam_block.launches
    for b in range(BLOCKS):
        t = (np.arange(n) + n * b) / 24000.0
        y = np.exp(2j * np.pi * 120.0 * t) * (1.0 + 0.4 * np.cos(
            2 * np.pi * 400.0 * t)) * np.linspace(0.5, 1.0, ch)[:, None]
        y = T((y + _cx(rng, ch, n, scale=0.01)).astype(np.complex64)).to(
            cuda)
        sk, ak = tk_sam.sam_block(p, sk, y)
        sp, ap = tk_sam.sam_block_plain(p, sp, y)
        _equal(ak, ap, "audio")
        for f in sp._fields:
            _equal(getattr(sk, f), getattr(sp, f), f)
    assert tk_sam.sam_block.launches == n0 + BLOCKS


@pytest.mark.gpu
def test_sam_kernel_wide_pll_range_on_card(cuda):
    """A PLL range past Nyquist (omega up to 7.85 rad a sample): from
    omega2 at its clips, phase + fil passes 4 pi and the kernel takes its
    fmodf path; still bit for bit."""
    rng = np.random.default_rng(44)
    ch, n = 130, 256
    p = tsam.sam_params(omega_n=3000.0, pll_fmax=30000.0)
    sk = sp = tsam.SAMState(*(t.to(cuda) for t in _sam_rand_state(
        rng, p, ch)))._replace(fil_out=torch.full((ch,), 7.0, device=cuda))
    for _ in range(BLOCKS):
        y = T(_cx(rng, ch, n)).to(cuda)
        sk, ak = tk_sam.sam_block(p, sk, y)
        sp, ap = tk_sam.sam_block_plain(p, sp, y)
        _equal(ak, ap, "audio")
        for f in sp._fields:
            _equal(getattr(sk, f), getattr(sp, f), f)


@pytest.mark.gpu
def test_sam_loop_ops_match_torch_on_card(cuda):
    """K6's phase loop forms sin, cos and the detector's quotient without
    a branch: sin and cos equal torch.sin and torch.cos for every float
    in [0, 2 pi], and the quotient torch's division for 0 <= a <= b over
    2^28 random pairs whose exponents span the fast range and beyond
    (zeros, subnormals, equal operands among them)."""
    top = int(np.float32(tsam._TWO_PI).view(np.int32))
    chunk = 1 << 26
    gen = torch.Generator(device=cuda).manual_seed(45)
    for lo in range(0, top + 1, chunk):
        x = torch.arange(lo, min(lo + chunk, top + 1), dtype=torch.int32,
                         device=cuda).view(torch.float32)
        n = x.numel()
        b = torch.exp2(torch.empty(n, device=cuda).uniform_(
            -126.0, 127.0, generator=gen)).clamp_(max=3e38)
        a = b * torch.rand(n, generator=gen, device=cuda)
        a[::97] = 0.0
        a[1::97] = b[1::97]
        a[2::97] = torch.rand(a[2::97].shape, generator=gen,
                              device=cuda) * 1e-39
        s, c, q = tk_sam.loop_ops(x, a, b)
        _equal(s, torch.sin(x), f"sin from {lo:#x}")
        _equal(c, torch.cos(x), f"cos from {lo:#x}")
        _equal(q, a / b, f"quotient, chunk from {lo:#x}")


@pytest.mark.gpu
@pytest.mark.parametrize("notch", [False, True])
@pytest.mark.parametrize("ch", SERIAL_CHANNELS)
def test_xanr_kernel_matches_plain_on_card(cuda, ch, notch):
    """K7 bit for bit (it sums in torch.sum's order on the card), from
    random weights and history, the leak index at its fixed points."""
    rng = np.random.default_rng(36)
    p = tnr.XanrParams(notch=notch)
    sk = sp = tnr.xanr_state(p, (ch,), cuda)._replace(
        lidx=T(_lidx0(ch)).to(cuda),
        w=T((rng.standard_normal((ch, 64)) * 0.01).astype(np.float32)).to(
            cuda),
        dline=T(_audio(rng, ch)[:, :80]).to(cuda))
    n0 = tk_xanr.xanr_block.launches
    for b in range(BLOCKS):
        x = T(_audio(rng, ch)).to(cuda)
        sk, yk = tk_xanr.xanr_block(p, sk, x)
        sp, yp = tk_xanr.xanr_block_plain(p, sp, x)
        _equal(yk, yp, "y")
        for f in sp._fields:
            _equal(getattr(sk, f), getattr(sp, f), f)
    assert tk_xanr.xanr_block.launches == n0 + BLOCKS


@pytest.mark.gpu
def test_kim_gains_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(37)
    ch = 130
    p = tnr.kim_params(200.0, 3000.0)
    st = tnr.kim_state((ch,), cuda)
    gk = gp = (st.X, st.E, st.Gts, st.idx)
    for b in range(9):
        pw = T((rng.random((2, ch, 128)) * (1.0 + 9.0 * (b % 3))
                ).astype(np.float32)).to(cuda)
        gk, yk = tk_nr.kim_gains(p, gk, pw)
        gp, yp = tk_nr.kim_gains_plain(p, gp, pw)
        _close(yk, yp.cpu(), 0.0, 0.0, "gains")
        for a, r in zip(gk, gp):
            _close(a, r.cpu(), 0.0, 0.0, "state")
