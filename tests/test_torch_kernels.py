"""t41x_torch kernel modules vs the t41x Pallas kernels.

On the CPU each wrapper takes its plain torch version; those are held
against the JAX Pallas wrappers run in interpret mode (their default on
CPU), over 3 streamed blocks with state carried, at 5 channels and at
130 (not a multiple of any tile).  The `gpu` cases hold each CUDA
kernel against its plain version on the card and skip without one.
"""

import types

import numpy as np
import pytest
import torch

from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.chain import default_params as tparams
from t41x_torch.dsp import agc as tagc, osfilter as tosf
from t41x_torch.kernels import _build
from t41x_torch.kernels import agc as tk_agc
from t41x_torch.kernels import os_filter as tk_os
from t41x_torch.kernels.frontend import FusedFrontEnd as TFront
from t41x_torch.kernels.interp import FusedInterp as TInterp

torch.set_num_threads(1)

BLOCKS = 3
CHAIN = RxChain(ChainSpec())  # designs pinned equal to t41x's
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
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, agc=agc, os_filter=os_filter_matmul_pallas,
        agc_block=agc_block_pallas, Front=FusedFrontEnd, Interp=FusedInterp)


def _cx(rng, *shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _q15(x):
    def cv(a):
        return np.clip(np.round(a * 32768.0), -32768, 32767).astype(np.int16)
    return cv(x.real), cv(x.imag)


def _params(ch, device=None):
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
    return cls(CHAIN.h1, CHAIN.h2, CHAIN.dc_b[0], CHAIN.dc_a[0], zoom=zoom)


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


def test_wrappers_take_plain_version_on_cpu():
    """CPU tensors never reach the CUDA library: no build, no launch."""
    counts = (TFront.launches, tk_agc.agc_block.launches,
              TInterp.launches, tk_os.os_filter_matmul_kernel.launches)
    rng = np.random.default_rng(25)
    tf = _front(TFront, 0)
    tp = _params(2)
    tf.block(tp, tf.init_state((2,)), T(_cx(rng, 2, 2048)))
    p = tagc.agc_params(2)
    tk_agc.agc_block(p, tagc.agc_state(p, (2,)), T(_cx(rng, 2, 256)))
    tfi = TInterp(CHAIN.hi1, CHAIN.hi2)
    tfi.apply(torch.zeros(2, 256), torch.zeros(2, tfi.sub1 - 1),
              torch.zeros(2, tfi.sub2 - 1), torch.ones(2))
    tk_os.os_filter_matmul_kernel(tosf.os_state((2,)), T(_cx(rng, 2, 256)),
                                  T(CHAIN.os_W))
    assert counts == (TFront.launches, tk_agc.agc_block.launches,
                      TInterp.launches, tk_os.os_filter_matmul_kernel.launches)
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
@pytest.mark.parametrize("fmt", ["c64", "q15"])
@pytest.mark.parametrize("zoom", [None, 0])
def test_frontend_kernel_matches_plain_on_card(cuda, zoom, fmt):
    rng = np.random.default_rng(31)
    ch = 130
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
def test_agc_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(32)
    ch = 130
    p = tagc.agc_params(2)
    sk = sp = tagc.agc_state(p, (ch,), cuda)
    for b in range(BLOCKS):
        x = T(_cx(rng, ch, 256, scale=(0.02, 0.5, 0.005)[b])).to(cuda)
        sk, yk = tk_agc.agc_block(p, sk, x)
        sp, yp = tk_agc.agc_block_plain(p, sp, x)
        _close(yk, yp.cpu(), 1e-6, 1e-7, "y")
        for f in sp._fields:
            _close(getattr(sk, f), getattr(sp, f).cpu(), 1e-6, 1e-7, f)


@pytest.mark.gpu
def test_interp_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(33)
    ch = 130
    tfi = TInterp(CHAIN.hi1, CHAIN.hi2)
    vol = torch.linspace(0.5, 2.0, ch, device=cuda)
    hk = hp = (torch.zeros(ch, tfi.sub1 - 1, device=cuda),
               torch.zeros(ch, tfi.sub2 - 1, device=cuda))
    for _ in range(BLOCKS):
        a = T(rng.standard_normal((ch, 256)).astype(np.float32)).to(cuda)
        *hk, yk = tfi.apply(a, *hk, vol)
        *hp, yp = tfi.plain(a, *hp, vol)
        _close(yk, yp.cpu(), 2e-5, 2e-6, "y")
        _close(hk[1], hp[1].cpu(), 2e-5, 2e-6, "int2")


@pytest.mark.gpu
def test_os_filter_kernel_matches_plain_on_card(cuda):
    rng = np.random.default_rng(34)
    ch = 130
    W = T(CHAIN.os_W).to(cuda)
    sk = sp = tosf.os_state((ch,), device=cuda)
    for _ in range(BLOCKS):
        x = T(_cx(rng, ch, 256, scale=0.3)).to(cuda)
        sk, yk = tk_os.os_filter_matmul_kernel(sk, x, W)
        sp, yp = tosf.os_filter_matmul(sp, x, W)
        _close(yk, yp.cpu(), 2e-3, 2e-4, "y")
