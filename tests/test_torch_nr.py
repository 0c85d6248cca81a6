"""t41x_torch's noise reduction against t41x's on the same numpy-seeded
audio: Kim NR (the plain gain scan, and the K8 path whose plain version
runs on the CPU, against t41x's XLA and Pallas-interpret paths),
spectral NR,
both `*_batch` forms, and the LMS (NR and notch).  Kim and spectral NR
at rtol 2e-4 / atol 2e-5 and >= 55 dB over 9 and 12 blocks (past the
15-slot ring wrap and the 20-hop init phase); the LMS at rtol 1e-4 /
atol 1e-5 over 3 blocks (its trajectories drift apart over long
streams, tools/chipcheck.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x.dsp import nr as jnr
from t41x_torch.dsp import nr as tnr
from t41x_torch.utils import parity

torch.set_num_threads(1)

T = torch.from_numpy


def _audio(ch, blocks, seed):
    """Audio-rate noise plus a 700 Hz tone whose level changes between
    blocks, so the minimum statistics and the gains move."""
    rng = np.random.default_rng(seed)
    t = np.arange(blocks * 256) / 24000.0
    tone = np.sin(2 * np.pi * 700.0 * t) * (1.0 + (t > t[-1] / 2))
    x = 0.1 * tone + 0.2 * rng.standard_normal((ch, t.size))
    return np.split(x.astype(np.float32), blocks, axis=-1)


def _jstate(st):
    return jax.tree.map(jnp.asarray, st)


def _close_state(ts, js, rtol, atol):
    assert type(ts).__name__ == type(js).__name__
    for f in js._fields:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype, f
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, f)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f)


def _close_audio(got, ref, msg):
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=msg)
    assert parity.snr_db(ref, got) >= parity.AUDIO_SNR_MIN_DB, msg


@pytest.mark.parametrize("ch", [3, 5])
@pytest.mark.parametrize("kernels", [False, True])
def test_kim_nr_matches(kernels, ch):
    p = jnr.kim_params(200.0, 3000.0)
    assert tnr.kim_params(200.0, 3000.0) == p
    js, ts = _jstate(jnr.kim_state((ch,))), tnr.kim_state((ch,))
    for b, x in enumerate(_audio(ch, 9, seed=ch)):
        js, jy = jnr.kim_nr(p, js, jnp.asarray(x), use_pallas=kernels)
        ts, ty = tnr.kim_nr(p, ts, T(x), use_kernels=kernels)
        _close_audio(ty.numpy(), np.asarray(jy), f"block {b}")
    _close_state(ts, js, 2e-4, 2e-5)


@pytest.mark.parametrize("kernels", [False, True])
def test_kim_nr_batch_matches(kernels):
    ch, B = 4, 4
    p = jnr.kim_params(300.0, 2700.0)
    xs = np.stack(_audio(ch, 2 * B, seed=11))
    js, ts = _jstate(jnr.kim_state((ch,))), tnr.kim_state((ch,))
    seq = ts
    for half in (xs[:B], xs[B:]):           # two batches: ring carried
        js, jy = jnr.kim_nr_batch(p, js, jnp.asarray(half),
                                  use_pallas=kernels)
        ts, ty = tnr.kim_nr_batch(p, ts, T(half), use_kernels=kernels)
        _close_audio(ty.numpy(), np.asarray(jy), "batch")
        for b in range(B):                  # = B sequential kim_nr calls
            seq, sy = tnr.kim_nr(p, seq, T(half[b]), use_kernels=kernels)
            np.testing.assert_allclose(ty[b].numpy(), sy.numpy(),
                                       rtol=1e-5, atol=1e-6)
    _close_state(ts, js, 2e-4, 2e-5)
    for a, b in zip(ts, seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_spectral_nr_matches():
    ch = 4
    p = jnr.spectral_params(200.0, 3000.0)
    assert tnr.spectral_params(200.0, 3000.0) == p
    js, ts = _jstate(jnr.spectral_state((ch,))), tnr.spectral_state((ch,))
    for b, x in enumerate(_audio(ch, 12, seed=5)):  # 24 hops > 20 init
        js, jy = jnr.spectral_nr(p, js, jnp.asarray(x))
        ts, ty = tnr.spectral_nr(p, ts, T(x))
        _close_audio(ty.numpy(), np.asarray(jy), f"block {b}")
    assert int(ts.frames[0]) == 24
    _close_state(ts, js, 2e-4, 2e-5)


def test_spectral_nr_batch_matches():
    ch, B = 3, 6
    p = jnr.spectral_params(200.0, 3000.0)
    xs = np.stack(_audio(ch, 2 * B, seed=6))
    js, ts = _jstate(jnr.spectral_state((ch,))), tnr.spectral_state((ch,))
    seq = ts
    for half in (xs[:B], xs[B:]):
        js, jy = jnr.spectral_nr_batch(p, js, jnp.asarray(half))
        ts, ty = tnr.spectral_nr_batch(p, ts, T(half))
        _close_audio(ty.numpy(), np.asarray(jy), "batch")
        for b in range(B):
            seq, sy = tnr.spectral_nr(p, seq, T(half[b]))
            np.testing.assert_allclose(ty[b].numpy(), sy.numpy(),
                                       rtol=1e-5, atol=1e-6)
    _close_state(ts, js, 2e-4, 2e-5)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("notch", [False, True])
def test_xanr_matches(notch, kernels):
    ch = 5
    p = jnr.XanrParams(notch=notch)
    # leak indices off the 120 start, so every branch of the quirk runs
    lidx0 = np.asarray([120.0, 150.0, 199.0, 200.0, 170.0], np.float32)
    js = _jstate(jnr.xanr_state(p, (ch,))._replace(lidx=lidx0))
    ts = tnr.xanr_state(p, (ch,))._replace(lidx=T(lidx0.copy()))
    for b, x in enumerate(_audio(ch, 3, seed=7)):
        js, jy = jnr.xanr(p, js, jnp.asarray(x), use_pallas=kernels)
        ts, ty = tnr.xanr(p, ts, T(x), use_kernels=kernels)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-4,
                                   atol=1e-5, err_msg=f"block {b}")
    _close_state(ts, js, 1e-4, 1e-5)
    assert not np.array_equal(ts.lidx.numpy(), lidx0)
