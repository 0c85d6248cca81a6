"""t41x_torch's demodulators against t41x's on the same numpy-seeded
inputs, streamed over 3 blocks with the state carried: AM (alpha-max
beta-min detector + the DC/low-pass cascade), NFM (the discriminator
with its 1e-20 power floor and [-1, 1] limiter), and the SAM PLL (plain
per-sample loop against t41x's scan, kernel path against the Pallas
kernel in interpret mode) at rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x.chain import ChainSpec as JSpec, RxChain as JChain
from t41x.demod import am as jam, nfm as jnfm, sam as jsam, ssb as jssb
from t41x_torch.demod import am as tam, nfm as tnfm, sam as tsam
from t41x_torch.demod import ssb as tssb
from t41x_torch.dsp import iir as tiir

torch.set_num_threads(1)

N, BLOCKS = 256, 3
T = torch.from_numpy


def _cx(rng, *shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _sam_blocks(ch, seed=13):
    """tests/test_pallas_kernels.py's SAM stimulus: a 120 Hz carrier,
    AM at 400 Hz, levels per channel, light noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(BLOCKS * N) / 24000.0
    carrier = np.exp(2j * np.pi * 120.0 * t) * (
        1.0 + 0.4 * np.cos(2 * np.pi * 400.0 * t))
    y = (carrier[None] * (0.5 + 0.5 * rng.random((ch, 1)))
         + 0.01 * (rng.standard_normal((ch, t.size))
                   + 1j * rng.standard_normal((ch, t.size)))
         ).astype(np.complex64)
    return np.split(y, BLOCKS, axis=-1)


def test_alpha_beta_mag_matches():
    rng = np.random.default_rng(1)
    i, q = (rng.standard_normal((4, N)).astype(np.float32) for _ in range(2))
    np.testing.assert_array_equal(
        tam.alpha_beta_mag(T(i), T(q)).numpy(),
        np.asarray(jam.alpha_beta_mag(jnp.asarray(i), jnp.asarray(q))))


def test_ssb_demod_matches():
    y = _cx(np.random.default_rng(9), 4, N)
    np.testing.assert_array_equal(tssb.ssb_demod(T(y)).numpy(),
                                  np.asarray(jssb.ssb_demod(jnp.asarray(y))))


@pytest.mark.parametrize("f_hi", [3000.0, 5000.0])
def test_am_demod_matches(f_hi):
    jc = JChain(JSpec(mode="am", f_hi=f_hi))
    top = tiir.BiquadChunked(*tam.am_post_cascade(jc.am_b[0], jc.am_a[0]),
                             chunk=64)
    rng = np.random.default_rng(2)
    js = np.zeros((5, 2, 2), np.float32)
    ts = T(js.copy())
    for _ in range(BLOCKS):
        y = _cx(rng, 5, N, scale=0.3)
        js, ja = jam.am_demod(js, jnp.asarray(y), jc.am_op)
        ts, ta = tam.am_demod(ts, T(y), top)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                                   atol=1e-6)


def test_nfm_demod_matches():
    rng = np.random.default_rng(3)
    jl = np.zeros(5, np.complex64)
    tl = T(jl.copy())
    for b in range(BLOCKS):
        z = _cx(rng, 5, N, scale=0.2)
        z[0, 10:20] = 0.0            # the 1e-20 power floor
        z[1, 30] = 1e-4 * (1 + 1j)   # a large swing into the limiter
        jl, ja = jnfm.nfm_demod(jnp.asarray(jl), jnp.asarray(z))
        tl, ta = tnfm.nfm_demod(tl, T(z))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5,
                                   atol=1e-6, err_msg=f"block {b}")
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert float(ta.abs().max()) <= 1.0


@pytest.mark.parametrize("channels", [(), (5,), (2, 3)])
def test_nfm_state_matches(channels):
    """`nfm_state`, exported by the package as t41x's is, equals t41x's
    bit for bit: zeros of the channel shape, complex64."""
    from t41x.demod import nfm_state as j_state
    from t41x_torch.demod import nfm_state as t_state

    got, ref = t_state(channels), j_state(channels)
    assert got.dtype == torch.complex64 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.numpy().dtype == ref.dtype and got.shape == ref.shape


def test_atan2_poly_matches():
    rng = np.random.default_rng(4)
    y = rng.standard_normal(4096).astype(np.float32)
    x = rng.standard_normal(4096).astype(np.float32)
    y[:8] = [0, 0, 1, -1, 0, 2, -2, 0]
    x[:8] = [1, -1, 0, 0, 0, 2, 2, -3]
    got = tsam.atan2_poly(T(y), T(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jsam.atan2_poly(jnp.asarray(y), jnp.asarray(x))),
        rtol=0, atol=2e-7)
    np.testing.assert_allclose(got, np.arctan2(y, x), rtol=0, atol=5e-7)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("fade", [1, 0])
def test_sam_demod_matches(fade, kernels):
    ch = 6
    p = jsam.sam_params(fade_leveler=fade)
    assert tsam.sam_params(fade_leveler=fade) == p
    js = jax.tree.map(jnp.asarray, jsam.sam_state((ch,)))
    ts = tsam.sam_state((ch,))
    for b, y in enumerate(_sam_blocks(ch)):
        js, ja, jc = jsam.sam_demod(p, js, jnp.asarray(y),
                                    use_pallas=kernels)
        ts, ta, tc = tsam.sam_demod(p, ts, T(y), use_kernels=kernels)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-4,
                                   atol=1e-5, err_msg=f"block {b}")
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-4,
                                   atol=1e-2, err_msg=f"block {b}")
        for f in js._fields:
            np.testing.assert_allclose(getattr(ts, f).numpy(),
                                       np.asarray(getattr(js, f)),
                                       rtol=1e-4, atol=1e-5, err_msg=f)
    assert type(ts) is tsam.SAMState
