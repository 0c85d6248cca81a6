"""t41x_torch's polyphase channelizer against t41x's, on the CPU.

The design arrays are t41x's NumPy code and must be bit-equal; a block's
channels and state agree at >= 100 dB SNR (both are float32; only the
2K-long product's summation order differs); the JAX tests' own checks
(tone routing, isolation > 50 dB, streaming continuity) hold for the
port; and channelizer -> the port's chain agrees with channelizer ->
t41x's chain at the North-star audio bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x.chain import ChainSpec as JSpec, RxChain as JChain
from t41x.mesh.channelizer import Channelizer as JChannelizer
from t41x_torch import constants as C
from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.io import signals
from t41x_torch.mesh.channelizer import Channelizer
from t41x_torch.utils import parity

torch.set_num_threads(2)
K = 8
CHANNELIZER_SNR_MIN_DB = 100.0


def wideband_tone(freq_hz: float, n: int, fs_in: float,
                  amp: float = 1.0) -> np.ndarray:
    t = np.arange(n) / fs_in
    return (amp * np.exp(2j * np.pi * freq_hz * t)).astype(np.complex64)


def _noise(rng, shape, scale=0.3):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


@pytest.mark.parametrize("k", [4, 8, 16, 64, 256])
def test_design_arrays_equal(k):
    t, j = Channelizer(k, device="cpu"), JChannelizer(k)
    for name in ("hp", "hp_r", "E2", "W2"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (t.fs_in, t.P, t.K) == (j.fs_in, j.P, j.K)
    assert [t.channel_center_hz(i) for i in range(k)] == \
        [j.channel_center_hz(i) for i in range(k)]


@pytest.mark.parametrize("k", [4, 16])
def test_blocks_match_t41x(k):
    """Three streamed blocks over a (2,) batch of wideband captures from
    a random history: channels and state against t41x's."""
    rng = np.random.default_rng(20 + k)
    t, j = Channelizer(k, device="cpu"), JChannelizer(k)
    st0 = _noise(rng, (2, t.P * k - 1))
    st_t, st_j = torch.from_numpy(st0), jnp.asarray(st0)
    for _ in range(3):
        x = _noise(rng, (2, k * 512))
        st_t, ch_t = t.block(st_t, torch.from_numpy(x))
        st_j, ch_j = j.block(st_j, jnp.asarray(x))
        assert tuple(ch_t.shape) == (2, k, 512) and ch_t.dtype == \
            torch.complex64
        assert parity.snr_db(np.asarray(ch_j), ch_t) >= \
            CHANNELIZER_SNR_MIN_DB
        np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))


def test_channelizer_routes_tones():
    cz = Channelizer(K, device="cpu")
    n = K * 4096
    # tone 5 kHz above channel 2's centre, plus one in channel K-1 (=-1)
    x = (wideband_tone(2 * C.SAMPLE_RATE + 5000.0, n, cz.fs_in)
         + wideband_tone(-1 * C.SAMPLE_RATE - 20000.0, n, cz.fs_in, 0.5))
    _, ch = cz.block(cz.init_state(), torch.from_numpy(x))
    ch = ch.numpy()
    assert ch.shape == (K, n // K)
    power = (np.abs(ch) ** 2).mean(axis=1)
    assert set(np.argsort(power)[-2:]) == {2, K - 1}, power
    # in-channel frequency is the offset from the channel centre
    for k, want in ((2, 5000.0), (K - 1, -20000.0)):
        seg = ch[k][1024:]
        f = (np.angle(seg[1:] * np.conj(seg[:-1])).mean() * C.SAMPLE_RATE
             / (2 * np.pi))
        assert abs(f - want) < 100.0, (k, f)


def test_channelizer_isolation():
    cz = Channelizer(K, device="cpu")
    n = K * 4096
    x = wideband_tone(3 * C.SAMPLE_RATE + 10000.0, n, cz.fs_in)
    _, ch = cz.block(cz.init_state(), torch.from_numpy(x))
    power = 10 * np.log10((np.abs(ch.numpy()) ** 2).mean(axis=1) + 1e-30)
    others = [power[k] for k in range(K) if k != 3]
    assert power[3] - max(others) > 50.0, power


def test_channelizer_streaming_continuity():
    cz = Channelizer(K, device="cpu")
    n = K * 8192
    x = wideband_tone(1 * C.SAMPLE_RATE + 7000.0, n, cz.fs_in)
    st = cz.init_state()
    parts = []
    for seg in (x[: n // 2], x[n // 2:]):
        st, ch = cz.block(st, torch.from_numpy(seg))
        parts.append(ch.numpy())
    _, oneshot = cz.block(cz.init_state(), torch.from_numpy(x))
    np.testing.assert_allclose(np.concatenate(parts, axis=-1),
                               oneshot.numpy(), rtol=1e-3, atol=1e-4)


def test_channelizer_to_rx_chain_matches_t41x():
    """Wideband capture -> channelizer -> channel-batched usb chain: each
    channel's tone demodulates at its own audio frequency, and the port's
    audio equals t41x's (channelizer and chain) at >= 55 dB."""
    n_blocks = 8
    n = K * n_blocks * C.BLOCK_SIZE
    fs_in = K * C.SAMPLE_RATE
    # channels 1 and 6 carry USB tones at (-fs/4 + f_a) within the channel
    x = (wideband_tone(1 * C.SAMPLE_RATE - 48000.0 + 800.0, n, fs_in, 0.3)
         + wideband_tone((6 - K) * C.SAMPLE_RATE - 48000.0 + 1500.0, n,
                         fs_in, 0.3)
         + _noise(np.random.default_rng(5), (n,), 0.003))
    kw = dict(mode="usb", interpolate_out=False)
    cz = Channelizer(K, device="cpu")
    _, ch = cz.block(cz.init_state(), torch.from_numpy(x))
    audio = RxChain(ChainSpec(**kw), device="cpu").run(
        ch.contiguous())["audio_24k"].numpy()
    jcz = JChannelizer(K)
    _, jch = jcz.block(jnp.asarray(jcz.init_state()), jnp.asarray(x))
    ref = np.asarray(JChain(JSpec(**kw)).run(np.asarray(jch))["audio_24k"])
    assert parity.snr_db(ref, audio) >= parity.AUDIO_SNR_MIN_DB
    for k, f in ((1, 800.0), (6, 1500.0)):
        snr = signals.tone_fit_snr(audio[k][1024:], [f], C.AUDIO_RATE)
        assert snr > 25.0, (k, snr)
