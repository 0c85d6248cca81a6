"""t41x_torch's mesh layer against t41x's, on the CPU.

`tests/test_mesh.py` case by case: each of the port's sharded functions
runs on a `Mesh` of `["cpu"] * n` shards and is held against t41x's own
sharded function on the 8 virtual CPU devices of `tests/conftest.py`
(same NumPy inputs), at that file's tolerances: the halo exact, the
sharded decimator at rtol 1e-4 / atol 1e-5, the sharded overlap-save
filter and the channel-sharded chain at rtol 1e-3 / atol 1e-4, the time-
sharded front end above 45 dB, the time-sharded full chains at >= 55 dB
of audio.  Sizes are cut to a few channels and at most 4 blocks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh, PartitionSpec as P

from t41x.chain import ChainSpec as JSpec, RxChain as JChain
from t41x.chain import default_params as jdefault_params
from t41x.dsp import firdesign as jfd
from t41x.mesh import halo as jhalo, sharding as jsharding
from t41x.mesh import timeshard as jtimeshard
from t41x_torch import constants as C
from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.dsp import fir, osfilter
from t41x_torch.io import signals
from t41x_torch.mesh import halo, sharding, timeshard
from t41x_torch.utils import checkpoint, convert, parity

torch.set_num_threads(2)
RNG = np.random.default_rng(7)


def jmesh(n, axis="t"):
    return JMesh(np.asarray(jax.devices()[:n]), (axis,))


def tmesh(n, axis="t"):
    return sharding.make_mesh(n, axis, devices=["cpu"] * n)


def shards_of(x: np.ndarray, n: int) -> list:
    return list(torch.from_numpy(x).chunk(n, dim=-1))


def _snr(ref, got) -> float:
    return parity.snr_db(np.asarray(ref), got)


def test_mesh_layout():
    m = sharding.Mesh(np.asarray(["cpu"] * 8).reshape(4, 2), ("ch", "t"))
    assert m.shape == {"ch": 4, "t": 2} and m.devices.size == 8
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    with pytest.raises(ValueError):
        sharding.make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        sharding.shard_bounds(10, 4)


def test_unindexed_cuda_names_the_current_card(monkeypatch):
    """`"cuda"` and `"cuda:0"` are one card to a mesh and to `chains_on`:
    a chain on `"cuda"` serves shards on `cuda:0` itself."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    class Chain:
        def __init__(self, spec, device):
            self.spec, self.device = spec, torch.device(device)

    m = sharding.Mesh(["cuda", "cuda:0", "cpu"], ("ch",))
    assert list(m.devices.flat) == [torch.device("cuda", 0)] * 2 + [
        torch.device("cpu")]
    chain = Chain("spec", "cuda")
    chains = sharding.chains_on(chain, m.devices.flat)
    assert list(chains) == [torch.device("cuda", 0), torch.device("cpu")]
    assert chains[torch.device("cuda", 0)] is chain
    assert chains[torch.device("cpu")] is not chain


def test_left_halo_passes_neighbor_tail():
    x = np.arange(4 * 16, dtype=np.float32).reshape(1, 64)
    f = jax.jit(jax.shard_map(
        functools.partial(jhalo.left_halo, halo=4, axis_name="t"),
        mesh=jmesh(4), in_specs=P(None, "t"), out_specs=P(None, "t")))
    ref = np.asarray(f(jnp.asarray(x))).reshape(4, 4)
    got = halo.left_halo(shards_of(x, 4), 4)
    np.testing.assert_array_equal(torch.cat(got).numpy(), ref)
    np.testing.assert_array_equal(got[0].numpy(), 0)
    np.testing.assert_array_equal(got[3].numpy(), [[44, 45, 46, 47]])


def test_sharded_os_filter_matches_t41x():
    taps = jfd.complex_bandpass(257, 200.0, 3000.0, 24000.0)
    mask = jfd.os_filter_mask(taps, 512).astype(np.complex64)
    n = 4 * 1024
    x = (RNG.standard_normal(n) + 1j * RNG.standard_normal(n)
         ).astype(np.complex64)
    f = jax.jit(jax.shard_map(
        lambda seg: jhalo.sharded_os_filter(seg, jnp.asarray(mask), "t"),
        mesh=jmesh(4), in_specs=P("t"), out_specs=P("t")))
    ref = np.asarray(f(jnp.asarray(x)))
    got = torch.cat(halo.sharded_os_filter(shards_of(x, 4),
                                           torch.from_numpy(mask))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    # and the unsharded stream
    st, outs = osfilter.os_state(), []
    for i in range(n // 256):
        st, y = osfilter.os_filter(
            st, torch.from_numpy(x[i * 256:(i + 1) * 256]),
            torch.from_numpy(mask))
        outs.append(y.numpy())
    np.testing.assert_allclose(got, np.concatenate(outs), rtol=1e-3,
                               atol=1e-4)


def test_sharded_decimate_matches_t41x():
    h = jfd.fir_kaiser(28, 9000.0, 90.0, "lowpass",
                       fs=192000.0).astype(np.float32)
    n = 4 * 512
    x = RNG.standard_normal(n).astype(np.float32)
    f = jax.jit(jax.shard_map(
        lambda seg: jhalo.sharded_fir_decimate(seg, jnp.asarray(h), 4, "t"),
        mesh=jmesh(4), in_specs=P("t"), out_specs=P("t")))
    ref = np.asarray(f(jnp.asarray(x)))
    got = torch.cat(halo.sharded_fir_decimate(
        shards_of(x, 4), torch.from_numpy(h), 4)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    _, y = fir.fir_decimate(fir.fir_state(28), torch.from_numpy(x),
                            torch.from_numpy(h), 4)
    np.testing.assert_allclose(got, y.numpy(), rtol=1e-4, atol=1e-5)


def _usb_iq(n_ch, n_blocks, f0, df):
    n = n_blocks * C.BLOCK_SIZE
    return np.stack([signals.usb_signal([f0 + df * k], n) * 0.25
                     for k in range(n_ch)]).astype(np.complex64)


HEADLESS = dict(mode="usb", spectrum_taps=False, interpolate_out=False)


def test_channel_sharded_chain_matches_t41x():
    n_ch, n_blocks = 8, 4
    iq = _usb_iq(n_ch, n_blocks, 500.0, 200.0)
    jchain = JChain(JSpec(**HEADLESS))
    ref = np.asarray(jsharding.channel_sharded_run(
        jchain, jsharding.make_mesh(4, "ch"), jdefault_params((n_ch,)),
        jnp.asarray(iq), n_blocks))
    chain = RxChain(ChainSpec(**HEADLESS), device="cpu")
    params = default_params((n_ch,), device="cpu")
    got = sharding.channel_sharded_run(chain, tmesh(4, "ch"), params, iq,
                                       n_blocks)
    assert tuple(got.shape) == (n_ch, n_blocks * C.AUDIO_BLOCK)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=1e-4)
    unsharded = chain.run(iq, params=params)["audio_24k"]
    np.testing.assert_allclose(got.numpy(), unsharded.numpy(), rtol=1e-3,
                               atol=1e-4)


def test_elastic_resume_8_to_4_shards(tmp_path):
    """Checkpoint a channel-sharded stream on 8 shards, resume on 4 from
    the host-resident checkpoint: the joined audio matches t41x's elastic
    run, and the resumed half an uninterrupted 8-shard continuation."""
    n_ch, nb1, nb2 = 8, 2, 2
    iq = _usb_iq(n_ch, nb1 + nb2, 600.0, 150.0)
    cut = nb1 * C.BLOCK_SIZE

    jchain = JChain(JSpec(**HEADLESS))
    jparams = jdefault_params((n_ch,))
    jst, ja1 = jsharding.channel_sharded_stream(
        jchain, jsharding.make_mesh(8, "ch"), jparams, iq[:, :cut])
    _, ja2 = jsharding.channel_sharded_stream(
        jchain, jsharding.make_mesh(4, "ch"), jparams, iq[:, cut:],
        state=jax.device_get(jst))
    ref = np.concatenate([np.asarray(ja1), np.asarray(ja2)], axis=-1)

    chain = RxChain(ChainSpec(**HEADLESS), device="cpu")
    params = default_params((n_ch,), device="cpu")
    st1, a1 = sharding.channel_sharded_stream(chain, tmesh(8, "ch"), params,
                                              iq[:, :cut])
    path = str(tmp_path / "elastic.npz")
    checkpoint.save_state(path, st1, extra={"blocks_done": nb1})
    st_resume, meta = checkpoint.load_state(
        path, template=chain.init_state((n_ch,)))
    assert meta["blocks_done"] == nb1
    _, a2 = sharding.channel_sharded_stream(chain, tmesh(4, "ch"), params,
                                            iq[:, cut:], state=st_resume)
    joined = torch.cat([a1, a2], dim=-1).numpy()
    np.testing.assert_allclose(joined, ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        joined, chain.run(iq, params=params)["audio_24k"].numpy(),
        rtol=1e-3, atol=1e-4)
    _, a2_8 = sharding.channel_sharded_stream(chain, tmesh(8, "ch"), params,
                                              iq[:, cut:], state=st1)
    np.testing.assert_allclose(a2.numpy(), a2_8.numpy(), rtol=1e-4,
                               atol=1e-6)


def test_time_sharded_frontend_matches_t41x():
    """The front end over 4 time shards against t41x's: Fs/4 and NCO
    phase continuity across shard boundaries; and against the port's
    streamed chain (AGC off, its fixed gain 20) by the best scalar fit."""
    kw = dict(mode="usb", agc_mode=0, spectrum_taps=False,
              interpolate_out=False)
    n = 4 * 2 * C.BLOCK_SIZE
    iq = (signals.usb_signal([800.0, 2100.0], n, nco=2500.0) * 0.3
          + signals.awgn(n, 0.01, seed=8)).astype(np.complex64)
    ref = np.asarray(jtimeshard.run_time_sharded(
        JChain(JSpec(**kw)), jmesh(4), jnp.asarray(iq), nco_freq=2500.0))
    chain = RxChain(ChainSpec(**kw), device="cpu")
    got = timeshard.run_time_sharded(chain, tmesh(4), iq, nco_freq=2500.0)
    assert _snr(ref, got) > 45.0

    audio = chain.run(iq, params=default_params(
        (), nco_freq=2500.0, device="cpu"))["audio_24k"].numpy() / 20.0
    g = got.real.numpy()[256:]
    a = audio[256:]
    err = g - (np.dot(g, a) / np.dot(a, a)) * a
    assert 10 * np.log10(np.mean(a ** 2) / np.mean(err ** 2)) > 45.0


def test_time_sharded_full_chain_matches_t41x():
    """The full chain (AGC on, S-meter, x8 interpolation) over 4 time
    shards against t41x's run and the port's streamed chain."""
    kw = dict(mode="usb", agc_mode=2, spectrum_taps=True,
              interpolate_out=True)
    n = 4 * C.BLOCK_SIZE
    iq = (signals.usb_signal([700.0, 1900.0], n, nco=2500.0) * 0.3
          + signals.awgn(n, 0.01, seed=3)).astype(np.complex64)
    ref = jtimeshard.run_time_sharded_full(
        JChain(JSpec(**kw)), jmesh(4), iq, jdefault_params((),
                                                           nco_freq=2500.0))
    chain = RxChain(ChainSpec(**kw), device="cpu")
    params = default_params((), nco_freq=2500.0, device="cpu")
    got = timeshard.run_time_sharded_full(chain, tmesh(4), iq, params)
    streamed = chain.run(iq, params=params)
    assert got.keys() == streamed.keys() == ref.keys()
    for key in ("audio_24k", "audio"):
        assert _snr(ref[key], got[key]) >= parity.AUDIO_SNR_MIN_DB, key
        assert _snr(streamed[key], got[key]) >= parity.AUDIO_SNR_MIN_DB
    np.testing.assert_allclose(got["smeter_avg"].numpy(),
                               np.asarray(ref["smeter_avg"]), rtol=1e-3,
                               atol=1e-5)


def test_time_sharded_full_chain_sam_and_channels():
    """The SAM PLL tail and a channel batch over 4 time shards, against
    t41x's, past the PLL's lock transient (the first 2 blocks)."""
    kw = dict(mode="sam", spectrum_taps=False, interpolate_out=False)
    n_ch, n = 3, 4 * C.BLOCK_SIZE
    iq = np.stack([signals.am_signal(400.0 + 150.0 * k, n, nco=1000.0) * 0.3
                   for k in range(n_ch)]).astype(np.complex64)
    ref = jtimeshard.run_time_sharded_full(
        JChain(JSpec(**kw)), jmesh(4), iq,
        jdefault_params((n_ch,), nco_freq=1000.0))
    chain = RxChain(ChainSpec(**kw), device="cpu")
    got = timeshard.run_time_sharded_full(
        chain, tmesh(4), iq, default_params((n_ch,), nco_freq=1000.0,
                                            device="cpu"))
    skip = 2 * C.AUDIO_BLOCK
    assert _snr(np.asarray(ref["audio_24k"])[..., skip:],
                got["audio_24k"][..., skip:]) >= parity.AUDIO_SNR_MIN_DB


def test_time_sharded_full_chain_ch_x_t_mesh():
    """The full chain on a 2-D (4 ch x 2 t) mesh, per-channel gains
    riding the channel slices, against t41x's on its 4 x 2 mesh."""
    kw = dict(mode="usb", agc_mode=2, spectrum_taps=True,
              interpolate_out=True)
    n_ch, n = 4, 4 * C.BLOCK_SIZE
    iq = np.stack([
        np.asarray(signals.usb_signal([650.0 + 80.0 * k, 2100.0], n,
                                      nco=2500.0)) * 0.3
        + np.asarray(signals.awgn(n, 0.01, seed=50 + k))
        for k in range(n_ch)]).astype(np.complex64)
    jparams = jdefault_params((n_ch,), nco_freq=2500.0)._replace(
        rf_gain_db=np.linspace(-3.0, 3.0, n_ch).astype(np.float32))
    ref = jtimeshard.run_time_sharded_full(
        JChain(JSpec(**kw)),
        JMesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("ch", "t")),
        iq, jparams, channel_axis="ch")
    chain = RxChain(ChainSpec(**kw), device="cpu")
    mesh = sharding.Mesh(np.asarray(["cpu"] * 8).reshape(4, 2), ("ch", "t"))
    got = timeshard.run_time_sharded_full(
        chain, mesh, iq, convert.params_from_numpy(jparams, "cpu"),
        channel_axis="ch")
    for key in ("audio_24k", "audio"):
        assert tuple(got[key].shape) == np.asarray(ref[key]).shape
        assert _snr(ref[key], got[key]) >= parity.AUDIO_SNR_MIN_DB, key


def test_distributed_in_one_process():
    """No process group: `initialize` returns at once, the mesh keeps the
    (ch, t) layout with t innermost, the local block is the whole
    capture, and the fleet summary is torch's own reduction (a complex
    value's mean through its real view)."""
    from t41x_torch.mesh import distributed as dist

    dist.initialize(num_processes=1)
    m = dist.global_mesh("ch", "t", 2, devices=["cpu"] * 8)
    assert m.axis_names == ("ch", "t") and m.shape == {"ch": 4, "t": 2}
    with pytest.raises(ValueError):
        dist.global_mesh("ch", "t", 3, devices=["cpu"] * 8)
    iq = _usb_iq(4, 1, 700.0, 100.0)
    local = dist.shard_local_channels(m, iq)
    assert (local.offset, local.global_shape) == (0, iq.shape)
    np.testing.assert_array_equal(local.iq.numpy(), iq)
    v = torch.from_numpy(RNG.standard_normal(100).astype(np.float32))
    s = dist.fleet_summary(v)
    assert s["max"] == v.max() and s["min"] == v.min()
    np.testing.assert_allclose(float(s["mean"]), float(v.mean()), rtol=1e-6)
    c = torch.from_numpy(iq[0, :64])
    np.testing.assert_allclose(complex(dist.fleet_summary(c)["mean"]),
                               complex(c.mean()), rtol=1e-5)
