"""The port's mesh layer on the card: the channelizer against the CPU,
and the channel-sharded, time-sharded and distributed paths of
`chip_smoke.py` phase 7 at small sizes, every shard on the one card.

Every case needs a CUDA card and skips without one; the file imports
nothing of `t41x` or JAX, so the card's machine runs it as

    python -m pytest --noconftest -m gpu tests/test_torch_mesh_gpu.py
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from t41x_torch import constants as C
from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.chain.rx import join_blocks
from t41x_torch.kernels import agc as kagc, frontend as kfe
from t41x_torch.kernels import interp as kint, os_filter as kos
from t41x_torch.mesh import distributed as dist
from t41x_torch.mesh import sharding, timeshard
from t41x_torch.mesh.channelizer import Channelizer
from t41x_torch.utils import checkpoint, parity

pytestmark = pytest.mark.gpu

COUNTERS = {"K1": kfe.FusedFrontEnd, "K2": kagc.agc_block,
            "K3": kint.FusedInterp, "K4": kos.os_filter_matmul_kernel}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _reset():
    for obj in COUNTERS.values():
        obj.launches = 0


def _counts():
    return {k: obj.launches for k, obj in COUNTERS.items()}


def _iq(ch: int, n_blocks: int, seed: int = 5) -> np.ndarray:
    """(ch, n_blocks * BLOCK) complex64: a USB tone per channel in
    noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n_blocks * C.BLOCK_SIZE) / C.SAMPLE_RATE
    f = -C.SAMPLE_RATE / 4 + 600.0 + 150.0 * np.arange(ch)[:, None]
    noise = rng.standard_normal((ch, t.size)) + 1j * rng.standard_normal(
        (ch, t.size))
    return (0.25 * np.exp(2j * np.pi * f * t) + 0.02 * noise).astype(
        np.complex64)


def _stream(chain, params, iq):
    st, outs = chain.init_state((iq.shape[0],)), []
    for b in range(iq.shape[-1] // C.BLOCK_SIZE):
        st, out = chain.block(params, st, iq[:, b * C.BLOCK_SIZE:
                                             (b + 1) * C.BLOCK_SIZE]
                              .contiguous())
        outs.append(out)
    return st, join_blocks(outs, 1)


def _parity(got: dict, ref: dict):
    for k in ref:
        if k in ("audio", "audio_24k"):
            assert parity.snr_db(ref[k], got[k]) >= \
                parity.AUDIO_SNR_MIN_DB, k
        elif k in ("rf_spectrum", "audio_spectrum"):
            assert parity.spectrum_err_db(ref[k], got[k]) <= \
                parity.SPECTRUM_ERR_MAX_DB, k


@pytest.mark.parametrize("k", [16, 64, 256])
def test_channelizer_on_the_card_matches_the_cpu(cuda, k):
    rng = np.random.default_rng(k)
    cz, cz_cpu = Channelizer(k, device=cuda), Channelizer(k, device="cpu")
    st, st_c = cz.init_state((2,)), cz_cpu.init_state((2,))
    for _ in range(2):
        x = ((rng.standard_normal((2, k * 2048))
              + 1j * rng.standard_normal((2, k * 2048))) * 0.3
             ).astype(np.complex64)
        st, y = cz.block(st, torch.from_numpy(x).to(cuda))
        st_c, y_c = cz_cpu.block(st_c, torch.from_numpy(x))
        assert y.shape == (2, k, 2048) and y.device.type == "cuda"
        assert parity.snr_db(y_c, y) >= 100.0
        assert torch.equal(st.cpu(), st_c)


def test_channel_sharded_chain_and_elastic_resume(cuda, tmp_path):
    n_ch = 16
    iq = torch.from_numpy(_iq(n_ch, 4)).to(cuda)
    kw = dict(mode="usb", spectrum_zoom=0)
    chain = RxChain(ChainSpec(**kw), device=cuda)
    params = default_params((n_ch,), device=cuda)
    _, ref = _stream(chain, params, iq)
    _, ref_plain = _stream(RxChain(ChainSpec(use_kernels=False, **kw),
                                   device=cuda), params, iq)
    mesh = sharding.make_mesh(devices=[cuda] * 4)
    assert mesh.shape == {"ch": 4}
    _reset()
    st4, got = sharding.channel_sharded_outputs(chain, mesh, params, iq)
    torch.cuda.synchronize()
    assert all(_counts()[k] for k in ("K1", "K2", "K3"))
    # the kernels at 4 channels a shard against the plain versions, and
    # against the kernels at 16
    _parity(got, ref_plain)
    _parity(got, ref)

    cut = 2 * C.BLOCK_SIZE
    st1, a1 = sharding.channel_sharded_stream(chain, mesh, params,
                                              iq[:, :cut])
    path = str(tmp_path / "elastic.npz")
    checkpoint.save_state(path, st1)
    st_r, _ = checkpoint.load_state(path, chain.init_state((n_ch,)))
    _, a2 = sharding.channel_sharded_stream(
        chain, sharding.make_mesh(devices=[cuda] * 2), params, iq[:, cut:],
        st_r)
    joined = torch.cat([a1, a2], dim=-1)
    np.testing.assert_allclose(joined.cpu().numpy(),
                               got["audio_24k"].cpu().numpy(), rtol=1e-3,
                               atol=1e-4)
    _parity({"audio_24k": joined}, {"audio_24k": ref_plain["audio_24k"]})


def test_time_sharded_full_chain_on_a_ch_x_t_mesh(cuda):
    n_ch = 8
    iq = torch.from_numpy(_iq(n_ch, 4, seed=6)).to(cuda)
    kw = dict(mode="usb", spectrum_taps=False)
    chain = RxChain(ChainSpec(**kw), device=cuda)
    params = default_params((n_ch,), nco_freq=120.0, device=cuda)
    _, ref = _stream(chain, params, iq)
    _, ref_plain = _stream(RxChain(ChainSpec(use_kernels=False, **kw),
                                   device=cuda), params, iq)
    mesh = sharding.Mesh(np.asarray([cuda] * 8, dtype=object).reshape(2, 4),
                         ("ch", "t"))
    _reset()
    got = timeshard.run_time_sharded_full(chain, mesh, iq, params,
                                          channel_axis="ch")
    torch.cuda.synchronize()
    c = _counts()
    assert c["K1"] == 0 and all(c[k] for k in ("K2", "K3", "K4")), c
    assert got.keys() == ref.keys()
    # the tail's kernels at 4 channels a slice against the plain
    # versions, and against the streamed chain's kernels at 8
    _parity(got, ref_plain)
    _parity(got, ref)


def test_default_mesh_reuses_a_default_chain(cuda):
    """`"cuda"` and `"cuda:0"` name one card: a default mesh runs a
    default chain itself, not a second chain on cuda:0."""
    chain = RxChain(ChainSpec(mode="usb"))
    mesh = sharding.make_mesh()
    assert all(d.index is not None for d in mesh.devices.flat)
    assert sharding.chains_on(chain, mesh.devices.flat) == {
        mesh.devices.flat[0]: chain}


def test_nccl_fleet_summary_of_one_rank(cuda, tmp_path):
    store = tdist.FileStore(os.path.join(tmp_path, "store"), 1)
    tdist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        dist.initialize()
        mesh = dist.global_mesh(axis="ch")
        assert list(mesh.devices.flat)[0].type == "cuda"
        iq = torch.from_numpy(_iq(8, 1))
        local = dist.shard_local_channels(mesh, iq)
        assert local.iq.device.type == "cuda"
        assert (local.offset, local.global_shape) == (0, tuple(iq.shape))
        vals = torch.linspace(-120.0, -60.0, 1024, device=cuda) \
            + torch.rand(1024, device=cuda)
        s = dist.fleet_summary(vals)
        assert torch.equal(s["max"], vals.max())
        assert torch.equal(s["min"], vals.min())
        np.testing.assert_allclose(float(s["mean"]), float(vals.mean()),
                                   rtol=1e-6)
    finally:
        tdist.destroy_process_group()
