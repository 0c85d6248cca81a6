"""S1, the spectral NR gain recursion's kernel, on the card.

Every case here needs a CUDA card and skips without one; the file
imports nothing of `t41x` or JAX, so the card's machine runs it as

    python -m pytest --noconftest -m gpu tests/test_torch_spectral_nr_gpu.py

S1 (`t41x_torch/csrc/spectral_nr.cu`) against `spectral_gains_scan` on
the card at 1, 7, 130 and 1024 channels, 2 hops a call (`spectral_nr`)
and 16 (`spectral_nr_batch` over 8 blocks), each carrying its own state
over 64 blocks of this file's stimuli (past the 20 init hops; silent
channels; levels that move the NN choice over all five widths): the NN
choices equal but where the plain version's power ratio lies within
1e-4 of a boundary, the gains of the other hops within 1e-5 relative +
3e-5 (`parity.nr_decisions`), the states within 1e-5 relative of the
plain version's and the init flags equal.  Then `spectral_nr` and
`spectral_nr_batch` with `use_kernels` against the plain path (audio >=
55 dB over 64 blocks, S1's launches counted), the chain's `nr_mode=2`
spec launching S1 in `block` and `block_batch`, and one CUDA graph
capture of the dispatch replayed against the eager launch.  The stimuli
are this file's, so that the CPU tests
(`tests/test_torch_spectral_nr_kernel.py`) hold the plain version
against t41x on the same audio.
"""

import numpy as np
import pytest
import torch

from t41x_torch.dsp import nr as tnr
from t41x_torch.kernels import spectral_nr as kspec
from t41x_torch.utils import parity

pytestmark = pytest.mark.gpu

BLOCKS = 64


def nr_audio(rng, lead: tuple, blocks: int) -> np.ndarray:
    """(blocks, *lead, 256) float32 audio at 24 kHz: per channel, noise at
    a level of its own (1e-3 to 1) and a 700 Hz tone that keys on and
    off by block at 0, 1, 10 or 100 times the noise, so the in-band
    power ratio sweeps the NN widths; every 8th channel silent for its
    first 24 blocks (X = 0 past the init phase), every 8th from the
    fourth silent throughout."""
    ch = int(np.prod(lead, dtype=int))
    n = blocks * 256
    t = np.arange(n) / 24000.0
    noise = 10.0 ** rng.uniform(-3.0, 0.0, (ch, 1))
    x = noise * rng.standard_normal((ch, n))
    keyed = rng.integers(0, 2, (ch, blocks)).repeat(256, axis=-1)
    amp = noise * np.asarray([0.0, 1.0, 10.0, 100.0])[
        rng.integers(0, 4, (ch, 1))]
    x += amp * keyed * np.sin(2 * np.pi * 700.0 * t
                              + rng.uniform(0, 6, (ch, 1)))
    x[0::8, : 24 * 256] = 0.0
    x[4::8] = 0.0
    x = x.astype(np.float32).reshape(ch, blocks, 256)
    return np.moveaxis(x, 1, 0).reshape((blocks,) + tuple(lead) + (256,))


def hop_powers(last: torch.Tensor, xs: torch.Tensor):
    """The bin powers `spectral_nr_batch` computes for blocks xs (B, ...,
    256) after the input history `last`: (2B, ..., 128), and the new
    history."""
    _, frames = tnr._hop_frames(last, xs)
    _, _, powers = tnr._half_spectra(
        frames * tnr._window(tnr._sqrt_hann, xs))
    return powers, xs[-1, ..., tnr.HOP:]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _gst(st):
    return (st.xt, st.pslp, st.hk_old, st.frames)


@pytest.mark.parametrize("ch", [1, 7, 130, 1024])
@pytest.mark.parametrize("per_call", [1, 8])
def test_s1_against_the_plain_recursion(cuda, ch, per_call):
    p = tnr.spectral_params(200.0, 3000.0)
    xs = torch.from_numpy(nr_audio(np.random.default_rng(ch + per_call),
                                   (ch,), BLOCKS)).to(cuda)
    st = tnr.spectral_state((ch,), cuda)
    g_k = g_p = _gst(st)
    last = st.last_sample
    totals = {"near_boundary": 0, "choices_differ": 0}
    for b in range(0, BLOCKS, per_call):
        powers, last = hop_powers(last, xs[b: b + per_call])
        nn_k = torch.empty(powers.shape[:-1], dtype=torch.int32,
                           device=cuda)
        before = kspec.spectral_gains.launches
        g_k, gains_k, init_k = kspec.spectral_gains(p, g_k, powers, nn_k)
        assert kspec.spectral_gains.launches == before + 1
        nn_p, margin = tnr.spectral_decision_margin(p, g_p, powers)
        g_p, gains_p, init_p = kspec.spectral_gains_plain(p, g_p, powers)
        rep = parity.nr_decisions(gains_k, nn_k, gains_p, nn_p, margin)
        assert rep["ok"], (b, rep)
        for k in totals:
            totals[k] += rep[k]
        assert torch.equal(init_k, init_p)
        assert torch.equal(g_k[3], g_p[3])
        for a, r in zip(g_k[:3], g_p[:3]):
            torch.testing.assert_close(a, r, rtol=parity.NR_STATE_RTOL,
                                       atol=1e-30)
    assert int(g_k[3][0]) == 2 * BLOCKS
    print(f"S1 {ch} ch, {2 * per_call} hops a call: {totals}")


@pytest.mark.parametrize("batched", [False, True])
def test_spectral_nr_kernel_path_against_plain(cuda, batched):
    ch = 1024
    p = tnr.spectral_params(200.0, 3000.0)
    xs = torch.from_numpy(nr_audio(np.random.default_rng(3), (ch,),
                                   BLOCKS)).to(cuda)
    st_k = st_p = tnr.spectral_state((ch,), cuda)
    ys_k, ys_p = [], []
    before = kspec.spectral_gains.launches
    step = 8 if batched else 1
    for b in range(0, BLOCKS, step):
        if batched:
            st_k, y_k = tnr.spectral_nr_batch(p, st_k, xs[b: b + 8], True)
            st_p, y_p = tnr.spectral_nr_batch(p, st_p, xs[b: b + 8])
        else:
            st_k, y_k = tnr.spectral_nr(p, st_k, xs[b], use_kernels=True)
            st_p, y_p = tnr.spectral_nr(p, st_p, xs[b])
            y_k, y_p = y_k[None], y_p[None]
        ys_k.append(y_k)
        ys_p.append(y_p)
    assert kspec.spectral_gains.launches == before + BLOCKS // step
    y_k, y_p = torch.cat(ys_k), torch.cat(ys_p)
    assert bool(torch.isfinite(y_k).all())
    assert parity.snr_db(y_p, y_k) >= parity.AUDIO_SNR_MIN_DB
    assert torch.equal(st_k.frames, st_p.frames)
    # silent channels pass their zeros through
    assert not bool(y_k[:, 4::8].any())


def test_chain_launches_s1(cuda):
    from t41x_torch.chain import ChainSpec, RxChain, default_params

    rng = np.random.default_rng(4)
    iq = torch.from_numpy(((rng.standard_normal((4, 16, 2048))
                            + 1j * rng.standard_normal((4, 16, 2048)))
                           * 0.1).astype(np.complex64)).to(cuda)
    chain = RxChain(ChainSpec(mode="usb", nr_mode=2, use_kernels=True),
                    device=cuda)
    pr = default_params((16,), device=cuda)
    st = chain.init_state((16,))
    before = kspec.spectral_gains.launches
    st, _ = chain.block(pr, st, iq[0])
    assert kspec.spectral_gains.launches == before + 1
    st, out = chain.block_batch(pr, st, iq[1:])
    assert kspec.spectral_gains.launches == before + 2
    assert bool(torch.isfinite(out["audio"]).all())
    plain = RxChain(ChainSpec(mode="usb", nr_mode=2, use_kernels=False),
                    device=cuda)
    plain.block(pr, plain.init_state((16,)), iq[0])
    assert kspec.spectral_gains.launches == before + 2


def test_s1_in_a_cuda_graph(cuda):
    p = tnr.spectral_params(200.0, 3000.0)
    ch = 130
    st = tnr.spectral_state((ch,), cuda)._replace(
        frames=torch.full((ch,), 19, dtype=torch.int32, device=cuda))
    powers = torch.rand(16, ch, tnr.HOP, device=cuda) * 3.0
    g = _gst(st)
    eager = kspec.spectral_gains(p, g, powers)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = kspec.spectral_gains(p, g, powers)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip((*eager[0], eager[1], eager[2]),
                    (*captured[0], captured[1], captured[2])):
        assert torch.equal(a, b)


def test_wrapper_refuses_on_the_card(cuda):
    p = tnr.spectral_params()
    st = tnr.spectral_state((3,), cuda)
    g = _gst(st)
    for bad in (torch.rand(2, 3, tnr.HOP, device=cuda, dtype=torch.float64),
                torch.rand(2, 4, tnr.HOP, device=cuda),
                torch.rand(0, 3, tnr.HOP, device=cuda)):
        with pytest.raises(ValueError):
            kspec.spectral_gains(p, g, bad)
    with pytest.raises(ValueError):
        kspec.spectral_gains(p, g, torch.rand(2, 3, tnr.HOP, device=cuda),
                             torch.empty(2, 3, device=cuda))


@pytest.mark.parametrize("ch", [1, 7, 130, 1024])
@pytest.mark.parametrize("hops", [1, 2, 3, 16, 17])
def test_s1_at_hop_counts_ragged_against_the_prefetch(cuda, ch, hops):
    """Hop counts on and off the kernel's 4-hop prefetch ring, from this
    file's stimuli past the init phase (and, for channel 0 mod 8,
    crossing it): the choices, gains and states as in
    `test_s1_against_the_plain_recursion`, the states bit for bit."""
    p = tnr.spectral_params(200.0, 3000.0)
    blocks = 12 + -(-hops // 2)
    xs = torch.from_numpy(nr_audio(np.random.default_rng(ch * 5 + hops),
                                   (ch,), blocks)).to(cuda)
    st = tnr.spectral_state((ch,), cuda)
    powers, _ = hop_powers(st.last_sample, xs)
    g = kspec.spectral_gains_plain(p, _gst(st), powers[:19])[0]
    pw = powers[19: 19 + hops].contiguous()
    nn_k = torch.empty(pw.shape[:-1], dtype=torch.int32, device=cuda)
    g_k, gains_k, init_k = kspec.spectral_gains(p, g, pw, nn_k)
    nn_p, margin = tnr.spectral_decision_margin(p, g, pw)
    g_p, gains_p, init_p = kspec.spectral_gains_plain(p, g, pw)
    rep = parity.nr_decisions(gains_k, nn_k, gains_p, nn_p, margin)
    assert rep["ok"], rep
    assert torch.equal(init_k, init_p) and bool(init_k[0].all())
    for a, r in zip(g_k, g_p):
        assert torch.equal(a, r)


@pytest.mark.parametrize("ch", [1, 7, 1024])
@pytest.mark.parametrize("hops", [1, 2, 17])
def test_s1_phases_variant_is_the_kernel(cuda, ch, hops):
    """`spectral_gains_phases` (the clock64-stamped build) gives the
    unstamped kernel's states, gains and flags bit for bit, and a
    stamps row a channel with every phase and the total counted."""
    p = tnr.spectral_params(200.0, 3000.0)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(ch + hops)
    st = tnr.spectral_state((ch,), cuda)._replace(
        frames=torch.full((ch,), 18, dtype=torch.int32, device=cuda))
    g = (torch.rand(ch, tnr.HOP, generator=gen, device=cuda) + 0.1,
         torch.rand(ch, tnr.HOP, generator=gen, device=cuda), st.hk_old,
         st.frames)
    pw = torch.rand(hops, ch, tnr.HOP, generator=gen, device=cuda) ** 4 * 3
    want = kspec.spectral_gains(p, g, pw)
    *got, stamps = kspec.spectral_gains_phases(p, g, pw)
    torch.cuda.synchronize()
    for a, b in zip((*want[0], want[1], want[2]),
                    (*got[0], got[1], got[2])):
        assert torch.equal(a, b)
    assert stamps.shape == (ch, len(kspec.S1_PHASES) + 2)
    assert bool((stamps[:, 1] > 0).all() and (stamps[:, -2:] > 0).all())
    assert bool((stamps[:, :-2].sum(1) <= stamps[:, -2]).all())


def test_s1_division_and_square_root_are_ieee(cuda):
    """S1's branch-free division and square root (`kernels.spectral_nr.
    arith_probe`) against torch's on 2^24 pairs, bit for bit: log-uniform
    magnitudes over 2^-140 .. 2^120 (past the fast forms' range on both
    sides, into denormals), zeros of both signs, the divisor positive."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(15)
    n = 1 << 24

    def spread(sign):
        e = torch.rand(n, generator=gen, device=cuda) * 260.0 - 140.0
        m = 1.0 + torch.rand(n, generator=gen, device=cuda)
        v = (m.double() * torch.exp2(e.double().floor())).float()
        if sign:
            v = torch.where(torch.rand(n, generator=gen, device=cuda) < 0.5,
                            -v, v)
        return v

    a, b = spread(True), spread(False)
    a[::97] = 0.0
    a[1::97] = -0.0
    b = torch.where(b > 0, b, torch.full_like(b, 1.5))
    q, r = kspec.arith_probe(a, b)
    torch.cuda.synchronize()
    assert torch.equal(q.view(torch.int32), (a / b).view(torch.int32))
    assert torch.equal(r.view(torch.int32),
                       torch.sqrt(a.abs()).view(torch.int32))
