"""E1, the 14-band EQ's kernel, on the card.

Every case here needs a CUDA card and skips without one; the file
imports nothing of `t41x` or JAX, so the card's machine runs it as

    python -m pytest --noconftest -m gpu tests/test_torch_eq_gpu.py

E1 (`t41x_torch/csrc/eq.cu`) against `EQDesign.apply_plain` on the card
at 1, 7, 130 and 1024 channels x n 32, 256 and 2048, each carrying its
own state from a random one over 64 blocks of this file's stimuli
(per-channel gains, a band of zero gains, noise and tones across the
bands' centres): every block's output and state >= 100 dB from the
plain version's (the sums run in another order than cuBLAS's), finite;
shared (14,) gains at one channel as `Radio.transmit_ssb` passes them;
then the receive chain's `eq_on` spec, the SSB exciter with its EQ and
`Radio.transmit_ssb` with the transmit EQ on launching E1 (one launch a
block), and one CUDA graph capture of the dispatch replayed against
the eager launch.  The stimuli are this file's, so that the CPU tests
(`tests/test_torch_eq_kernel.py`) hold the plain version against t41x
on the same audio.
"""

import numpy as np
import pytest
import torch

from t41x_torch.dsp import eq as teq
from t41x_torch.kernels import eq as keq
from t41x_torch.utils import parity

pytestmark = pytest.mark.gpu

BLOCKS = 64


def eq_audio(rng, lead: tuple, n: int, blocks: int) -> np.ndarray:
    """(blocks, *lead, n) float32 audio at 24 kHz: noise at a level of
    the channel's own (1e-3 to 1) plus tones at three band centres."""
    ch = int(np.prod(lead, dtype=int))
    t = np.arange(blocks * n) / 24000.0
    lvl = 10.0 ** rng.uniform(-3.0, 0.0, (ch, 1))
    x = lvl * rng.standard_normal((ch, t.size))
    for fc in rng.choice(teq.band_centers(), 3, replace=False):
        x += lvl * np.sin(2 * np.pi * fc * t + rng.uniform(0, 6, (ch, 1)))
    x = x.astype(np.float32).reshape(ch, blocks, n)
    return np.moveaxis(x, 1, 0).reshape((blocks,) + tuple(lead) + (n,))


def eq_gains(rng, lead: tuple) -> np.ndarray:
    """(*lead, 14) gains in 0..1, one band of each channel at 0."""
    g = rng.uniform(0.0, 1.0, tuple(lead) + (teq.NUM_BANDS,))
    flat = g.reshape(-1, teq.NUM_BANDS)
    flat[np.arange(len(flat)), np.arange(len(flat)) % teq.NUM_BANDS] = 0.0
    return g.astype(np.float32)


def eq_state(rng, lead: tuple) -> np.ndarray:
    """A random carried (*lead, 14, 2, 2) state."""
    return (0.1 * rng.standard_normal(tuple(lead) + (teq.NUM_BANDS, 2, 2))
            ).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


DESIGN = teq.EQDesign()


@pytest.mark.parametrize("ch", [1, 7, 130, 1024])
@pytest.mark.parametrize("n", [32, 256, 2048])
def test_e1_against_the_plain_version(cuda, ch, n):
    rng = np.random.default_rng(ch * 7 + n)
    blocks = BLOCKS if n <= 256 else 8
    xs = torch.from_numpy(eq_audio(rng, (ch,), n, blocks)).to(cuda)
    gains = torch.from_numpy(eq_gains(rng, (ch,))).to(cuda)
    st_k = st_p = torch.from_numpy(eq_state(rng, (ch,))).to(cuda)
    before = keq.eq_block.launches
    worst = np.inf
    for b in range(blocks):
        st_k, y_k = DESIGN.apply(st_k, xs[b], gains, use_kernels=True)
        st_p, y_p = DESIGN.apply_plain(st_p, xs[b], gains)
        assert bool(torch.isfinite(y_k).all()) and y_k.shape == y_p.shape
        assert st_k.shape == (ch, teq.NUM_BANDS, 2, 2)
        worst = min(worst, parity.snr_db(y_p, y_k),
                    parity.snr_db(st_p, st_k))
    assert keq.eq_block.launches == before + blocks
    assert worst >= parity.EQ_SNR_MIN_DB, worst


def test_e1_with_shared_gains_at_one_channel(cuda):
    rng = np.random.default_rng(5)
    xs = torch.from_numpy(eq_audio(rng, (), 256, BLOCKS)).to(cuda)
    gains = torch.from_numpy(eq_gains(rng, ())).to(cuda)
    st_k = st_p = DESIGN.init_state((), cuda)
    for b in range(BLOCKS):
        st_k, y_k = DESIGN.apply(st_k, xs[b], gains, use_kernels=True)
        st_p, y_p = DESIGN.apply_plain(st_p, xs[b], gains)
        assert y_k.shape == (256,)
        assert parity.snr_db(y_p, y_k) >= parity.EQ_SNR_MIN_DB
    assert parity.snr_db(st_p, st_k) >= parity.EQ_SNR_MIN_DB


def test_chains_launch_e1(cuda):
    from t41x_torch.chain import ChainSpec, RxChain, default_params
    from t41x_torch.chain import tx
    from t41x_torch.radio import Radio

    rng = np.random.default_rng(6)
    iq = torch.from_numpy(((rng.standard_normal((2, 16, 2048))
                            + 1j * rng.standard_normal((2, 16, 2048)))
                           * 0.1).astype(np.complex64)).to(cuda)
    pr = default_params((16,), device=cuda)._replace(
        eq_gains=torch.from_numpy(eq_gains(rng, (16,))).to(cuda))
    outs = {}
    for use_kernels in (True, False):
        chain = RxChain(ChainSpec(mode="usb", eq_on=True,
                                  use_kernels=use_kernels), device=cuda)
        st = chain.init_state((16,))
        before = keq.eq_block.launches
        for b in range(2):
            st, out = chain.block(pr, st, iq[b])
        assert keq.eq_block.launches == before + (2 if use_kernels else 0)
        outs[use_kernels] = out["audio_24k"]
    assert parity.snr_db(outs[False], outs[True]) >= parity.AUDIO_SNR_MIN_DB

    ex = tx.SSBExciter(tx.TxSpec(eq_on=True), device=cuda)
    mic = torch.from_numpy(rng.standard_normal((16, 2048)).astype(
        np.float32) * 0.1).to(cuda)
    before = keq.eq_block.launches
    ex.block(tx.default_tx_params((16,), device=cuda), ex.init_state((16,)),
             mic)
    assert keq.eq_block.launches == before + 1

    radio = Radio(device=cuda)
    radio.set_eq("tx", True)
    before = keq.eq_block.launches
    iq_k = radio.transmit_ssb(mic[0].cpu().numpy())
    assert keq.eq_block.launches == before + 1
    iq_p = radio.transmit_ssb(mic[0].cpu().numpy(), use_kernels=False)
    assert keq.eq_block.launches == before + 1
    assert parity.snr_db(iq_p, iq_k) >= parity.AUDIO_SNR_MIN_DB


def test_e1_in_a_cuda_graph(cuda):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(eq_audio(rng, (130,), 256, 1)[0]).to(cuda)
    gains = torch.from_numpy(eq_gains(rng, (130,))).to(cuda)
    st = torch.from_numpy(eq_state(rng, (130,))).to(cuda)
    eager = DESIGN.apply(st, x, gains, use_kernels=True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = DESIGN.apply(st, x, gains, use_kernels=True)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(eager, captured):
        assert torch.equal(a, b)


def test_wrapper_refuses_on_the_card(cuda):
    st = DESIGN.init_state((3,), cuda)
    g = torch.ones(3, teq.NUM_BANDS, device=cuda)
    for x in (torch.zeros(3, 48, device=cuda),
              torch.zeros(3, 0, device=cuda),
              torch.zeros(3, 256, device=cuda, dtype=torch.float64)):
        with pytest.raises(ValueError):
            DESIGN.apply(st, x, g, use_kernels=True)
    with pytest.raises(ValueError):
        DESIGN.apply(st, torch.zeros(3, 256, device=cuda),
                     torch.ones(3, 13, device=cuda), use_kernels=True)


@pytest.mark.parametrize("ch", [1, 9, 130])
@pytest.mark.parametrize("n", [32, 288, 2048])
def test_e1_in_a_cuda_graph_at_ragged_shapes(cuda, ch, n):
    """Channel counts off the kernel's 8 a block, block lengths off its
    8-chunk passes, replayed from a graph against the eager launch."""
    rng = np.random.default_rng(ch * 3 + n)
    x = torch.from_numpy(eq_audio(rng, (ch,), n, 1)[0]).to(cuda)
    gains = torch.from_numpy(eq_gains(rng, (ch,))).to(cuda)
    st = torch.from_numpy(eq_state(rng, (ch,))).to(cuda)
    eager = DESIGN.apply(st, x, gains, use_kernels=True)
    plain = DESIGN.apply_plain(st, x, gains)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = DESIGN.apply(st, x, gains, use_kernels=True)
    graph.replay()
    torch.cuda.synchronize()
    for a, b, p in zip(eager, captured, plain):
        assert torch.equal(a, b)
        assert parity.snr_db(p, a) >= parity.EQ_SNR_MIN_DB


@pytest.mark.parametrize("ch", [1, 7, 1024])
@pytest.mark.parametrize("n", [32, 256, 2048])
def test_e1_phases_variant_is_the_kernel(cuda, ch, n):
    """`eq_phases` (the clock64-stamped build) gives the unstamped
    kernel's output and state bit for bit, and a stamps row a block of
    4 channels (a channel at up to 132) with every phase and the total
    counted."""
    rng = np.random.default_rng(ch + 11 * n)
    lead = (ch,) if ch > 1 else ()
    x = torch.from_numpy(eq_audio(rng, lead, n, 1)[0]).to(cuda)
    gains = torch.from_numpy(eq_gains(rng, lead)).to(cuda)
    st = torch.from_numpy(eq_state(rng, lead)).to(cuda)
    want = DESIGN.apply(st, x, gains, use_kernels=True)
    st_s, y_s, stamps = keq.eq_phases(DESIGN, st, x, gains)
    torch.cuda.synchronize()
    assert torch.equal(want[0], st_s) and torch.equal(want[1], y_s)
    blocks = ch if ch <= keq.FEW else -(-ch // keq.MANY_PER_BLOCK)
    assert stamps.shape == (blocks, len(keq.E1_PHASES) + 2)
    assert bool((stamps[:, 0] > 0).all() and (stamps[:, -2:] > 0).all())
    assert bool((stamps[:, :-2].sum(1) <= stamps[:, -2]).all())
