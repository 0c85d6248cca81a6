"""The port's StreamRunner on the card: CUDA graph replays against the
eager chain.

Every case here needs a CUDA card and skips without one; the file
imports nothing of `t41x` or JAX, so the card's machine runs it as

    python -m pytest --noconftest -m gpu tests/test_torch_runner_gpu.py

It holds the graphed runner against a plain loop of `RxChain.block` on
the card, bit for bit, at 1, 7 and 1024 channels (and with the SAM PLL,
Kim NR and LMS kernels at 7), `step_batch` against `step`, a spec change
that captures anew and releases the old graph's memory, a checkpoint
round trip, `prime()`, which must leave the state untouched, and the
capture's device: the graph and its kernels' launches enter the chain's
card.
"""

import numpy as np
import pytest
import torch

from t41x_torch import constants as C
from t41x_torch.chain import RxChain
from t41x_torch.dsp.spectrum import smeter_dbm
from t41x_torch.radio import Radio
from t41x_torch.runner import StreamRunner
from t41x_torch.utils import checkpoint

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _blocks(ch: int, n: int, seed: int = 3, carrier: float = 1500.0):
    """n blocks of (ch, BLOCK) complex64: a tone `carrier` Hz above the
    Fs/4-shifted tuning in noise, the level spread over the channels."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * C.BLOCK_SIZE) / C.SAMPLE_RATE
    tone = 0.3 * np.exp(2j * np.pi * (-C.SAMPLE_RATE / 4 + carrier) * t)
    level = np.linspace(0.5, 1.5, ch)[:, None]
    iq = (tone * level + 0.05 * (rng.standard_normal((ch, t.size))
                                 + 1j * rng.standard_normal((ch, t.size)))
          ).astype(np.complex64)
    return [np.ascontiguousarray(iq[:, b * C.BLOCK_SIZE:
                                    (b + 1) * C.BLOCK_SIZE])
            for b in range(n)]


def _feed(runner, blocks):
    for blk in blocks:
        runner.ring.push(blk.view(np.float32).reshape(-1))
    return runner.drain()


def _radio(cuda, mode=None, nr=None):
    radio = Radio(device=cuda)
    if mode:
        radio.set_mode(mode)
    if nr is not None:
        radio.set_nr(nr)
    radio.set_fine_tune(-120.0)
    return radio


def _eager(radio, blocks, ch):
    """The plain loop: a fresh chain of the radio's spec on the card,
    `block` after `block` with the radio's parameters."""
    chain = RxChain(radio.chain.spec, device=radio.device)
    params = radio.params((ch,))
    st = chain.init_state((ch,))
    outs = []
    for blk in blocks:
        st, out = chain.block(params, st, torch.from_numpy(blk).to(
            radio.device))
        outs.append({k: v.cpu().numpy() for k, v in out.items()})
    return st, outs


@pytest.mark.parametrize("ch,mode,nr", [
    (1, None, None), (7, None, None), (1024, None, None), (7, "sam", None),
    (7, None, 1), (7, None, 3)])
def test_graph_replay_equals_eager_loop(cuda, ch, mode, nr):
    radio = _radio(cuda, mode, nr)
    blocks = _blocks(ch, 6, carrier=30.0 if mode == "sam" else 1500.0)
    runner = StreamRunner(radio, channels=(ch,))
    runner.keep_audio = True
    assert _feed(runner, blocks) == 6
    assert set(runner._graph_of) == {"block"}
    st, outs = _eager(radio, blocks, ch)
    np.testing.assert_array_equal(
        runner.audio, np.concatenate([o["audio_24k"] for o in outs]))
    np.testing.assert_array_equal(
        runner.last_rf_spectrum_db,
        10 * np.log10(outs[-1]["rf_spectrum"] + 1e-12))
    np.testing.assert_array_equal(runner.last_audio_spectrum,
                                  outs[-1]["audio_spectrum"])
    assert runner.last_smeter_dbm == float(smeter_dbm(torch.from_numpy(
        outs[-1]["smeter_avg"][:1])))
    for (path, a), (_, b) in zip(checkpoint.flatten_with_path(runner.state),
                                 checkpoint.flatten_with_path(st),
                                 strict=True):
        assert torch.equal(a, b), path


def test_graph_captures_on_its_chains_card(cuda, monkeypatch):
    """The warm-up and the capture run inside `torch.cuda.device` of the
    chain's card, and so does every kernel launch in them."""
    from t41x_torch import runner as runner_mod
    entered, at_capture = [], []

    class recorder(torch.cuda.device):
        # a subclass, so that torch's own isinstance checks still hold
        def __init__(self, device):
            entered.append(device)
            super().__init__(device)

    capture = runner_mod._Graph._capture

    def recorded_capture(self, fn, state, dev):
        at_capture.append((entered[-1], torch.cuda.current_device()))
        return capture(self, fn, state, dev)

    monkeypatch.setattr(torch.cuda, "device", recorder)
    monkeypatch.setattr(runner_mod._Graph, "_capture", recorded_capture)
    runner = StreamRunner(_radio(cuda), channels=(7,))
    assert _feed(runner, _blocks(7, 2)) == 2
    dev = runner._graph_of["block"].iq.device
    assert dev.type == "cuda" and dev.index is not None
    assert at_capture == [(dev, dev.index)]
    # the kernels' launches in the warm-up and the capture entered it too
    launches = [d for d in entered if isinstance(d, torch.device)]
    assert len(launches) > 2 and set(launches) == {dev}


def test_step_batch_equals_step(cuda):
    blocks = _blocks(7, 8)
    runs = []
    for batch in (1, 4):
        runner = StreamRunner(_radio(cuda), channels=(7,),
                              batch_blocks=batch, display_every=1)
        runner.keep_audio = True
        assert _feed(runner, blocks) == 8
        runs.append(runner)
    one, four = runs
    assert set(four._graph_of) == {"batch"}
    np.testing.assert_array_equal(
        np.concatenate(four.audio_chunks, axis=-1),
        np.concatenate(one.audio_chunks, axis=-1))
    np.testing.assert_array_equal(four.last_rf_spectrum_db,
                                  one.last_rf_spectrum_db[0])
    assert four.last_smeter_dbm == one.last_smeter_dbm
    assert four.blocks_processed == one.blocks_processed == 8


def test_spec_change_captures_anew_and_releases(cuda):
    radio = _radio(cuda)
    runner = StreamRunner(radio, channels=(64,))
    blocks = _blocks(64, 2)
    _feed(runner, blocks)
    first = runner._graph_of["block"]
    radio.set_volume(80)             # a parameter: the same graph
    _feed(runner, blocks)
    assert runner._graph_of["block"] is first
    torch.cuda.synchronize()
    used = []
    for mode in ("lsb", "usb") * 4:
        radio.set_mode(mode)         # a new spec: a new graph
        _feed(runner, blocks)
        assert runner._graph_of["block"] is not first
        torch.cuda.synchronize()
        used.append((torch.cuda.memory_allocated(),
                     torch.cuda.memory_reserved()))
    # flipping specs holds memory level: the old graphs' pools go
    assert used[-1][0] <= used[1][0] + (1 << 20), used
    assert used[-1][1] <= used[1][1] + (8 << 20), used


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    blocks = _blocks(33, 8)
    whole = StreamRunner(_radio(cuda), channels=(33,))
    whole.keep_audio = True
    _feed(whole, blocks)
    first = StreamRunner(_radio(cuda), channels=(33,))
    _feed(first, blocks[:4])
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, first.state,
                          extra={"blocks": first.blocks_processed})
    resumed = StreamRunner(_radio(cuda), channels=(33,))
    resumed.keep_audio = True
    state, meta = checkpoint.load_state(path, resumed.state)
    assert all(t.is_cuda for _, t in checkpoint.flatten_with_path(state))
    resumed.state = state
    resumed.blocks_processed = meta["blocks"]
    _feed(resumed, blocks[4:])
    np.testing.assert_array_equal(resumed.audio, whole.audio[33 * 4:])
    assert resumed.blocks_processed == whole.blocks_processed == 8


def test_prime_leaves_the_state_untouched(cuda):
    # a live state that is not the initial one
    earlier = StreamRunner(_radio(cuda), channels=(7,), graphs=False)
    _feed(earlier, _blocks(7, 3, seed=9))
    runner = StreamRunner(_radio(cuda), channels=(7,), batch_blocks=2)
    runner.state = earlier.state
    before = [t.clone() for _, t in checkpoint.flatten_with_path(
        runner.state)]
    for blk in _blocks(7, 3):
        runner.ring.push(blk.view(np.float32).reshape(-1))
    runner.prime()
    torch.cuda.synchronize()
    assert set(runner._graph_of) == {"batch"}
    for a, (path, b) in zip(before, checkpoint.flatten_with_path(
            runner.state)):
        assert torch.equal(a, b), path
    assert runner.ring.available() == 3 and runner.blocks_processed == 0
