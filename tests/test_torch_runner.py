"""t41x_torch.runner.StreamRunner against t41x.runner.StreamRunner.

Both runners take the same ring input: 2 channels, 6 blocks of a tone at
a clipping (q15 half-scale) level with auto RF gain on, a band switch
(20M usb -> 40M lsb, a new chain) after 4 blocks, and `batch_blocks` 1
and 2.  The port runs eagerly on the CPU (`graphs=False` is implied by a
CPU radio); t41x runs its jitted XLA chain.  The audio holds >= 55 dB
SNR, the displayed RF and audio spectra <= 0.5 dB, the S-meter 0.01 dB;
`blocks_processed` and the band RF gain's trajectory (Codec_gain) are
equal.  t41x's `step` raises for a channel batch (it converts the
(channels,) S-meter to one float), so at `batch_blocks` 1 the port's
`step` is held against t41x's `step_batch` of one block; the operator
channel is channel 0 in both.  A mono stream holds `step` against
`step`.  `prime()` leaves the state and the ring untouched.  No
wall-clock assertion.
"""

import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.chain.codec_gain import CodecGain as JCodecGain
from t41x.radio import Radio as JRadio
from t41x.runner import StreamRunner as JRunner
from t41x_torch.chain.codec_gain import CodecGain
from t41x_torch.radio import Radio
from t41x_torch.runner import StreamRunner
from t41x_torch.utils import checkpoint, parity

torch.set_num_threads(1)

N_BLOCKS, SWITCH = 6, 4


def _blocks(ch, seed=31):
    rng = np.random.default_rng(seed)
    n = N_BLOCKS * C.BLOCK_SIZE
    t = np.arange(n) / C.SAMPLE_RATE
    tone = 0.55 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + 1100.0) * t)
    level = np.linspace(1.0, 0.6, max(int(np.prod(ch)), 1)).reshape(
        ch + (1,))
    iq = tone * level + 0.02 * (rng.standard_normal(ch + (n,))
                                + 1j * rng.standard_normal(ch + (n,)))
    iq = iq.astype(np.complex64)
    return [np.ascontiguousarray(iq[..., b * C.BLOCK_SIZE:
                                    (b + 1) * C.BLOCK_SIZE])
            for b in range(N_BLOCKS)]


def _setup(radio):
    radio.set_auto_rf_gain(True)
    radio.config.band.rf_gain = 5
    radio.set_fine_tune(300.0)


def _drive(runner, step, blocks):
    """Feed the blocks (switching band after SWITCH) and record after
    each call what the host sees."""
    trace = []
    for b, blk in enumerate(blocks):
        if b == SWITCH:
            runner.radio.set_band("40M")
        runner.ring.push(blk.view(np.float32).reshape(-1))
        if runner.ring.available() >= runner.batch_blocks:
            assert step() is not None
            trace.append(dict(
                blocks=runner.blocks_processed,
                gains=[bd.rf_gain for bd in runner.radio.config.bands],
                rf=runner.last_rf_spectrum_db,
                audio_spectrum=runner.last_audio_spectrum,
                smeter=runner.last_smeter_dbm))
    return trace


def _runners(ch, batch, **kw):
    j, t = JRadio(), Radio(device="cpu")
    _setup(j)
    _setup(t)
    jr = JRunner(j, channels=ch, batch_blocks=batch, **kw)
    tr = StreamRunner(t, channels=ch, batch_blocks=batch, **kw)
    # start Codec_gain's holdoff near its end, so that the 6 blocks see a
    # gain step (DECREASE_HOLDOFF is 20 blocks)
    for r, cg in ((jr, JCodecGain), (tr, CodecGain)):
        r._codec_gain = cg()
        r._codec_gain.timer = 17
        r.keep_audio = True
    return jr, tr


def _compare(jr, tr, jtrace, ttrace, ch0_of_port):
    assert len(jtrace) == len(ttrace) > 0
    for jt, tt in zip(jtrace, ttrace):
        assert tt["blocks"] == jt["blocks"]
        assert tt["gains"] == jt["gains"]
        rf, aus = tt["rf"], tt["audio_spectrum"]
        if ch0_of_port:
            rf, aus = rf[ch0_of_port], aus[ch0_of_port]
        assert rf.shape == jt["rf"].shape
        assert parity.spectrum_err_db(10 ** (jt["rf"] / 10),
                                      10 ** (rf / 10)) <= 0.5
        assert parity.spectrum_err_db(jt["audio_spectrum"], aus) <= 0.5
        assert abs(tt["smeter"] - jt["smeter"]) <= 0.01
    gains = [t["gains"] for t in jtrace]
    assert gains[0] != gains[-1], "Codec_gain never stepped"
    assert tr.audio.shape == jr.audio.shape
    assert parity.snr_db(jr.audio, tr.audio) >= parity.AUDIO_SNR_MIN_DB
    assert tr.blocks_processed == jr.blocks_processed == N_BLOCKS


@pytest.mark.parametrize("batch", [1, 2])
def test_runner_matches_t41x_on_a_channel_batch(batch):
    ch = (2,)
    jr, tr = _runners(ch, batch, display_every=1)
    blocks = _blocks(ch)
    jtrace = _drive(jr, jr.step_batch, blocks)
    ttrace = _drive(tr, tr.step if batch == 1 else tr.step_batch, blocks)
    _compare(jr, tr, jtrace, ttrace, (0,) if batch == 1 else ())


def test_runner_step_matches_t41x_step_mono():
    jr, tr = _runners((), 1)
    blocks = _blocks(())
    _compare(jr, tr, _drive(jr, jr.step, blocks), _drive(tr, tr.step, blocks),
             ())
    assert tr.load.percent > 0


def test_prime_leaves_state_and_ring_untouched():
    radio = Radio(device="cpu")
    runner = StreamRunner(radio, channels=(2,), batch_blocks=2)
    runner.state = checkpoint.map_leaves(
        lambda _, t: torch.full_like(t, 3), runner.state)
    before = [t.clone() for _, t in checkpoint.flatten_with_path(
        runner.state)]
    for blk in _blocks((2,))[:3]:
        runner.ring.push(blk.view(np.float32).reshape(-1))
    runner.prime()
    after = [t for _, t in checkpoint.flatten_with_path(runner.state)]
    assert len(before) == len(after)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert runner.ring.available() == 3
    assert runner.blocks_processed == 0


def test_state_setter_resumes_bit_for_bit():
    blocks = _blocks((2,))
    ref = StreamRunner(Radio(device="cpu"), channels=(2,))
    ref.keep_audio = True
    for blk in blocks:
        ref.ring.push(blk.view(np.float32).reshape(-1))
    ref.drain()
    first = StreamRunner(Radio(device="cpu"), channels=(2,))
    for blk in blocks[:3]:
        first.ring.push(blk.view(np.float32).reshape(-1))
    first.drain()
    resumed = StreamRunner(Radio(device="cpu"), channels=(2,))
    resumed.keep_audio = True
    resumed.state = first.state
    for blk in blocks[3:]:
        resumed.ring.push(blk.view(np.float32).reshape(-1))
    resumed.drain()
    np.testing.assert_array_equal(resumed.audio, ref.audio[2 * 3:])
    with pytest.raises(ValueError):
        resumed.state = StreamRunner(Radio(device="cpu"),
                                     channels=(3,)).state


def test_ft8_mode_raises_until_the_decoder_slice():
    """Since the decoder slice the ft8 mode runs: `prime` builds the
    chain and the FT8 slot manager, on the radio's device, and leaves
    the state untouched (the slots are held against t41x's in
    tests/test_torch_ft8_radio.py)."""
    radio = Radio(device="cpu")
    radio.set_mode("ft8")
    runner = StreamRunner(radio, slot_clock=lambda: 3.0)
    runner.prime()
    slots = runner._ft8_slots
    assert slots is not None and slots.clock() == 3.0
    assert slots.decode_fn.keywords["device"] == radio.device
    assert slots.slots_decoded == 0 and runner.blocks_processed == 0


@pytest.mark.parametrize("late_ms", [0.0, 25.0])
def test_ft8_slot_sync_on_a_late_feed(late_ms):
    """A live feed reads the slot clock some time after its audio was
    captured.  Feeds one block apart with the clock 14.8 s at the first,
    and from the 18th feed on (the block that holds the 15 s boundary)
    each one `late_ms` later, as after a slow step: the runner's slot
    manager syncs on that block either way, and skips the boundary's
    offset into it; t41x's wiring (its `SlotManager` reading the clock at
    each feed) steps past the boundary when the feed is late."""
    from t41x.decode.ft8.slots import SlotManager as JSlots

    radio = Radio(device="cpu")
    radio.set_mode("ft8")
    k = [0]

    def clock():
        return 14.8 + k[0] * C.BLOCK_SECONDS + (late_ms / 1e3 if k[0] >= 18
                                                else 0.0)

    runner = StreamRunner(radio, slot_clock=clock)
    runner.prime()
    port, ref = runner._ft8_slots, JSlots(decode_fn=list, clock=clock)
    n = C.BLOCK_SIZE // C.DF
    synced_at = {}
    for k[0] in range(24):
        a = np.arange(k[0] * n, (k[0] + 1) * n, dtype=np.float32)
        for name, slots in (("port", port), ("ref", ref)):
            slots.feed(a)
            if slots.synced and name not in synced_at:
                synced_at[name] = (k[0], slots.buffer[0][0])
    # the boundary is 0.2 s (4800 samples) in: block 18, sample 192, to
    # the one sample of the manager's truncation of a float time
    assert synced_at["port"][0] == 18
    assert abs(synced_at["port"][1] - 4800.0) <= 1.0
    assert ("ref" in synced_at) == (late_ms == 0.0)


def test_live_cw_text_matches_t41x():
    """The runner's CW decoder, fed block by block (AGC off: the plain
    AGC recurrence runs sample by sample on the CPU)."""
    from t41x.io import signals

    n = int(3.0 * C.SAMPLE_RATE) // C.BLOCK_SIZE * C.BLOCK_SIZE
    iq = (signals.cw_signal("TEST", 18.0, n) * 0.3
          + signals.awgn(n, 0.003, seed=5)).astype(np.complex64)
    texts = []
    for radio, runner_cls in ((JRadio(), JRunner),
                              (Radio(device="cpu"), StreamRunner)):
        radio.set_mode("cw")
        radio.set_agc(0)
        runner = runner_cls(radio)
        text = ""
        for b in range(n // C.BLOCK_SIZE):
            runner.ring.push(iq[b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
                             .view(np.float32))
            text += runner.step().get("cw_text", "")
        texts.append(text)
    assert texts[0].strip() == "TEST"
    assert texts[1] == texts[0]
