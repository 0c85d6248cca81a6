"""The port's FT8 entry points against t41x's on the CPU: the
runner's ft8 mode (the slot manager fed channel 0's audio after each
block, or each batch of blocks, decoding eagerly) against t41x's
`StreamRunner.step` on one synthetic slot with an injected slot clock,
and `Radio.transmit_ft8` / `decode_ft8`.  Decodes compare as in
`tests/test_torch_ft8.py` on noise-free slots: text, time, frequency and
bits, the all-zero codeword left out.
"""

import numpy as np
import torch

from t41x import constants as C
from t41x.decode.ft8 import encode as j_enc
from t41x.radio import Radio as JRadio
from t41x.runner import StreamRunner as JRunner
from t41x_torch.decode.ft8 import encode as t_enc
from t41x_torch.radio import Radio
from t41x_torch.runner import StreamRunner
from tests.test_torch_ft8 import SCORE_TOL_NOISE_FREE, _messages, _same_decodes

torch.set_num_threads(1)


def _ft8_stream(runner_cls, radio, iq, batch):
    radio.set_mode("ft8")
    radio.set_agc(0)   # the plain AGC recurrence is per sample on the CPU
    runner = None

    def clock():
        # the next 15 s boundary falls 0.2 s into the stream
        return 14.8 + runner.blocks_processed * C.BLOCK_SECONDS

    runner = runner_cls(radio, slot_clock=clock, batch_blocks=batch)
    decoded = []
    for b in range(len(iq) // C.BLOCK_SIZE):
        runner.ring.push(iq[b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
                         .view(np.float32))
        r = runner.step_batch() if batch > 1 else runner.step()
        if r is not None and r.get("ft8"):
            decoded.append((runner.blocks_processed, r["ft8"]))
    return decoded


def test_runner_ft8_mode_matches_t41x():
    msg = "CQ K1ABC FN42"
    iq = j_enc.synth_iq(msg, base_freq=1000.0, amp=0.4, pad_start_s=0.5,
                        pad_end_s=2.3)
    want = _ft8_stream(JRunner, JRadio(), iq, 1)
    got = _ft8_stream(StreamRunner, Radio(device="cpu"), iq, 1)
    assert len(got) == len(want) == 1
    assert got[0][0] == want[0][0]
    _same_decodes(got[0][1], want[0][1], SCORE_TOL_NOISE_FREE)
    assert msg in [d.text for d in got[0][1]]
    # batches of 4 blocks feed the slots the same audio
    batched = _ft8_stream(StreamRunner, Radio(device="cpu"), iq, 4)
    assert len(batched) == 1
    assert [d.text for d in _messages(batched[0][1])] == \
        [d.text for d in _messages(got[0][1])]


def test_radio_transmit_and_decode_ft8():
    j, t = JRadio(), Radio(device="cpu")
    for r in (j, t):
        r.set_fine_tune(300.0)
        r.config.my_grid = "EM12"
    iq = t.transmit_ft8("CQ K1ABC FN42", base_freq=1500.0)
    np.testing.assert_array_equal(iq, j.transmit_ft8("CQ K1ABC FN42",
                                                     base_freq=1500.0))
    np.testing.assert_array_equal(
        t_enc.encode("K1ABC W9XYZ EM77"), j_enc.encode("K1ABC W9XYZ EM77"))
    for r in (j, t):
        r.set_agc(0)   # the plain AGC recurrence is per sample on the CPU
    want, got = j.decode_ft8(iq), t.decode_ft8(iq)
    _same_decodes(got, want, SCORE_TOL_NOISE_FREE)
    assert [d.text for d in _messages(got)] == ["CQ K1ABC FN42"]
    assert got[0].distance_km is not None
    assert t.config.to_dict() == j.config.to_dict()
