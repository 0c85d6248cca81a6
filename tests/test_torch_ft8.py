"""The port's FT8 decoder against t41x's on the CPU.

The waterfall in dB (within 0.05 dB wherever t41x's lies within 100
dB of its peak: below that a bin of a noise-free slot holds the FFT's
rounding noise, which differs between FFT implementations); the Costas
sync scores within 0.01 (T5: the 8-bin sum is a difference of a float32
running sum, rounded in another order) with no NaN left, and the top
candidates equal up to near-ties; the soft bits on the same candidates;
the LDPC decoder on noisy codewords at several SNRs (T6: the candidates
that reach 0 parity errors, and their bits, equal); `decode_audio` on
clean, noisy, two-signal, crowded (15 signals, three seeds), type-4,
telemetry and hash-resolving slots, t41x's own signals and the
independent generator's (`tests/fixtures/ft8_gen.py`): the same texts,
at the same time and frequency, scores within 0.01 on slots with noise;
and the slot manager with an injected clock.  The runner's ft8 mode and
`Radio`'s FT8 entry points are held in `tests/test_torch_ft8_radio.py`.

Two things hold only on slots with noise.  On a noise-free synthetic
slot the sync sum takes in bins of FFT rounding noise (-70 to -130 dB),
so scores there carry that noise (3 of ~150 on t41x's own signals, 63
of ~1240 on the independent generator's): there the decodes are
compared by text, time, frequency and bits, not score.  And there t41x's
decoder can accept the all-zero codeword (zero parity errors, CRC 0,
text "") where a candidate sees only digital silence; whether it does
rides on that rounding noise, in either package.  The port keeps t41x's
behaviour; the comparisons leave that codeword out.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.decode.ft8 import decode as j_dec, encode as j_enc
from t41x.decode.ft8 import ldpc as j_ldpc, message as j_msg
from t41x.decode.ft8 import slots as j_slots, sync as j_sync
from t41x.decode.ft8 import waterfall as j_wf
from t41x.io import signals
from t41x_torch.decode.ft8 import decode as t_dec
from t41x_torch.decode.ft8 import ldpc as t_ldpc, message as t_msg
from t41x_torch.decode.ft8 import slots as t_slots, sync as t_sync
from t41x_torch.decode.ft8 import waterfall as t_wf
from tests.fixtures import ft8_gen

torch.set_num_threads(1)

SCORE_TOL = 0.01           # T5, on slots with noise
SCORE_TOL_NOISE_FREE = None  # scores not compared (module docstring)
WF_TOL_DB = 0.05
WF_RANGE_DB = 100.0
SLOT = int(14 * C.AUDIO_RATE)
NOISE_FREE = ("clean", "two", "gen_type4", "gen_telemetry", "gen_hashed")


def _place(slot, audio, start_s):
    s = int(start_s * C.AUDIO_RATE)
    e = min(s + len(audio), len(slot))
    slot[s:e] += audio[: e - s]
    return slot


def _crowded(n_sig, seed):
    """tests/test_ft8.py's crowded band: n_sig signals over 0-2 s and
    400-2700 Hz, amplitudes over ~16 dB, in noise."""
    rng = np.random.default_rng(seed)
    calls = ["K1ABC", "W9XYZ", "N2DEF", "K5GHI", "W0JKL", "N8MNO",
             "K3PQR", "W4STU", "N6VWX", "K7YZA", "W1BCD", "N3EFG",
             "K9HIJ", "W5KLM", "N7NOP"]
    msgs = [f"CQ {calls[i]} FN{(i * 7) % 90:02d}" for i in range(n_sig)]
    slot = signals.awgn(int(14.5 * C.AUDIO_RATE), 0.1, seed=seed,
                        complex_=False).astype(np.float32)
    freqs = np.linspace(400.0, 2700.0, n_sig)
    rng.shuffle(freqs)
    amps = 0.08 * 10 ** (rng.uniform(0.0, 0.8, n_sig))
    for i, msg in enumerate(msgs):
        a = j_enc.synth_audio(j_enc.encode(msg), base_freq=float(freqs[i]),
                              amp=float(amps[i]))
        _place(slot, a, rng.uniform(0.0, 2.0))
    return slot


def _slot(kind):
    z = np.zeros(SLOT, np.float32)
    if kind == "clean":
        return _place(z, j_enc.synth_audio(j_enc.encode("CQ K1ABC FN42"),
                                           base_freq=1200.0), 1.0)
    if kind == "noisy":
        n = signals.awgn(SLOT, 0.2, seed=7, complex_=False).astype(np.float32)
        return _place(n, j_enc.synth_audio(j_enc.encode("K1ABC W9XYZ EM77"),
                                           base_freq=800.0, amp=0.1), 0.7)
    if kind == "two":
        _place(z, j_enc.synth_audio(j_enc.encode("CQ K1ABC FN42"),
                                    base_freq=900.0, amp=0.3), 0.5)
        return _place(z, j_enc.synth_audio(j_enc.encode("W9XYZ K1ABC -11"),
                                           base_freq=1800.0, amp=0.2), 1.1)
    if kind.startswith("crowded"):
        return _crowded(15, int(kind[-1]))
    if kind == "noise":
        return signals.awgn(int(14.5 * C.AUDIO_RATE), 0.15, seed=9,
                            complex_=False).astype(np.float32)
    gen = {"gen_type4": ("CQ PJ4/K1ABC", 1400.0, 0.5, 0.7),
           "gen_telemetry": ("0DEADBEEF012345678", 800.0, 0.5, 0.0),
           "gen_hashed": ("<W9XYZ> PJ4/K1ABC RR73", 1700.0, 0.5, 0.0)}
    if kind in gen:
        msg, f, amp, start = gen[kind]
        return _place(z, ft8_gen.synth(msg, base_freq=f, rate=C.AUDIO_RATE,
                                       amp=amp), start)
    assert kind == "gen_weak3"
    rng = np.random.default_rng(21)
    slot = (0.16 * rng.standard_normal(SLOT)).astype(np.float32)
    for msg, f, amp in (("CQ K1ABC FN42", 700.0, 0.35),
                        ("K1ABC W9XYZ EM77", 1250.0, 0.10),
                        ("W9XYZ K1ABC R-08", 1900.0, 0.10)):
        _place(slot, ft8_gen.synth(msg, base_freq=f, rate=C.AUDIO_RATE,
                                   amp=amp), 0.5)
    return slot


def _messages(decodes):
    """The decodes but the all-zero codeword (see the module docstring)."""
    return [d for d in decodes if d.bits77.any()]


def _same_decodes(got, want, score_tol=SCORE_TOL):
    got, want = _messages(got), _messages(want)
    assert sorted(d.text for d in got) == sorted(d.text for d in want)
    by_text = {d.text: d for d in want}
    for d in got:
        w = by_text[d.text]
        assert (d.time_offset, d.freq_hz, d.distance_km) == \
            (w.time_offset, w.freq_hz, w.distance_km), d.text
        if score_tol is not None:
            assert abs(d.score - w.score) <= score_tol, d.text
            assert abs(d.snr_db - w.snr_db) <= 0.2058 * score_tol, d.text
        np.testing.assert_array_equal(d.bits77, w.bits77)
    assert [f.name for f in dataclasses.fields(t_dec.Decoded)] == \
        [f.name for f in dataclasses.fields(j_dec.Decoded)]


@pytest.mark.parametrize("kind", ["clean", "crowded5"])
def test_waterfall_and_sync_scores(kind):
    slot = _slot(kind)
    want = np.array(j_wf.compute_waterfall(jnp.asarray(slot)))
    got = t_wf.compute_waterfall(torch.from_numpy(slot))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    got = got.numpy()
    above = want > want.max() - WF_RANGE_DB
    assert above.mean() > 0.8
    assert np.abs(got - want)[above].max() <= WF_TOL_DB

    j_scores = np.asarray(j_sync.sync_scores(jnp.asarray(want)))
    t_scores = t_sync.sync_scores(torch.from_numpy(want)).numpy()
    assert not np.isnan(t_scores).any()
    if kind not in NOISE_FREE:
        assert np.abs(t_scores - j_scores).max() <= SCORE_TOL

    # the top 96 up to near-ties: every t41x candidate scoring clearly
    # above the 96th is among the port's
    tol = 0.05 * abs(float(j_scores.max())) if kind in NOISE_FREE \
        else SCORE_TOL
    jc = j_sync.top_candidates(jnp.asarray(j_scores), 96)
    tc = t_sync.top_candidates(torch.from_numpy(t_scores), 96)
    key = lambda c, i: tuple(int(np.asarray(a)[i]) for a in c[1:])  # noqa
    t_set = {key(tc, i) for i in range(96)}
    kth = float(np.asarray(jc.score)[-1])
    clear = [i for i in range(96)
             if float(np.asarray(jc.score)[i]) > kth + 2 * tol]
    assert len(clear) > 48
    assert all(key(jc, i) in t_set for i in clear)


def test_extract_llrs_on_the_same_candidates():
    slot = _slot("crowded6")
    wf = np.array(j_wf.compute_waterfall(jnp.asarray(slot)))
    jc = j_sync.find_candidates(jnp.asarray(wf), 48)
    tc = t_sync.Candidates(*(torch.from_numpy(np.asarray(a).astype(
        np.float32 if i == 0 else np.int64)) for i, a in enumerate(jc)))
    want = np.asarray(j_dec.extract_llrs(jnp.asarray(wf), jc))
    got = t_dec.extract_llrs(torch.from_numpy(wf), tc).numpy()
    assert got.shape == want.shape == (48, 174)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("snr", [2.0, 2.5, 3.0, 4.0])
def test_bp_decode_zero_error_set(snr):
    """T6: noisy codewords of several messages; the candidates that
    reach 0 parity errors, and their bits, equal t41x's."""
    rng = np.random.default_rng(int(snr * 10))
    texts = ["CQ K1ABC FN42", "K1ABC W9XYZ EM77", "W9XYZ K1ABC -11",
             "CQ PJ4/K1ABC"]
    cws = np.asarray([j_enc.encode_bits(j_msg.pack77(texts[i % 4]))
                      for i in range(64)])
    llr = ((2.0 * cws - 1.0) * snr
           + 2.0 * rng.standard_normal(cws.shape)).astype(np.float32)
    want = j_ldpc.bp_decode(jnp.asarray(llr))
    got = t_ldpc.bp_decode(torch.from_numpy(llr))
    assert got.bits.dtype == torch.uint8 and got.errors.dtype == torch.int32
    ok_j = np.asarray(want.errors) == 0
    ok_t = got.errors.numpy() == 0
    np.testing.assert_array_equal(ok_t, ok_j)
    np.testing.assert_array_equal(got.bits.numpy()[ok_t],
                                  np.asarray(want.bits)[ok_j])
    np.testing.assert_array_equal(got.bits.numpy()[ok_t], cws[ok_t])
    if snr >= 4.0:
        assert ok_t.all()
    if snr <= 2.0:
        assert 0 < ok_t.sum() < len(ok_t)


@pytest.mark.parametrize("kind", [
    "clean", "noisy", "two", "crowded5", "crowded6", "crowded7", "noise",
    "gen_type4", "gen_telemetry", "gen_weak3"])
def test_decode_audio_matches_t41x(kind):
    slot = _slot(kind)
    want = j_dec.decode_audio(slot, my_grid="FN31")
    got = t_dec.decode_audio(slot, my_grid="FN31", device="cpu")
    _same_decodes(got, want, SCORE_TOL_NOISE_FREE if kind in NOISE_FREE
                  else SCORE_TOL)
    if kind.startswith("crowded"):
        assert len(got) == 15
    elif kind == "noise":
        assert got == []
    else:
        assert got


def test_decode_fixed_candidates_and_geometry():
    slot = _slot("two")
    _same_decodes(t_dec.decode_audio(slot, k_candidates=20, device="cpu"),
                  j_dec.decode_audio(slot, k_candidates=20),
                  SCORE_TOL_NOISE_FREE)
    # a non-default geometry decodes the full pool
    _same_decodes(t_dec.decode_audio(slot, base_bin_hz=6.0, device="cpu"),
                  j_dec.decode_audio(slot, base_bin_hz=6.0),
                  SCORE_TOL_NOISE_FREE)


def test_hash_table_resolves_across_slots():
    first = _place(np.zeros(SLOT, np.float32), ft8_gen.synth(
        "CQ W9XYZ EM77", base_freq=1000.0, rate=C.AUDIO_RATE), 0.0)
    second = _slot("gen_hashed")
    jh, th = j_msg.CallHashTable(), t_msg.CallHashTable()
    for slot in (first, second):
        want = j_dec.decode_audio(slot, hashes=jh)
        got = t_dec.decode_audio(slot, hashes=th, device="cpu")
        _same_decodes(got, want, SCORE_TOL_NOISE_FREE)
    assert "<W9XYZ> PJ4/K1ABC RR73" in [d.text for d in got]


def test_slot_manager_with_an_injected_clock(monkeypatch):
    """The copy aligns, buffers and cuts slots as t41x's does; its
    default decode_fn is the port's decoder (on the card)."""
    rng = np.random.default_rng(4)
    sizes = rng.integers(100, 3000, 800)
    rate = C.AUDIO_RATE
    runs = []
    for mod in (t_slots, j_slots):
        calls = []

        def decode_fn(a, calls=calls):
            calls.append((len(a), float(a.sum())))
            return [len(calls)]

        sm = mod.SlotManager(decode_fn,
                             clock=lambda: 7.3 + sm.samples_fed / rate)
        out = []
        for i, n in enumerate(sizes):
            out.append(sm.feed(np.full(n, i % 7, np.float32)))
        runs.append((out, calls, sm.results, sm.slots_decoded, sm.buffered,
                     sm.synced))
    assert runs[0] == runs[1]
    assert runs[0][3] >= 2

    seen = []
    monkeypatch.setattr(t_dec, "decode_audio",
                        lambda a, **kw: seen.append(kw) or [])
    t_slots.SlotManager(clock=lambda: 0.0, my_grid="FN42").feed(
        np.zeros(int(15 * rate), np.float32))
    assert len(seen) == 1 and seen[0]["my_grid"] == "FN42"
    assert isinstance(seen[0]["hashes"], t_msg.CallHashTable)
