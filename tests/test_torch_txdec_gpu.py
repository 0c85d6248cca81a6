"""The transmit chains' kernel and the decoders on the card.

Every case here needs a CUDA card and skips without one; the file
imports nothing of `t41x` or JAX, so the card's machine runs it as

    python -m pytest --noconftest -m gpu tests/test_torch_txdec_gpu.py

C1 (the mic compressor, `t41x_torch/csrc/compressor.cu`) against its
plain loop on the card, bit for bit, at 1, 7, 130, 1024 and 4096
channels (not all a multiple of its 8 a block) and n 1, 63, 64, 127,
129, 200, 513 and 2048 (under and over its chunk of 128 samples and its
ring of 4 chunks), from random carried envelopes that reach both the
attack and the release branch, launched through `compress` and with its
`clock64` stamps, and at ties and signed zeros (its select is a
bitwise mask of the comparison); the LDPC decoder on the card twice, bit equal
(it gathers instead of scattering with atomics), and equal to the CPU's;
a crowded 15-signal FT8 slot decoded on the card as on the CPU; and the
SSB exciter's kernel path against its plain path on the card.
"""

import numpy as np
import pytest
import torch

from t41x_torch import constants as C
from t41x_torch.chain import compressor as comp_mod, tx
from t41x_torch.decode.ft8 import decode as ft8, encode, ldpc, message
from t41x_torch.io import signals
from t41x_torch.kernels import compressor as kcomp
from t41x_torch.utils import parity

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _attack_count(p, env0, x):
    """Samples that take the attack branch, by a float64 host loop."""
    ldb = 20 * np.log10(np.maximum(np.abs(x), 1e-9))
    env, n_up = env0.astype(np.float64), 0
    for n in range(x.shape[-1]):
        up = ldb[:, n] > env
        n_up += int(up.sum())
        c = np.where(up, p.attack_coeff, p.release_coeff)
        env = c * env + (1 - c) * ldb[:, n]
    return n_up


@pytest.mark.parametrize("n", [1, 63, 64, 127, 129, 200, 513, 2048])
@pytest.mark.parametrize("channels", [1, 7, 130, 1024, 4096])
def test_c1_equals_its_plain_loop(cuda, channels, n):
    rng = np.random.default_rng(channels * 7 + n)
    p = comp_mod.compressor_params(rate=C.SAMPLE_RATE)
    env0 = rng.uniform(-80.0, 10.0, channels).astype(np.float32)
    # each channel quiet, then loud: release, then attack, whatever the
    # carried envelope
    burst = np.where(np.arange(n) < n // 2, 1e-3, 3.0)
    x = (rng.standard_normal((channels, n)) * burst
         * np.logspace(-0.5, 0.0, channels)[:, None]).astype(np.float32)
    st = comp_mod.CompressorState(torch.from_numpy(env0).to(cuda))
    xt = torch.from_numpy(x).to(cuda)
    before = kcomp.launch.launches
    for _ in range(2):   # a carried state in, then the state it left
        st_k, y_k = comp_mod.compress(p, st, xt)
        st_p, y_p = comp_mod.compress_plain(p, st, xt)
        st_s, y_s, stamps = kcomp.compress_phases(p, st, xt)
        torch.cuda.synchronize()
        assert torch.equal(y_k, y_p) and torch.equal(y_s, y_p)
        assert torch.equal(st_k.env_db, st_p.env_db)
        assert torch.equal(st_s.env_db, st_p.env_db)
        # the stamped launch: every role's busy row and the block took
        # time; the waits on the ring may be 0
        assert stamps.shape == (-(-channels // 8), len(kcomp.C1_PHASES) + 2)
        waits = [i for i, nm in enumerate(kcomp.C1_PHASES) if "wait" in nm]
        busy = [i for i in range(stamps.shape[1]) if i not in waits]
        assert waits == [2, 4]
        assert bool((stamps[:, busy] > 0).all())
        assert bool((stamps[:, waits] >= 0).all())
        st = st_k
    assert kcomp.launch.launches == before + 4
    if channels * n >= 64:
        n_up = _attack_count(p, env0, x)
        assert 0 < n_up < channels * n


def test_c1_selects_as_the_comparison_at_ties_and_signed_zeros(cuda):
    """C1 selects attack or release by a mask of `ldb > env`: at ldb ==
    env (samples of exactly +-1 give ldb = +0 against a carried +0 or
    -0), and from carried envelopes of +-0, it still equals the plain
    loop's `ldb > env` bit for bit."""
    rng = np.random.default_rng(17)
    p = comp_mod.compressor_params(rate=C.SAMPLE_RATE)
    channels, n = 9, 200
    env0 = rng.uniform(-80.0, 10.0, channels).astype(np.float32)
    env0[:4] = (-0.0, 0.0, -0.0, 0.0)
    x = (rng.standard_normal((channels, n)) * 0.5).astype(np.float32)
    x[:, ::2] = np.where(x[:, ::2] < 0, -1.0, 1.0)
    x[:2, :8] = 1.0        # ldb = +0 == the carried envelope, 8 steps
    x[2:4, :8] = 0.0       # the level floor: release from +-0
    st = comp_mod.CompressorState(torch.from_numpy(env0).to(cuda))
    xt = torch.from_numpy(x).to(cuda)
    st_k, y_k = comp_mod.compress(p, st, xt)
    st_p, y_p = comp_mod.compress_plain(p, st, xt)
    torch.cuda.synchronize()
    assert torch.equal(y_k, y_p) and torch.equal(st_k.env_db, st_p.env_db)
    # the bits too: +0 and -0 compare equal
    assert torch.equal(y_k.view(torch.int32), y_p.view(torch.int32))
    assert torch.equal(st_k.env_db.view(torch.int32),
                       st_p.env_db.view(torch.int32))


def test_c1_refuses_what_it_does_not_take(cuda):
    p = comp_mod.compressor_params()
    st = comp_mod.compressor_state((4,), cuda)
    with pytest.raises(ValueError):
        comp_mod.compress(p, st, torch.zeros(4, 8, dtype=torch.float64,
                                             device=cuda))
    with pytest.raises(ValueError):
        comp_mod.compress(p, comp_mod.compressor_state((3,), cuda),
                          torch.zeros(4, 8, device=cuda))


def test_bp_decode_is_deterministic_on_the_card(cuda):
    rng = np.random.default_rng(5)
    cws = np.asarray([encode.encode_bits(message.pack77(m)) for m in
                      ("CQ K1ABC FN42", "K1ABC W9XYZ EM77") * 48])
    llr = ((2.0 * cws - 1.0) * 2.5 + 2.0 * rng.standard_normal(cws.shape)
           ).astype(np.float32)
    llr_t = torch.from_numpy(llr)
    a = ldpc.bp_decode(llr_t.to(cuda))
    b = ldpc.bp_decode(llr_t.to(cuda))
    cpu = ldpc.bp_decode(llr_t)
    assert torch.equal(a.bits, b.bits) and torch.equal(a.errors, b.errors)
    ok = a.errors.cpu() == 0
    assert 0 < int(ok.sum()) < len(ok)
    assert torch.equal(ok, cpu.errors == 0)
    assert torch.equal(a.bits.cpu()[ok], cpu.bits[ok])


def _crowded_slot(seed=5):
    rng = np.random.default_rng(seed)
    calls = ["K1ABC", "W9XYZ", "N2DEF", "K5GHI", "W0JKL", "N8MNO",
             "K3PQR", "W4STU", "N6VWX", "K7YZA", "W1BCD", "N3EFG",
             "K9HIJ", "W5KLM", "N7NOP"]
    msgs = [f"CQ {c} FN{(i * 7) % 90:02d}" for i, c in enumerate(calls)]
    slot = signals.awgn(int(14.5 * C.AUDIO_RATE), 0.1, seed=seed,
                        complex_=False).astype(np.float32)
    freqs = np.linspace(400.0, 2700.0, len(msgs))
    rng.shuffle(freqs)
    amps = 0.08 * 10 ** (rng.uniform(0.0, 0.8, len(msgs)))
    for i, m in enumerate(msgs):
        a = encode.synth_audio(encode.encode(m), base_freq=float(freqs[i]),
                               amp=float(amps[i]))
        s = int(rng.uniform(0.0, 2.0) * C.AUDIO_RATE)
        e = min(s + len(a), len(slot))
        slot[s:e] += a[: e - s]
    return slot, msgs


def test_crowded_slot_decodes_on_the_card_as_on_the_cpu(cuda):
    slot, msgs = _crowded_slot()
    gpu = ft8.decode_audio(slot, device=cuda)
    cpu = ft8.decode_audio(slot, device="cpu")
    assert sorted(d.text for d in gpu) == sorted(d.text for d in cpu) \
        == sorted(msgs)
    by_text = {d.text: d for d in cpu}
    for d in gpu:
        c = by_text[d.text]
        assert (d.time_offset, d.freq_hz) == (c.time_offset, c.freq_hz)
        assert abs(d.score - c.score) <= 0.01


@pytest.mark.parametrize("sideband", ["usb", "lsb"])
def test_ssb_exciter_kernel_path_on_the_card(cuda, sideband):
    kw = dict(sideband=sideband, eq_on=sideband == "usb",
              compressor_on=True)
    ex = tx.SSBExciter(tx.TxSpec(**kw), device=cuda)
    # the plain path: the same exciter with the compressor's plain loop
    plain = tx.SSBExciter(tx.TxSpec(**kw, use_kernels=False), device=cuda)
    p = tx.default_tx_params((7,), device=cuda)
    mic = torch.from_numpy(np.stack([signals.voice_proxy(
        3 * C.BLOCK_SIZE, fs_audio=C.SAMPLE_RATE, seed=s) * (0.2 + s)
        for s in range(7)]).astype(np.float32)).to(cuda)
    st_k = st_p = ex.init_state((7,))
    out_k, out_p = [], []
    before = kcomp.launch.launches
    for b in range(3):
        blk = mic[:, b * C.BLOCK_SIZE:(b + 1) * C.BLOCK_SIZE]
        st_k, iq = ex.block(p, st_k, blk)
        out_k.append(iq)
        st_p, iq_p = plain.block(p, st_p, blk)
        out_p.append(iq_p)
    assert kcomp.launch.launches == before + 3
    got = torch.cat(out_k, -1).cpu().numpy()
    want = torch.cat(out_p, -1).cpu().numpy()
    assert parity.snr_db(want, got) >= parity.AUDIO_SNR_MIN_DB
