"""S1, the spectral NR gain recursion's kernel: what runs without a card.

The plain version (`t41x_torch.dsp.nr.spectral_gains_scan`, through
`spectral_nr` and `spectral_nr_batch` with B = 8) against t41x's
`spectral_nr` / `spectral_nr_batch` over 64 blocks of the card tests'
stimuli (`tests/test_torch_spectral_nr_gpu.py` `nr_audio`, made with
numpy from a seed: the init phase crossing hop 20, silent channels,
levels that move the NN choice over all five widths), with the state
handed from t41x to the port and back mid-stream, the audio at the
bounds of tests/test_torch_nr.py (rtol 2e-4 / atol 2e-5, >= 55 dB), the
state's frame counter equal and each float field >= 55 dB; the same
through the receive chain's `nr_mode=2` spec with its state crossing
by `convert`.  Powers built to put the in-band ratio on each NN
boundary, and single strong bins at the VAD band's edges, through
t41x's `_spectral_gain` and the port's: an NN choice may differ only
within `parity.NR_MARGIN_MAX` of a boundary, the gains are otherwise
within those bounds.  The decision-margin helper on constructed ties;
the float32 constants S1 takes are torch's; the dispatch (CPU tensors
take the plain version, the chain passes `use_kernels`); and the
wrapper's argument layout and refusals on a faked library.
"""

import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.chain import ChainSpec as JSpec, RxChain as JChain
from t41x.chain import default_params as jparams
from t41x.dsp import nr as jnr
from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.dsp import nr as tnr
from t41x_torch.kernels import _build, spectral_nr as kspec
from t41x_torch.utils import convert, parity
from test_torch_spectral_nr_gpu import nr_audio

torch.set_num_threads(1)

BLOCKS = 64
P = tnr.spectral_params(200.0, 3000.0)


def _close_audio(got, ref, msg):
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=msg)
    assert parity.snr_db(ref, got) >= parity.AUDIO_SNR_MIN_DB, msg


def _close_state(ts, js, msg=""):
    """The carried state: the frame counter equal, each float field >=
    55 dB (the audio bound) from t41x's.  No per-element bound holds
    over 128 hops: the recursion's own test pslp > psthr can go the
    other way in a bin on float32 differences between XLA's and torch's
    CPU arithmetic, after which that bin's EMAs differ for a while (one
    hk_old in 1024 by 1.3% at block 63 here)."""
    for f in js._fields:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype, f
        if a.dtype == np.int32:
            np.testing.assert_array_equal(a, b, f"{msg} {f}")
        else:
            assert np.isfinite(a).all(), f"{msg} {f}"
            assert parity.snr_db(b, a) >= parity.AUDIO_SNR_MIN_DB, (
                f"{msg} {f}", parity.snr_db(b, a))


def _to_port(js) -> tnr.SpectralState:
    return tnr.SpectralState(*(torch.from_numpy(np.array(a)) for a in js))


def _to_t41x(ts):
    return jnr.SpectralState(*(jnp.asarray(t.numpy()) for t in ts))


@pytest.mark.parametrize("batched", [False, True])
def test_plain_matches_t41x_over_64_blocks(batched):
    """64 blocks (128 hops) at 8 channels, channel 0 silent for 24
    blocks and channel 4 throughout; at block 24 the port continues
    from t41x's state, at block 48 t41x from the port's."""
    ch = 8
    xs = nr_audio(np.random.default_rng(21), (ch,), BLOCKS)
    step = 8 if batched else 1
    if batched:
        jfn = jax.jit(jnr.spectral_nr_batch, static_argnums=0)
    else:
        jfn = jax.jit(jnr.spectral_nr, static_argnums=0)
    tfn = tnr.spectral_nr_batch if batched else tnr.spectral_nr
    js = jnr.spectral_state((ch,))
    ts = tnr.spectral_state((ch,))
    for b in range(0, BLOCKS, step):
        if b == 24:
            ts = _to_port(js)
        elif b == 48:
            js = _to_t41x(ts)
        x = xs[b: b + step] if batched else xs[b]
        js, jy = jfn(P, js, jnp.asarray(x))
        ts, ty = tfn(P, ts, torch.from_numpy(x), use_kernels=True)
        _close_audio(ty.numpy(), np.asarray(jy), f"block {b}")
        hops = 2 * (b + step)
        if hops <= P.init_frames:   # the init phase: audio untouched
            np.testing.assert_array_equal(ty.numpy(), x)
        _close_state(ts, js, f"block {b}")
    assert int(ts.frames[0]) == 2 * BLOCKS
    # the silent channel's output is silent
    assert not ty.numpy()[..., 4, :].any()


def test_chain_state_crosses_mid_stream():
    """The receive chain with spectral NR: 8 blocks in t41x, 8 in the
    port (its kernel dispatch), 8 in t41x again, against t41x alone;
    the NR state crosses by `convert` both ways."""
    ch, blocks = 3, 24
    kw = dict(mode="usb", nr_mode=2)
    jc = JChain(JSpec(**kw))
    tc = RxChain(ChainSpec(use_kernels=True, **kw), device="cpu")
    jp = jparams((ch,))._replace(
        nco_freq=np.linspace(-500.0, 700.0, ch).astype(np.float32))
    tp = convert.params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(8)
    n = blocks * C.BLOCK_SIZE
    t = np.arange(n) / C.SAMPLE_RATE
    iq = (0.3 * (t > t[-1] / 3) * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4
                                                        + 1500.0) * t)
          + 0.05 * (rng.standard_normal((ch, n))
                    + 1j * rng.standard_normal((ch, n)))
          ).astype(np.complex64)
    step = jax.jit(jc.block)
    ref, mix = jc.init_state((ch,)), jc.init_state((ch,))
    for b in range(blocks):
        blk = np.ascontiguousarray(iq[:, b * C.BLOCK_SIZE:
                                      (b + 1) * C.BLOCK_SIZE])
        ref, out_ref = step(jp, ref, blk)
        if 8 <= b < 16:
            st = convert.state_from_numpy(jax.tree.map(np.asarray, mix),
                                          device="cpu")
            assert type(st.nr) is tnr.SpectralState
            st, out = tc.block(tp, st, torch.from_numpy(blk))
            mix = convert.state_to_numpy(st)
            got = out["audio_24k"].numpy()
        else:
            mix, out = step(jp, mix, blk)
            got = np.asarray(out["audio_24k"])
        _close_audio(got, np.asarray(out_ref["audio_24k"]), f"block {b}")
    assert int(np.asarray(mix.nr.frames)[0]) == 2 * blocks
    _close_state(_to_port(mix.nr), ref.nr, "chain")


def _running_state(ch: int):
    """A state past the init phase: a flat noise estimate of 1 and no
    a-priori SNR, so bins at the noise floor get a gain of 0."""
    st = tnr.spectral_state((ch,))
    return (torch.ones(ch, tnr.HOP), st.pslp, torch.zeros(ch, tnr.HOP),
            torch.full((ch,), 40, dtype=torch.int32))


def _ratio(gst, X):
    in_band = tnr._in_band(P.vad_low, P.vad_high, X.device)
    return tnr._spectral_ratio(P, gst, X, in_band)[3]


def _on_boundaries(offsets=(0.0,)):
    """(4 x len(offsets), HOP) powers whose in-band ratio lies on each NN
    boundary (times 1 + offset): half the in-band bins at a level that
    the gain passes, half at one it suppresses, mixed by a weight
    found by bisection."""
    lo, hi = P.vad_low, P.vad_high
    bins = torch.arange(tnr.HOP)
    high = torch.where((bins >= lo) & (bins < hi) & (bins % 2 == 0),
                       40.0, 0.5)
    low = torch.full((tnr.HOP,), 0.5)
    rows = []
    for b in tnr.nn_boundaries(P):
        for off in offsets:
            target = b * (1.0 + off)
            a0, a1 = 0.0, 1.0
            for _ in range(60):
                a = 0.5 * (a0 + a1)
                X = (a * high + (1 - a) * low)[None].float()
                if float(_ratio(_running_state(1), X)) < target:
                    a0 = a
                else:
                    a1 = a
            rows.append((a * high + (1 - a) * low).float())
    return torch.stack(rows)


def test_decision_margin_on_constructed_ties():
    """Ratios built onto each boundary have margins of float32 rounding;
    1e-3 either side of a boundary the choice steps by one and the
    margin is ~1e-3; silence (X = 0) chooses the widest box."""
    X = _on_boundaries()
    gst = _running_state(X.shape[0])
    nn, margin = tnr.spectral_decision_margin(P, gst, X[None])
    assert nn.shape == (1, 4) and nn.dtype == torch.int32
    assert (margin < 1e-5).all(), margin
    r = _ratio(gst, X)
    np.testing.assert_allclose(r.numpy(), tnr.nn_boundaries(P), rtol=1e-5)
    Xo = _on_boundaries((-1e-3, 1e-3))
    nn, margin = tnr.spectral_decision_margin(P, _running_state(8), Xo[None])
    nn = nn[0].reshape(4, 2)
    # below the boundary at 0.35 the width is 1 (index 1), above it 0
    np.testing.assert_array_equal(nn.numpy(), [[1, 0], [2, 1], [3, 2],
                                               [4, 3]])
    assert ((margin > 5e-4) & (margin < 2e-3)).all(), margin
    # the choice's own rule: round half to even at the midpoints
    ratio = torch.tensor([0.0, 0.05, 0.15, 0.25, 0.35, 0.4, 0.41, 1.0])
    np.testing.assert_array_equal(tnr._nn_choice(P, ratio).numpy(),
                                  [4, 4, 2, 2, 0, 0, 0, 0])
    nn, margin = tnr.spectral_decision_margin(
        P, _running_state(2), torch.zeros(1, 2, tnr.HOP))
    assert nn.tolist() == [[4, 4]] and (margin == 1.0).all()


def _hold_gain_against_t41x(gst, X, msg):
    """One hop through t41x's `_spectral_gain` and the port's: the state
    and init flags within the bounds, the gains of every channel whose
    NN choice may not differ (margin >= NR_MARGIN_MAX) within them."""
    jgst = tuple(jnp.asarray(t.numpy()) for t in gst)
    (jxt, jps, jhk, jfr), jg, jinit = jnr._spectral_gain(P, jgst,
                                                         jnp.asarray(X))
    (txt, tps, thk, tfr), tg, tinit = tnr._spectral_gain(P, gst, X)
    for a, b in ((txt, jxt), (tps, jps), (thk, jhk)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4,
                                   atol=2e-5, err_msg=msg)
    np.testing.assert_array_equal(tfr.numpy(), np.asarray(jfr))
    np.testing.assert_array_equal(tinit.numpy(), np.asarray(jinit))
    _, margin = tnr.spectral_decision_margin(P, gst, X[None])
    sure = (margin[0] >= parity.NR_MARGIN_MAX).numpy()
    np.testing.assert_allclose(tg.numpy()[sure], np.asarray(jg)[sure],
                               rtol=2e-4, atol=2e-5, err_msg=msg)
    return sure


def test_gain_on_nn_boundaries_and_vad_edges_matches_t41x():
    X = _on_boundaries((-1e-3, 0.0, 1e-3))
    sure = _hold_gain_against_t41x(_running_state(X.shape[0]), X,
                                   "NN boundaries")
    assert sure.sum() >= 8          # those 1e-3 off every boundary
    # one strong bin at each edge of the VAD band, just in and just out
    lo, hi = P.vad_low, P.vad_high
    edges = [lo - 1, lo, lo + 1, hi - 2, hi - 1, hi]
    X = torch.full((len(edges), tnr.HOP), 0.5)
    for i, e in enumerate(edges):
        X[i, e] = 50.0
    sure = _hold_gain_against_t41x(_running_state(len(edges)), X,
                                   "VAD edges")
    assert sure.all()
    # within the init phase the noise estimate accumulates
    gst = _running_state(len(edges))
    gst = gst[:3] + (torch.arange(len(edges), dtype=torch.int32) + 17,)
    _hold_gain_against_t41x(gst, X, "init edge")


def test_consts_are_torchs_float32_scalars():
    """S1 takes each scalar of the recursion as torch rounds it: a
    product with the constant equals torch's product with the Python
    double, bit for bit."""
    k = tnr.spectral_consts(P)
    assert len(k) == 19
    ax = np.exp(-P.tinc / P.tax)
    ap = np.exp(-P.tinc / P.tap)
    xih1 = 10.0 ** (P.asnr_db / 10.0)
    doubles = [0.05 * P.psini, 1.0 / (1.0 + xih1) - 1.0,
               (1.0 / P.pspri - 1.0) * (1.0 + xih1), ap, 1.0 - ap,
               P.psthr, 1.0 - P.pnsaf, ax, 1.0 - ax,
               10.0 ** (P.snr_prio_min_db / 20.0), P.alpha, 1.0 - P.alpha,
               P.power_threshold]
    x = torch.rand(4096) * 10.0
    for i, d in enumerate(doubles):
        assert torch.equal(x * d, x * torch.tensor(k[i])), i
    assert k[14] == P.width and k[13] == np.float32(1) / np.float32(0.4)
    assert k[15:] == tuple(float(np.float32(1) / np.float32(n))
                           for n in (3, 5, 7, 9))


def test_dispatch_takes_the_plain_version_on_the_cpu():
    st = tnr.spectral_state((3,))
    x = torch.from_numpy(nr_audio(np.random.default_rng(2), (3,), 1)[0])
    before = kspec.spectral_gains.launches
    a = tnr.spectral_nr(P, st, x, use_kernels=True)
    b = tnr.spectral_nr(P, st, x)
    for u, v in zip((*a[0], a[1]), (*b[0], b[1])):
        assert torch.equal(u, v)
    assert kspec.spectral_gains.launches == before


@pytest.mark.parametrize("use_kernels", [True, False])
def test_chain_passes_use_kernels_to_spectral_nr(monkeypatch, use_kernels):
    seen = []
    single, batch = tnr.spectral_nr, tnr.spectral_nr_batch

    def spy(p, st, x, use_kernels=False):
        seen.append(("block", use_kernels))
        return single(p, st, x)

    def spy_batch(p, st, xs, use_kernels=False):
        seen.append(("batch", use_kernels))
        return batch(p, st, xs)

    monkeypatch.setattr(tnr, "spectral_nr", spy)
    monkeypatch.setattr(tnr, "spectral_nr_batch", spy_batch)
    chain = RxChain(ChainSpec(mode="usb", nr_mode=2,
                              use_kernels=use_kernels), device="cpu")
    rng = np.random.default_rng(2)
    iq = torch.from_numpy(((rng.standard_normal((3, 2, C.BLOCK_SIZE))
                            + 1j * rng.standard_normal((3, 2, C.BLOCK_SIZE)))
                           * 0.1).astype(np.complex64))
    from t41x_torch.chain import default_params
    pr = default_params((2,), device="cpu")
    st = chain.block(pr, chain.init_state((2,)), iq[0])[0]
    chain.block_batch(pr, st, iq[1:])
    assert seen == [("block", use_kernels), ("batch", use_kernels)]


@pytest.fixture
def fake_library(monkeypatch):
    """A library whose entry points record their arguments; the device
    guard a no-op; the stream 0xBEEF."""
    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            entry.argtypes = None
            return entry

    monkeypatch.setattr(_build, "library", lambda verbose=False: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda device: 0xBEEF)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return calls


def test_wrapper_layout_and_refusals(fake_library):
    calls = fake_library
    lead, hops = (2, 3), 16
    st = tnr.spectral_state(lead)
    gst = (st.xt, st.pslp, st.hk_old, st.frames)
    powers = torch.rand((hops,) + lead + (tnr.HOP,))
    nn = torch.zeros((hops,) + lead, dtype=torch.int32)
    before = kspec.spectral_gains.launches
    bad = [(gst, powers.double(), None),
           (gst, powers[:, :1], None),
           (gst, powers[:0], None),
           (gst[:3] + (st.frames.long(),), powers, None),
           (gst, powers, nn[:1]),
           (gst, powers, nn.long())]
    for g, pw, n in bad:
        with pytest.raises(ValueError):
            kspec._launch(P, g, pw, n)
    assert calls == [] and kspec.spectral_gains.launches == before
    (xt, pslp, hk, frames), gains, inits = kspec._launch(P, gst, powers, nn)
    (name, args), = calls
    assert name == "t41x_spectral_gains"
    assert args[:7] == (powers.data_ptr(), st.xt.data_ptr(),
                        st.pslp.data_ptr(), st.hk_old.data_ptr(),
                        st.frames.data_ptr(), 6, hops)
    fparams = ctypes.cast(args[7], ctypes.POINTER(ctypes.c_float))
    np.testing.assert_array_equal(
        np.ctypeslib.as_array(fparams, (19,)),
        np.asarray(tnr.spectral_consts(P), np.float32))
    assert args[8:11] == (P.init_frames, P.vad_low, P.vad_high)
    outs = (gains, inits, xt, pslp, hk, frames, nn)
    assert args[11:] == tuple(t.data_ptr() for t in outs) + (0xBEEF,)
    assert gains.shape == powers.shape and inits.dtype == torch.bool
    assert inits.shape == (hops,) + lead + (1,)
    assert frames.shape == lead and frames.dtype == torch.int32
    assert kspec.spectral_gains.launches == before + 1
    # without the NN buffer, a null pointer
    kspec._launch(P, gst, powers, None)
    assert calls[-1][1][17] is None
    # no channels: nothing to launch
    st0 = tnr.spectral_state((0,))
    kspec._launch(P, (st0.xt, st0.pslp, st0.hk_old, st0.frames),
                  torch.rand(2, 0, tnr.HOP), None)
    assert len(calls) == 2


def test_kernel_source_agrees_with_the_wrapper():
    import re
    src = (_build.SRC_DIR / "spectral_nr.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("HOP") == tnr.HOP == 128
    # four bins a lane: a warp a channel
    assert const("BPL") * 32 == tnr.HOP
    assert const("N_PHASES") == len(kspec.S1_PHASES)
    assert "fparams[15 + i]" in src and len(tnr.spectral_consts(P)) == 19
    assert "extern \"C\" int t41x_spectral_gains(" in src
    assert "extern \"C\" int t41x_spectral_gains_phases(" in src
    # one argument type a C parameter: 18 and the stream; the stamped
    # variant's stamps before the stream
    assert len(kspec._ARGS) == 19 and len(kspec._PHASE_ARGS) == 20
    # no block barrier and no shared memory: the warp agrees on NN by a
    # butterfly of shuffles
    assert "__syncthreads" not in src and "__shared__" not in src
    assert "__shfl_xor_sync" in src


def test_phases_wrapper_and_alignment(fake_library):
    """`spectral_gains_phases` passes a stamps buffer of a row a channel
    before the stream, and no NN buffer; a state plane that is a view at
    an offset that is not a multiple of 16 bytes goes in as an aligned
    copy."""
    calls = fake_library
    lead, hops = (5,), 3
    st = tnr.spectral_state(lead)
    gst = (st.xt, st.pslp, st.hk_old, st.frames)
    powers = torch.rand((hops,) + lead + (tnr.HOP,))
    *outs, stamps = kspec.spectral_gains_phases(P, gst, powers)
    (name, args), = calls
    assert name == "t41x_spectral_gains_phases"
    assert args[17] is None and args[18] == stamps.data_ptr()
    assert args[19] == 0xBEEF
    assert stamps.shape == (5, len(kspec.S1_PHASES) + 2)
    assert stamps.dtype == torch.int64
    buf = torch.rand(1 + 5 * tnr.HOP)
    xt = buf[1:].view(lead + (tnr.HOP,))
    kspec._launch(P, (xt,) + gst[1:], powers, None)
    passed = calls[-1][1][1]
    assert passed != xt.data_ptr() and passed % 16 == 0
    assert calls[-1][1][2] == st.pslp.data_ptr()
