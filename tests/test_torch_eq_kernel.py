"""E1, the 14-band EQ's kernel: what runs without a card.

The plain version (`EQDesign.apply_plain`, reached through `apply` with
`use_kernels` on CPU tensors) against `t41x.dsp.eq.EQDesign.apply` on
the card tests' stimuli (`tests/test_torch_eq_gpu.py`: per-channel gains
with a band at 0, noise and tones at band centres, random carried
states, made with numpy from a seed) at n 32, 256 and 2048 and at 1 and
1024 channels, with shared (14,) gains at one channel, and with the
state handed from t41x to the port and back mid-stream, at the bounds
of tests/test_torch_stages.py (rtol 2e-4 / atol 2e-5); the transmit
chain's EQ (`SSBExciter(TxSpec(eq_on=True))`, its dispatch) against
t41x's exciter at the I/Q bound of tests/test_torch_tx.py (>= 100 dB).
E1's constants rebuild the plain version's chunk operators bit for bit;
the kernel source's sizes are the wrapper's; the dispatch (CPU tensors
take the plain version, the chains pass `use_kernels`); and the
wrapper's argument layout and refusals on a faked library.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x.chain import tx as jtx
from t41x.dsp import eq as jeq
from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.chain import tx as ttx
from t41x_torch.dsp import eq as teq
from t41x_torch.kernels import _build, eq as keq
from t41x_torch.utils import convert, parity
from test_torch_eq_gpu import eq_audio, eq_gains, eq_state

torch.set_num_threads(1)

JE, TE = jeq.EQDesign(), teq.EQDesign()


def _close(got, ref, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=2e-4,
                               atol=2e-5, err_msg=msg)


@pytest.mark.parametrize("ch", [1, 1024])
@pytest.mark.parametrize("n", [32, 256, 2048])
def test_plain_matches_t41x(ch, n):
    rng = np.random.default_rng(ch + n)
    blocks = 4
    xs = eq_audio(rng, (ch,), n, blocks)
    gains = eq_gains(rng, (ch,))
    st0 = eq_state(rng, (ch,))
    js, ts = jnp.asarray(st0), torch.from_numpy(st0)
    before = keq.eq_block.launches
    for b in range(blocks):
        js, jy = JE.apply(js, jnp.asarray(xs[b]), jnp.asarray(gains))
        ts, ty = TE.apply(ts, torch.from_numpy(xs[b]),
                          torch.from_numpy(gains), use_kernels=True)
        _close(ty.numpy(), jy, f"block {b}")
        _close(ts.numpy(), js, f"state block {b}")
        assert ts.shape == (ch, teq.NUM_BANDS, 2, 2)
    assert keq.eq_block.launches == before


def test_shared_gains_at_one_channel_and_state_crossing():
    """Shared (14,) gains at channels () as `Radio.transmit_ssb` passes
    them; t41x 8 blocks, the port 8, t41x 8 again, against t41x alone."""
    rng = np.random.default_rng(3)
    xs = eq_audio(rng, (), 256, 24)
    gains = eq_gains(rng, ())
    ref = mix = jnp.asarray(JE.init_state(()))
    for b in range(24):
        ref, y_ref = JE.apply(ref, jnp.asarray(xs[b]), jnp.asarray(gains))
        if 8 <= b < 16:
            st, y = TE.apply(torch.from_numpy(np.array(mix)),
                             torch.from_numpy(xs[b]),
                             torch.from_numpy(gains), use_kernels=True)
            mix, y = st.numpy(), y.numpy()
        else:
            mix, y = JE.apply(jnp.asarray(mix), jnp.asarray(xs[b]),
                              jnp.asarray(gains))
        assert np.shape(y) == (256,)
        _close(y, y_ref, f"block {b}")
    _close(mix, ref, "state")


def test_tx_eq_matches_t41x():
    """The SSB exciter with its EQ (per-channel gains) through the
    port's dispatch, against t41x's exciter; the EQ's state crosses
    back mid-stream with the rest of `SSBState`."""
    ch, blocks = 3, 6
    rng = np.random.default_rng(9)
    mic = (0.3 * rng.standard_normal((ch, blocks * 2048))).astype(np.float32)
    jp = jtx.default_tx_params((ch,))._replace(
        eq_gains=eq_gains(rng, (ch,)))
    tp = convert.tx_params_from_numpy(jp, device="cpu")
    jx = jtx.SSBExciter(jtx.TxSpec(sideband="usb", eq_on=True))
    tx = ttx.SSBExciter(ttx.TxSpec(sideband="usb", eq_on=True), device="cpu")
    js, ts = jx.init_state((ch,)), tx.init_state((ch,))
    for b in range(blocks):
        blk = mic[:, b * 2048:(b + 1) * 2048]
        if b == 3:      # the port continues from t41x's state
            ts = convert.tx_state_from_numpy(
                type(js)(*(np.asarray(a) if not isinstance(a, tuple) else a
                           for a in js)), device="cpu")
        js, jiq = jx.block(jp, js, jnp.asarray(blk))
        ts, tiq = tx.block(tp, ts, torch.from_numpy(blk))
        assert parity.snr_db(np.asarray(jiq), tiq.numpy()) >= 100.0, b
    _close(ts.eq.numpy(), js.eq, "eq state")


def _consts(kc):
    """kernel_consts' parts: h (14, K), R (K, 56), G (56, K), AK (56, 4),
    signs (14,)."""
    K, NS, B = TE.chunk, 56, teq.NUM_BANDS
    h, o = kc[:B * K].reshape(B, K), B * K
    R, o = kc[o:o + K * NS].reshape(K, NS), o + K * NS
    G, o = kc[o:o + NS * K].reshape(NS, K), o + NS * K
    AK, o = kc[o:o + NS * 4].reshape(NS, 4), o + NS * 4
    return h, R, G, AK, kc[o:]


def test_kernel_consts_rebuild_the_chunk_operators_bit_for_bit():
    K, NS, B = TE.chunk, 56, teq.NUM_BANDS
    kc = TE.kernel_consts
    assert kc.dtype == np.float32 and kc.size == B * K + 2 * K * NS \
        + NS * 4 + B
    h, R, G, AK, signs = _consts(kc)
    np.testing.assert_array_equal(signs, teq._SIGNS)
    Wy, Ws = np.zeros_like(TE.Wy), np.zeros_like(TE.Ws)
    k, j = np.meshgrid(np.arange(K), np.arange(K), indexing="ij")
    for b in range(B):
        # L_b is Toeplitz: L[k, j] = h[k - j] for j <= k
        Wy[:K, b * K:(b + 1) * K] = np.where(j <= k, h[b][k - j], 0.0).T
    for n in range(NS):
        b = n // 4
        Wy[K + n, b * K:(b + 1) * K] = R[:, n]
        Ws[:K, n] = G[n]
        Ws[K + 4 * b: K + 4 * b + 4, n] = AK[n]
    np.testing.assert_array_equal(Wy, TE.Wy)
    np.testing.assert_array_equal(Ws, TE.Ws)
    np.testing.assert_array_equal(TE.Wy, JE.Wy)
    np.testing.assert_array_equal(TE.Ws, JE.Ws)


def e1_three_passes(kc, state, x, gains, seg=8):
    """E1's arithmetic in float32 numpy from `kernel_consts` alone, pass
    by pass as csrc/eq.cu runs it on passes of up to `seg` chunks: (a)
    u_q = G^T x_q for every chunk at once, four samples a step; (b) the
    4 x 4 scan a band s_{q+1} = AK s_q + u_q, leaving g s_q; (c) y_q =
    he * x_q + R (g s_q) for every chunk at once, the causal part read as
    the kernel reads it: output sample k takes taps j = 4 j4 .. 4 j4 + 3
    as one 16-byte read of copy r = (k + 1) % 4 of [K zeros | he | 0]
    (copy r at i holding element i + r) at K + k - 3 - r - 4 j4, reversed.
    state (C, 14, 2, 2), x (C, n), gains (C, 14).  Returns (state, y)."""
    f32 = np.float32
    h, R, G, AK, signs = _consts(kc)
    K, B, NS = h.shape[1], h.shape[0], R.shape[1]
    C, n = x.shape
    sc = (signs * gains).astype(f32)                       # (C, 14)
    he = np.zeros((C, K), f32)
    for b in range(B):
        he = (sc[:, b:b + 1] * h[b] + he).astype(f32)
    hz = np.zeros((C, 3 * K), f32)
    hz[:, K:2 * K] = he
    copies = np.stack([hz[:, r:r + 2 * K] for r in range(4)], 1)
    k = np.arange(K)
    rk = (k + 1) % 4
    scale = np.repeat(sc, 4, axis=1)                       # (C, 56)
    akb = AK.reshape(B, 4, 4)
    s = state.reshape(C, NS).astype(f32)
    ys = []
    for q0 in range(0, n // K, seg):
        xq = x[:, q0 * K:(q0 + seg) * K].reshape(C, -1, K)
        u = np.zeros(xq.shape[:2] + (NS,), f32)            # (a)
        for j4 in range(K // 4):
            u += xq[..., 4 * j4:4 * j4 + 4] @ G[:, 4 * j4:4 * j4 + 4].T
        gs = np.zeros(u.shape, f32)
        for q in range(xq.shape[1]):                       # (b)
            gs[:, q] = scale * s
            s = (u[:, q].reshape(C, B, 4) + np.einsum(
                "bik,cbk->cbi", akb, s.reshape(C, B, 4))).reshape(C, NS)
        y = np.zeros(xq.shape, f32)                        # (c)
        for j4 in range(K // 4):
            a = K + k - 3 - rk - 4 * j4                    # (K,)
            hv = copies[:, rk[:, None], a[:, None] + np.arange(4)]
            taps = hv[..., ::-1]                           # (C, K, 4)
            y += np.einsum("ckt,cqt->cqk", taps,
                           xq[..., 4 * j4:4 * j4 + 4])
        y += gs @ R.T
        ys.append(y.reshape(C, -1))
    return s.reshape(state.shape), np.concatenate(ys, -1)


@pytest.mark.parametrize("ch", [1, 7])
@pytest.mark.parametrize("n", [32, 256, 2048])
def test_three_pass_model_matches_t41x(ch, n):
    """E1's three-pass arithmetic (`e1_three_passes`, built from
    `kernel_consts` alone) against t41x's `EQDesign.apply` over 3 blocks
    from a random state: output and state >= 120 dB."""
    rng = np.random.default_rng(5 * ch + n)
    xs = eq_audio(rng, (ch,), n, 3)
    gains = eq_gains(rng, (ch,))
    st = eq_state(rng, (ch,))
    js = jnp.asarray(st)
    for b in range(3):
        js, jy = JE.apply(js, jnp.asarray(xs[b]), jnp.asarray(gains))
        st, y = e1_three_passes(TE.kernel_consts, st, xs[b], gains)
        assert parity.snr_db(np.asarray(jy), y) >= 120.0, b
        assert parity.snr_db(np.asarray(js), st) >= 120.0, b


def test_kernel_source_agrees_with_the_wrapper():
    import re
    src = (_build.SRC_DIR / "eq.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("BANDS") == teq.NUM_BANDS and const("K") == keq.CHUNK
    assert const("NS") == teq.NUM_BANDS * 2 * keq.STAGES
    assert const("FEW") == keq.FEW
    assert const("WARPS") // const("W_MANY") == keq.MANY_PER_BLOCK
    assert const("N_PHASES") == len(keq.E1_PHASES)
    assert TE.chunk == keq.CHUNK and TE.stages == keq.STAGES
    # the C entry points' parameters, and the stream
    assert 'extern "C" int t41x_eq(' in src
    assert 'extern "C" int t41x_eq_phases(' in src
    assert len(keq._ARGS) == 10 and len(keq._PHASE_ARGS) == 11


@pytest.mark.parametrize("use_kernels", [True, False])
def test_chains_pass_use_kernels_to_the_eq(monkeypatch, use_kernels):
    seen = []
    plain = teq.EQDesign.apply_plain

    def spy(self, state, x, gains, use_kernels=False):
        seen.append((tuple(x.shape), use_kernels))
        return plain(self, state, x, gains)

    monkeypatch.setattr(teq.EQDesign, "apply", spy)
    chain = RxChain(ChainSpec(mode="usb", eq_on=True,
                              use_kernels=use_kernels), device="cpu")
    rng = np.random.default_rng(2)
    iq = torch.from_numpy(((rng.standard_normal((2, 2048))
                            + 1j * rng.standard_normal((2, 2048)))
                           * 0.1).astype(np.complex64))
    chain.block(default_params((2,), device="cpu"), chain.init_state((2,)),
                iq)
    ex = ttx.SSBExciter(ttx.TxSpec(eq_on=True, use_kernels=use_kernels),
                        device="cpu")
    ex.block(ttx.default_tx_params((2,), device="cpu"), ex.init_state((2,)),
             torch.zeros(2, 2048))
    assert seen == [((2, 256), use_kernels), ((2, 256), use_kernels)]


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
    before = keq.eq_block.launches
    st = TE.init_state((2, 3))
    x = torch.zeros(2, 3, 256)
    g = torch.ones(2, 3, 14)
    bad = [(st, torch.zeros(2, 3, 48), g),
           (st, torch.zeros(2, 3, 0), g),
           (st, x.double(), g),
           (st.double(), x, g),
           (TE.init_state((3,)), x, g),
           (st, x, torch.ones(2, 3, 13)),
           (st, x, torch.ones(4, 14))]
    for s, xx, gg in bad:
        with pytest.raises(ValueError):
            keq._launch(TE, s, xx, gg)
    with pytest.raises(ValueError):
        keq._launch(teq.EQDesign(chunk=16), st, x, g)
    assert calls == [] and keq.eq_block.launches == before
    st_o, y = keq._launch(TE, st, x, g)
    (name, args), = calls
    ops = TE.kernel_ops(x.device)
    assert name == "t41x_eq"
    assert args == (x.data_ptr(), st.data_ptr(), g.data_ptr(),
                    ops.data_ptr(), ops.numel(), 6, 256, y.data_ptr(),
                    st_o.data_ptr(), 0xBEEF)
    assert y.shape == x.shape and st_o.shape == st.shape
    assert keq.eq_block.launches == before + 1
    # broadcastable gains go in as a (..., 14) copy, one row a channel
    for shared in (torch.ones(14), torch.ones(3, 14)):
        keq._launch(TE, st, x, shared)
        passed = calls[-1][1][2]
        assert passed != shared.data_ptr()
    # one channel, as Radio.transmit_ssb runs it
    g1 = torch.ones(14)
    keq._launch(TE, TE.init_state(()), torch.zeros(2048), g1)
    assert calls[-1][1][2] == g1.data_ptr() and calls[-1][1][5:7] == (1, 2048)
    # no channels: nothing to launch
    keq._launch(TE, TE.init_state((0,)), torch.zeros(0, 256),
                torch.ones(0, 14))
    assert len(calls) == 4


def test_phases_wrapper_and_alignment(fake_library):
    """`eq_phases` passes a stamps buffer of a row a thread block (a
    channel each up to 132 channels, 4 each above) before the stream; a
    contiguous view at an offset that is not a multiple of 16 bytes goes
    in as an aligned copy."""
    calls = fake_library
    for ch, rows in ((9, 9), (132, 132), (133, 34)):
        st = TE.init_state((ch,))
        x = torch.zeros(ch, 256)
        g = torch.ones(ch, 14)
        st_o, y, stamps = keq.eq_phases(TE, st, x, g)
        name, args = calls[-1]
        assert name == "t41x_eq_phases" and args[-1] == 0xBEEF
        assert args[-2] == stamps.data_ptr()
        assert stamps.shape == (rows, len(keq.E1_PHASES) + 2)
        assert stamps.dtype == torch.int64
    buf = torch.zeros(1 + 256)
    keq._launch(TE, TE.init_state(()), buf[1:], torch.ones(14))
    passed = calls[-1][1][0]
    assert passed != buf[1:].data_ptr() and passed % 16 == 0
