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


def test_kernel_consts_rebuild_the_chunk_operators_bit_for_bit():
    K, NS, B = TE.chunk, 56, teq.NUM_BANDS
    kc = TE.kernel_consts
    assert kc.dtype == np.float32 and kc.size == B * K + 2 * K * NS \
        + NS * 4 + B
    h, o = kc[:B * K].reshape(B, K), B * K
    R, o = kc[o:o + K * NS].reshape(K, NS), o + K * NS
    G, o = kc[o:o + NS * K].reshape(NS, K), o + NS * K
    AK, o = kc[o:o + NS * 4].reshape(NS, 4), o + NS * 4
    np.testing.assert_array_equal(kc[o:], teq._SIGNS)
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


def test_kernel_source_agrees_with_the_wrapper():
    import re
    src = (_build.SRC_DIR / "eq.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("BANDS") == teq.NUM_BANDS and const("K") == keq.CHUNK
    assert const("NS") == teq.NUM_BANDS * 2 * keq.STAGES
    assert TE.chunk == keq.CHUNK and TE.stages == keq.STAGES
    # the C entry point's parameters, and the stream
    assert len(keq._ARGS) == 10


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
