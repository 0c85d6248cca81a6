"""t41x_torch.utils.checkpoint against t41x.utils.checkpoint.

A chain state saved by either package loads in the other, for the usb
spec, Kim NR (nr 1), LMS NR (nr 3), sam and the zoom 2^z panadapter with
cw: the port flattens its NamedTuple trees to exactly the keys
`jax.tree_util.tree_flatten_with_path` gives `t41x`'s, so both write the
same key set, and the values cross unchanged.  A checkpoint missing a
field loads with the template's value and a loud warning.  Resuming the
port's chain from a checkpoint continues the stream bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.chain import ChainSpec as JSpec, RxChain as JChain
from t41x.utils import checkpoint as jck
from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.utils import checkpoint as tck

torch.set_num_threads(1)

SPECS = {
    "usb": dict(mode="usb"),
    "nr_kim": dict(mode="usb", nr_mode=1),
    "nr_lms": dict(mode="usb", nr_mode=3, notch_on=True),
    "sam": dict(mode="sam", f_lo=-3000.0, f_hi=3000.0),
    "cw_zoom3_eq": dict(mode="cw", cw_filter_index=2, spectrum_zoom=3,
                        eq_on=True),
}
CH = (2,)


def _random_like(a, rng):
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return rng.random(a.shape) < 0.5
    if np.issubdtype(a.dtype, np.integer):
        return rng.integers(0, 50, a.shape).astype(a.dtype)
    if np.issubdtype(a.dtype, np.complexfloating):
        return (rng.standard_normal(a.shape)
                + 1j * rng.standard_normal(a.shape)).astype(a.dtype)
    return rng.standard_normal(a.shape).astype(a.dtype)


def _t41x_state(kw, seed):
    rng = np.random.default_rng(seed)
    st = JChain(JSpec(**kw)).init_state(CH)
    return jax.tree_util.tree_map(lambda a: _random_like(a, rng), st)


def _port_state(kw, seed):
    rng = np.random.default_rng(seed)
    st = RxChain(ChainSpec(**kw), device="cpu").init_state(CH)
    return tck.map_leaves(lambda _, t: torch.from_numpy(
        _random_like(t.numpy(), rng)), st)


def _keys(path):
    with np.load(path) as z:
        return sorted(z.files)


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_t41x_checkpoint_loads_in_port(spec, tmp_path):
    kw = SPECS[spec]
    st = _t41x_state(kw, 1)
    jck.save_state(str(tmp_path / "j.npz"), st, extra={"block": 9})
    template = RxChain(ChainSpec(**kw), device="cpu").init_state(CH)
    got, meta = tck.load_state(str(tmp_path / "j.npz"), template)
    assert meta == {"block": 9}
    want = jax.tree_util.tree_flatten_with_path(st)[0]
    have = tck.flatten_with_path(got)
    assert [jck._path_str(p) for p, _ in want] == \
        ["/".join(map(str, p)) for p, _ in have]
    for (_, a), (_, b) in zip(want, have):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert b.numpy().dtype == np.asarray(a).dtype
    # the port writes the same key set for the same state
    tck.save_state(str(tmp_path / "t.npz"), got)
    assert _keys(tmp_path / "t.npz") == \
        [k for k in _keys(tmp_path / "j.npz") if k != "__meta__"]


@pytest.mark.parametrize("spec", sorted(SPECS))
def test_port_checkpoint_loads_in_t41x(spec, tmp_path):
    kw = SPECS[spec]
    st = _port_state(kw, 2)
    tck.save_state(str(tmp_path / "t.npz"), st, extra={"block": 3})
    got, meta = jck.load_state(str(tmp_path / "t.npz"),
                               JChain(JSpec(**kw)).init_state(CH))
    assert meta == {"block": 3}
    have = jax.tree_util.tree_flatten_with_path(got)[0]
    want = tck.flatten_with_path(st)
    assert len(have) == len(want)
    for (_, a), (_, b) in zip(have, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype


def test_missing_field_warns_and_takes_template(tmp_path):
    kw = SPECS["nr_kim"]
    st = _port_state(kw, 3)
    tck.save_state(str(tmp_path / "full.npz"), st)
    with np.load(tmp_path / "full.npz") as z:
        kept = {k: z[k] for k in z.files if k != "s:nr/idx"}
    assert len(kept) == len(z.files) - 1
    np.savez(tmp_path / "old.npz", **kept)
    template = RxChain(ChainSpec(**kw), device="cpu").init_state(CH)
    with pytest.warns(UserWarning, match=r"missing 1 state field.*s:nr/idx"):
        got, meta = tck.load_state(str(tmp_path / "old.npz"), template)
    assert meta is None
    assert torch.equal(got.nr.idx, template.nr.idx)
    assert got.nr.idx is not template.nr.idx
    assert torch.equal(got.nr.Gts, st.nr.Gts)   # the fields it holds
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        tck.load_state(str(tmp_path / "full.npz"),
                       RxChain(ChainSpec(**kw), device="cpu").init_state(
                           (3,)))


def test_resume_from_checkpoint_is_bit_exact(tmp_path):
    chain = RxChain(ChainSpec(mode="usb", nr_mode=1, interpolate_out=False),
                    device="cpu")
    rng = np.random.default_rng(4)
    iq = torch.from_numpy((0.2 * (rng.standard_normal((8,) + CH
                                                      + (C.BLOCK_SIZE,))
                                  + 1j * rng.standard_normal(
                                      (8,) + CH + (C.BLOCK_SIZE,))))
                          .astype(np.complex64))
    p = default_params(CH, device="cpu")
    st = chain.init_state(CH)
    outs = []
    for b in range(8):
        st, out = chain.block(p, st, iq[b])
        outs.append(out["audio_24k"])
        if b == 3:
            tck.save_state(str(tmp_path / "s.npz"), st, extra={"block": 4})
    st2, meta = tck.load_state(str(tmp_path / "s.npz"), chain.init_state(CH))
    for b in range(meta["block"], 8):
        st2, out = chain.block(p, st2, iq[b])
        assert torch.equal(out["audio_24k"], outs[b])
    for (_, a), (_, b) in zip(tck.flatten_with_path(st),
                              tck.flatten_with_path(st2)):
        assert torch.equal(a, b)
