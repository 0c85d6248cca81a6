"""Every `ChainSpec` option that t41x accepts builds and runs one block
in the port, kernels (plain versions on the CPU) on and off, with the
output keys and shapes of t41x's chain for the same spec (traced with
`jax.eval_shape`) and finite values.  No option is left unported."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.chain import ChainSpec as JSpec, RxChain as JChain
from t41x.chain import default_params as jparams
from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.utils import convert

torch.set_num_threads(1)


def _block(ch, q15):
    rng = np.random.default_rng(3)
    t = np.arange(C.BLOCK_SIZE) / C.SAMPLE_RATE
    x = (0.3 * np.exp(2j * np.pi * (C.SAMPLE_RATE / 4 + 1500.0) * t)
         + 0.05 * (rng.standard_normal((ch, t.size))
                   + 1j * rng.standard_normal((ch, t.size)))
         ).astype(np.complex64)
    if q15:
        return tuple(np.clip(np.round(a * 32768.0), -32768, 32767
                             ).astype(np.int16) for a in (x.real, x.imag))
    return x


# every ChainSpec option t41x accepts, one value each away from the default
_OPTIONS = [
    ("mode", m) for m in ("usb", "lsb", "ft8", "cw", "am", "sam", "nfm",
                          "psk31")
] + [("nr_mode", v) for v in (1, 2, 3)] + [
    ("agc_mode", v) for v in (0, 1, 3, 4)
] + [("spectrum_zoom", v) for v in range(0, 8)] + [
    ("cw_filter_index", v) for v in range(5)
] + [("cw_tone_hz", 600.0), ("nb_on", True), ("eq_on", True), ("notch_on", True),
     ("cw_decode", False), ("interpolate_out", False),
     ("use_matmul_osfilter", False), ("spectrum_taps", False),
     ("q15_input", True), ("clip_taps", True)]


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("field,value", _OPTIONS,
                         ids=[f"{f}={v}" for f, v in _OPTIONS])
def test_every_spec_option_runs(field, value, kernels):
    """Every `ChainSpec` option t41x accepts builds and runs one block in
    the port (cw filter and decoder options in mode cw), with t41x's
    output keys and finite values."""
    base = dict(mode="cw") if field.startswith("cw_") else {}
    kw = {**base, field: value}
    assert {f.name for f in dataclasses.fields(JSpec)} - {"use_pallas"} \
        == {f.name for f in dataclasses.fields(ChainSpec)} - {"use_kernels"}
    ch = 2
    tc = RxChain(ChainSpec(use_kernels=kernels, **kw), device="cpu")
    blk = _block(ch, kw.get("q15_input", False))
    tblk = (tuple(map(torch.from_numpy, blk)) if isinstance(blk, tuple)
            else torch.from_numpy(blk))
    _, out = tc.block(convert.params_from_numpy(jparams((ch,)), device="cpu"),
                      tc.init_state((ch,)), tblk)
    jc = JChain(JSpec(**kw))
    _, jo = jax.eval_shape(jc.block, jparams((ch,)), jc.init_state((ch,)),
                           blk)
    assert set(out) == set(jo)
    for k, v in out.items():
        assert tuple(v.shape) == jo[k].shape, k
        assert v.dtype == torch.bool or bool(torch.isfinite(v).all()), k
