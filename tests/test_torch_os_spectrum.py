"""B1, the spectrum-tap band-pass kernel's design, on the CPU.

The CUDA kernel (`t41x_torch/csrc/os_spectrum.cu`) runs only on a card
(`tests/test_torch_os_spectrum_gpu.py`).  Here:

* its tables, designed in float64, driven through a float64 NumPy model
  of its pass schedule (`forward`, `inverse`, `model` below, which read
  the exchanges' addresses from `kernels/os_spectrum.py` `EXCHANGES`,
  as the kernel computes them), equal `np.fft.fft` and `np.fft.ifft` at
  512 points, and the model with the tables rounded to float32 agrees
  with the plain version;
* each exchange writes distinct slots, reads only written ones, and puts
  every half-warp's 8-byte accesses on distinct banks;
* the wrapper on CPU tensors returns the plain version's outputs bit for
  bit, and the chain's dispatch on the CPU is the band-pass it was.
"""

import re

import numpy as np
import pytest
import torch

from t41x_torch.chain import ChainSpec, RxChain
from t41x_torch.dsp import firdesign as fd, osfilter as tosf
from t41x_torch.kernels import os_spectrum as kspec

F, R, TPC = kspec.F, kspec.R, kspec.TPC
MASK = fd.bandpass_mask(200.0, 3000.0, 24000.0, F)

# ---- a NumPy model of the kernel's pass schedule, from `tables`' values
# and `EXCHANGES`' addresses alone


def unpack(tab: np.ndarray) -> dict:
    """`tables`' array back as complex t1, t2, mask and float mask_sq."""
    m = 2 * kspec.MSQ_AT
    c = tab[:m:2] + 1j * tab[1:m:2]
    return dict(t1=c[kspec.T1_AT:kspec.T2_AT].reshape(R, TPC),
                t2=c[kspec.T2_AT:kspec.MASK_AT].reshape(R, R),
                mask=c[kspec.MASK_AT:kspec.MSQ_AT], mask_sq=tab[m:])


def _dft8(v: np.ndarray, inverse: bool) -> np.ndarray:
    """8-point DFT over the last axis, as the kernel's `dft8` splits it:
    a radix-2 step (x_j +- x_{j+4}, the difference twiddled by W8^(-+j)),
    then two 4-point DFTs, even outputs from the sums, odd from the
    differences."""
    a, b = v[..., :4] + v[..., 4:], v[..., :4] - v[..., 4:]
    sgn = 1.0 if inverse else -1.0
    b = b * np.exp(sgn * 2j * np.pi * np.arange(4) / 8)
    out = np.empty_like(v)
    for half, z in ((0, a), (1, b)):
        s0, d0 = z[..., 0] + z[..., 2], z[..., 0] - z[..., 2]
        s1, d1 = z[..., 1] + z[..., 3], z[..., 1] - z[..., 3]
        out[..., half] = s0 + s1
        out[..., 4 + half] = s0 - s1
        out[..., 2 + half] = d0 + sgn * 1j * d1
        out[..., 6 + half] = d0 - sgn * 1j * d1
    return out


def _exchange(v: np.ndarray, n: int) -> np.ndarray:
    """Exchange n (0-3) of `EXCHANGES` on v (..., TPC, R): scatter to a
    NaN-filled buffer, gather."""
    _, size, wr, rd = kspec.EXCHANGES[n]
    buf = np.full(v.shape[:-2] + (size,), np.nan, v.dtype)
    buf[..., wr] = v
    return buf[..., rd]


def forward(xw: np.ndarray, tab: dict) -> np.ndarray:
    """The forward transform of xw (..., F) as the kernel's threads hold
    it: (..., TPC, R), register m of thread u holding X[u + 64 m]."""
    lo = np.arange(TPC) % R
    # thread u holds xw[u + 64 j] in register j
    v = np.swapaxes(xw.reshape(xw.shape[:-1] + (R, TPC)), -1, -2)
    v = _dft8(v, False) * tab["t1"].T     # pass 1, twiddle W512^(u k1)
    v = _dft8(_exchange(v, 0), False) * tab["t2"][:, lo].T    # pass 2
    return _dft8(_exchange(v, 1), False)                      # pass 3


def inverse(v: np.ndarray, tab: dict) -> np.ndarray:
    """The unscaled inverse transform of Y held as `forward` leaves X:
    (..., TPC, R), register q of thread u holding F ifft(Y)[u + 64 q]."""
    lo = np.arange(TPC) % R
    v = _dft8(v, True) * np.conj(tab["t1"]).T     # twiddle W512^-(u p1)
    v = _dft8(_exchange(v, 2), True) * np.conj(tab["t2"])[:, lo].T
    return _dft8(_exchange(v, 3), True)


def natural(v: np.ndarray) -> np.ndarray:
    """(..., TPC, n) registers, register m of thread u holding element
    u + 64 m, in natural order (..., 64 n)."""
    return np.swapaxes(v, -1, -2).reshape(v.shape[:-2] + (-1,))


def model(hist: np.ndarray, x: np.ndarray, scale: float, tab: dict):
    """The kernel's schedule on (..., F/2) complex arrays, in their dtype,
    with the tables `tab` (`design`, or `unpack(tables(...))`): (new
    history, y, spec) as the kernel stores them."""
    xs = x * scale
    v = forward(np.concatenate([hist, xs], -1), tab)
    k = np.arange(TPC)[:, None] + TPC * np.arange(R)[None, :]   # X[k]
    spec = (v.real ** 2 + v.imag ** 2) * tab["mask_sq"][k]
    v = inverse(v * tab["mask"][k], tab)
    # the kept half of y is q >= 4
    return xs, natural(v[..., R // 2:]), natural(spec)


def _xw(kind: str, lead=(6,), seed=0) -> np.ndarray:
    """(lead..., F) complex128 test blocks."""
    rng = np.random.default_rng(seed)
    shape = lead + (F,)
    if kind == "random":
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    if kind == "real":      # nfm: real audio taken as complex
        return rng.standard_normal(shape) + 0j
    if kind == "impulse":   # one impulse a row, at spread positions
        z = np.zeros(shape, np.complex128)
        idx = np.arange(int(np.prod(lead))) * 97 % F
        z.reshape(-1, F)[np.arange(idx.size), idx] = 1.0 - 0.5j
        return z
    n = np.arange(F)        # tone: an off-bin tone a row
    f = rng.uniform(0, F, lead + (1,))
    return np.exp(2j * np.pi * f * n / F)


KINDS = ("random", "real", "impulse", "tone")


@pytest.mark.parametrize("kind", KINDS)
def test_forward_passes_are_np_fft(kind):
    xw = _xw(kind)
    got = natural(forward(xw, kspec.design(MASK)))
    ref = np.fft.fft(xw, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(
        ref).max())


@pytest.mark.parametrize("kind", KINDS)
def test_inverse_passes_are_np_ifft(kind):
    Y = _xw(kind, seed=1)
    regs = np.swapaxes(Y.reshape(Y.shape[:-1] + (R, TPC)),
                       -1, -2)       # element u + 64 m in register m
    got = natural(inverse(regs, kspec.design(MASK))) / F
    ref = np.fft.ifft(Y, axis=-1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(
        ref).max())


@pytest.mark.parametrize("scale", [1.0, 0.83])
@pytest.mark.parametrize("kind", KINDS)
def test_model_is_the_band_pass_and_its_spectrum(kind, scale):
    """The whole schedule in float64 (load, forward, spectrum, mask,
    inverse, the kept half) against np.fft on [h | scale x]."""
    xw = _xw(kind, seed=2)
    h, x = xw[..., :F // 2], xw[..., F // 2:]
    xs, y, spec = model(h, x, scale, kspec.design(MASK))
    X = np.fft.fft(np.concatenate([h, scale * x], -1), axis=-1)
    np.testing.assert_array_equal(xs, scale * x)
    ref_y = np.fft.ifft(X * MASK, axis=-1)[..., F // 2:]
    ref_s = np.abs(X) ** 2 * np.abs(MASK) ** 2
    np.testing.assert_allclose(y, ref_y, rtol=0,
                               atol=1e-12 * np.abs(ref_y).max())
    np.testing.assert_allclose(spec, ref_s, rtol=0,
                               atol=1e-12 * np.abs(ref_s).max())


def test_tables_round_the_float64_design_once():
    tab = kspec.tables(MASK)
    assert tab.dtype == np.float32 and tab.shape == (kspec.TABLE_FLOATS,)
    d, u = kspec.design(MASK), unpack(tab)
    for key in ("t1", "t2", "mask"):
        np.testing.assert_array_equal(u[key], d[key].astype(np.complex64))
    np.testing.assert_array_equal(u["mask_sq"], d["mask_sq"].astype(
        np.float32))
    # the plain version's |mask|^2, and its mask, 1/F folded in exactly
    _, _, msq = tosf.os_spectrum_operators(MASK)
    np.testing.assert_array_equal(u["mask_sq"], msq)
    np.testing.assert_array_equal(u["mask"] * F, MASK.astype(np.complex64))
    # the first pass's twiddle rows are W512^(k t), the second's W64^(m t)
    assert u["t1"][1, 1] == np.complex64(np.exp(-2j * np.pi / F))
    assert u["t2"][1, 1] == np.complex64(np.exp(-2j * np.pi / 64))
    with pytest.raises(ValueError):
        kspec.tables(MASK[:256])


@pytest.mark.parametrize("kind", KINDS)
def test_model_on_rounded_tables_agrees_with_the_plain_version(kind):
    """The float32 tables through the schedule (in float64 arithmetic)
    against `os_filter_matmul_spectrum` in float32: within float32
    rounding of the outputs' scale."""
    xw = _xw(kind, seed=3).astype(np.complex64)
    h, x = xw[..., :F // 2], xw[..., F // 2:]
    xs, y, spec = model(h.astype(np.complex128),
                              x.astype(np.complex128), 1.0,
                              unpack(kspec.tables(MASK)))
    ops = [torch.from_numpy(a) for a in tosf.os_spectrum_operators(MASK)]
    _, py, ps = tosf.os_filter_matmul_spectrum(torch.from_numpy(h),
                                               torch.from_numpy(x), *ops)
    for got, ref in ((y, py.numpy()), (spec, ps.numpy())):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * scale)


@pytest.mark.parametrize("n", range(len(kspec.EXCHANGES)))
def test_exchange_addresses(n):
    """Writes land on distinct slots inside the buffer, every read finds
    a written slot, and each half-warp's 8-byte accesses (a float2 slot s
    is banks 2s, 2s + 1 mod 32) fall on distinct banks."""
    _, size, wr, rd = kspec.EXCHANGES[n]
    assert wr.shape == rd.shape == (TPC, R)
    assert len(set(wr.ravel())) == wr.size and wr.max() < size
    assert set(rd.ravel()) == set(wr.ravel())
    for addr in (wr, rd):
        for i in range(R):
            for lanes in addr[:, i].reshape(-1, 16):
                assert len(set((2 * lanes) % 32)) == 16, (n, i, lanes)


@pytest.mark.parametrize("lead", [(7,), (2, 3)])
@pytest.mark.parametrize("scale", [1.0, 0.4172])
def test_wrapper_on_cpu_is_the_plain_version(lead, scale):
    chain = RxChain(ChainSpec(), device="cpu")
    t = chain.tensors
    rng = np.random.default_rng(4)

    def cx():
        return torch.from_numpy((rng.standard_normal(lead + (F // 2,))
                                 + 1j * rng.standard_normal(
                                     lead + (F // 2,))).astype(np.complex64))

    st, x = cx(), cx()
    n0 = kspec.os_spectrum.launches
    got = kspec.os_spectrum(st, x, t["os_F"], t["os_W2"], t["os_mask_sq"],
                            t["os_tab"], scale)
    ref = tosf.os_filter_matmul_spectrum(
        st, x if scale == 1.0 else x * scale, t["os_F"], t["os_W2"],
        t["os_mask_sq"])
    for a, b in zip(got, ref, strict=True):
        assert torch.equal(a, b)
    assert kspec.os_spectrum.launches == n0   # no kernel on the CPU


@pytest.mark.parametrize("mode", ["usb", "nfm"])
def test_chain_band_pass_on_cpu_is_unchanged(mode):
    """The chain's band-pass with kernels (B1's dispatch, the level scale
    passed in) on the CPU: the old path, `x * vol_scale` (not in nfm)
    then the two matmuls, bit for bit; the tables built from the chain's
    own mask."""
    chain = RxChain(ChainSpec(mode=mode), device="cpu")
    t = chain.tensors
    np.testing.assert_array_equal(t["os_tab"].numpy(), kspec.tables(
        fd.bandpass_mask(chain.spec.f_lo, chain.spec.f_hi, 24000.0, F)))
    rng = np.random.default_rng(5)
    st = chain.init_state((5,)).osf
    for _ in range(3):
        x = torch.from_numpy((rng.standard_normal((5, F // 2))
                              + 1j * rng.standard_normal((5, F // 2))
                              ).astype(np.complex64))
        scale = 1.0 if mode == "nfm" else chain.vol_scale
        got = chain._os_filter(st, x, scale)
        xs = x if mode == "nfm" else x * chain.vol_scale
        ref = tosf.os_filter_matmul_spectrum(st, xs, t["os_F"], t["os_W2"],
                                             t["os_mask_sq"])
        for a, b in zip(got, ref, strict=True):
            assert torch.equal(a, b)
        st = got[0]


def test_only_spectrum_tap_chains_build_the_tables():
    assert "os_tab" not in RxChain(ChainSpec(spectrum_taps=False),
                                   device="cpu").tensors
    assert "os_tab" not in RxChain(ChainSpec(use_kernels=False),
                                   device="cpu").tensors


def test_argtypes_match_the_entry_point():
    """The wrapper declares one ctypes type a parameter of
    `t41x_os_spectrum`, the stream included: a missing one passes the
    stream as a 32-bit int."""
    from t41x_torch.kernels import _build
    src = (_build.SRC_DIR / "os_spectrum.cu").read_text()
    params = re.search(r'extern "C" int t41x_os_spectrum\(([^)]*)\)',
                       src).group(1).split(",")
    assert len(kspec._ARGS) == len(params)
    assert [t is _build.PTR for t in kspec._ARGS] == [
        "*" in p for p in params]
