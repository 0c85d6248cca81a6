"""The data layouts the redesigned K1 and K4 kernels are fed, the bound
arithmetic of `chip_smoke.py`, and the chain's device default — on the
CPU, with no card and no compiler.

* K1 takes the DC biquad's in-chunk operator as its 127 Toeplitz taps,
  and the zoom tap's output operator as its 128 taps plus a state part:
  both rebuild the designed operators bit for bit.
* K4 reads W as k-major real and imaginary planes, which the chain
  packs once when it is built: they unpack to `os_W` exactly.
* `chip_smoke.py`'s operation and byte counts at the main path's shapes
  (1024 channels) equal the hand counts: K4 1.07 GFLOP, bound by its
  operations at ~16 us; K1 ~0.18 GFLOP of sample-by-sample work and
  ~23 MB, bound by its bytes at ~6.9 us.
* With no card, `RxChain(ChainSpec())` and `default_params` raise: the
  chain runs on the card unless the caller passes `device="cpu"`.
* K3: its library yardstick (one stride-8 transposed convolution with
  the two stages' composed taps) is the same function, and its bound is
  2.89 us of bytes; `kernel_sanitize.py`'s race build puts a spin after
  every barrier of every source; the scripts that run on the card
  (`chip_smoke.py`, `kernel_ab.py`, `kernel_sanitize.py`,
  `kernel_study.py`) load nothing of JAX.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from t41x_torch import constants as C
from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.dsp import iir
from t41x_torch.dsp.spectrum import ZoomFFT
from t41x_torch.kernels import frontend as kfe
from t41x_torch.kernels import os_filter as kos
from t41x_torch.utils import convert

CHAIN = RxChain(ChainSpec(), device="cpu")


def test_dc_taps_rebuild_the_chunk_operator_bit_for_bit():
    op = iir.BiquadChunked(CHAIN.dc_b, CHAIN.dc_a, chunk=128)
    h = kfe.dc_taps(op)
    assert h.shape == (127,) and h.dtype == np.float32
    n, j = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    L = np.where(j < n, np.append(h, 0.0)[n - 1 - j], 0.0)  # h[n-1-j]
    np.testing.assert_array_equal(L.astype(np.float32), op.L[0])
    fe = kfe.FusedFrontEnd(CHAIN.h1, CHAIN.h2, CHAIN.dc_b[0], CHAIN.dc_a[0])
    # the kernel's constant block: [0, h], R, G, AK, b0, reversed taps
    kc = fe.kernel_consts
    np.testing.assert_array_equal(kc[1:128], h)
    assert kc[0] == 0.0
    np.testing.assert_array_equal(kc[128:384], op.R[0].ravel())
    np.testing.assert_array_equal(kc[384:640], op.G[0].ravel())
    np.testing.assert_array_equal(kc[640:644], op.AK[0].ravel())
    assert kc[644] == op.b0[0]
    np.testing.assert_array_equal(kc[645:673], CHAIN.h1[::-1])
    np.testing.assert_array_equal(kc[673:], CHAIN.h2[::-1])


@pytest.mark.parametrize("zoom", range(1, 8))
def test_zoom_taps_rebuild_the_output_operator_bit_for_bit(zoom):
    z = ZoomFFT(zoom)
    fe = kfe.FusedFrontEnd(CHAIN.h1, CHAIN.h2, CHAIN.dc_b[0], CHAIN.dc_a[0],
                           zoom=zoom, zoom_sos=(z.iir_b, z.iir_a),
                           zoom_h=z.h)
    K, zf = 128, 1 << zoom
    hz, Rz = kfe.zoom_taps(fe.Wy)
    assert hz.shape == (K,) and Rz.shape == (K // zf, fe.z_states)
    n = (np.arange(K // zf) + 1) * zf - 1           # each output's sample
    i = np.arange(K)[:, None]
    rebuilt = np.where(i <= n[None, :], hz[np.clip(n[None, :] - i, 0, K - 1)],
                       0.0).astype(np.float32)
    np.testing.assert_array_equal(rebuilt, fe.Wy[:K])
    np.testing.assert_array_equal(Rz.T, fe.Wy[K:])


def test_k4_planes_round_trip_to_os_w():
    W = torch.from_numpy(CHAIN.os_W)
    Wp = kos.pack_w(W)
    half = C.FFT_LENGTH // 2
    assert Wp.shape == (2, 2 * half, half) and Wp.dtype == torch.float32
    assert Wp.is_contiguous()
    assert torch.equal(torch.complex(Wp[0], Wp[1]).T, W)
    assert torch.equal(Wp[0], W.real.T) and torch.equal(Wp[1], W.imag.T)


def test_k4_planes_are_packed_once_per_w():
    """Each chain packs its own W when it is built, and its K4 call
    passes those planes: a chain of another passband has other planes."""
    planes = []
    for f_hi in (3000.0, 1500.0):
        chain = RxChain(ChainSpec(f_hi=f_hi, spectrum_taps=False),
                        device="cpu")
        Wp = chain.tensors["os_Wp"]
        assert torch.equal(Wp, kos.pack_w(chain.tensors["os_W"]))
        planes.append(Wp)
    assert not torch.equal(*planes)
    assert "os_Wp" not in RxChain(ChainSpec(use_kernels=False),
                                  device="cpu").tensors


def test_bound_arithmetic_matches_the_hand_counts():
    ch, half = 1024, C.FFT_LENGTH // 2
    # K4: 8 C (F/2) F flops, 16 us at 67 TFLOP/s; ~7.3 MB of bytes
    flops = chip_smoke.k4_flops(ch, half)
    assert flops == 8 * 1024 * 256 * 512 and abs(flops - 1.07e9) < 0.01e9
    nbytes = 3 * ch * half * 8 + half * 2 * half * 8
    b = chip_smoke.bound(flops, nbytes)
    assert b["bound_by"] == "operations"
    assert abs(b["bound_ms"] * 1e3 - 16.0) < 0.1
    # K1 at zoom 0, per sample and channel: gain and IQ correction 5
    # flops, the DC biquad 20 (5 FMAs, I and Q), the NCO 8, the x4
    # decimator 28 taps x 4 flops every 4th sample, the x2 decimator 46
    # x 4 every 8th: 172032 flops a channel, ~0.18 GFLOP, ~2.6 us; its
    # ~23 MB of input, output and zoom-x1 segment take ~6.9 us
    parts = chip_smoke.k1_flops(ch, 0)
    assert sum(parts.values()) == ch * (2048 * (5 + 20 + 8) + 512 * 28 * 4
                                        + 256 * 46 * 4) == ch * 172032
    io = ch * C.BLOCK_SIZE * 8 + ch * C.AUDIO_BLOCK * 8 + ch * 512 * 8
    assert abs(io - 23.1e6) < 0.1e6
    b = chip_smoke.bound(sum(parts.values()), io)
    assert b["bound_by"] == "bytes"
    assert abs(b["bound_ms"] * 1e3 - 6.9) < 0.05
    # K1z adds the 4-section anti-alias IIR at the RF rate and the 4-tap
    # decimator's outputs: most at zoom 1, still bound by bytes
    z = ZoomFFT(1)
    assert z.iir_b.shape[0] == 4 and len(z.h) == 4
    z1 = chip_smoke.k1_flops(ch, 1)
    assert z1["zoom_iir"] == ch * 2048 * 80
    assert z1["zoom_fir"] == ch * 1024 * 16
    z7 = sum(chip_smoke.k1_flops(ch, 7).values())
    assert sum(z1.values()) > z7 > sum(parts.values())
    io1 = ch * C.BLOCK_SIZE * 8 + ch * C.AUDIO_BLOCK * 8 + ch * 1024 * 8
    assert chip_smoke.bound(sum(z1.values()), io1)["bound_by"] == "bytes"
    b = chip_smoke.bound(1.0, 3.35e6)
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 1e-3) < 1e-12


def test_chain_defaults_to_the_card_and_raises_without_one():
    assert ChainSpec().use_kernels
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default is usable here")
    with pytest.raises(RuntimeError, match="device=.cpu."):
        RxChain(ChainSpec())
    with pytest.raises((RuntimeError, AssertionError)):
        default_params((2,))
    with pytest.raises((RuntimeError, AssertionError)):
        convert.params_from_numpy(default_params((2,), device="cpu"))


def test_k3_library_call_is_the_two_stages():
    """chip_smoke.py's yardstick for K3: one stride-8 transposed
    convolution with h8 = h2 * (h1 zero-stuffed by 4), 220 taps, over the
    block and 27 samples of 24 kHz history, equals the two polyphase
    stages from zero histories (float64: the algebra, not the rounding)."""
    import torch.nn.functional as F

    from t41x_torch.dsp import fir
    chain = RxChain(ChainSpec(use_kernels=False), device="cpu")
    h8, hist = chip_smoke.k3_library_taps(chain.hi1, chain.hi2)
    assert len(h8) == 47 * 4 + 1 + 32 - 1 == 220 and hist == 27
    rng = np.random.default_rng(3)
    ch, n = 3, C.AUDIO_BLOCK
    x = torch.from_numpy(rng.standard_normal((ch, n)))
    h1 = torch.from_numpy(chain.hi1.astype(np.float64))
    h2 = torch.from_numpy(chain.hi2.astype(np.float64))
    _, u = fir.fir_interpolate(torch.zeros(ch, 23, dtype=torch.float64), x,
                               h1, C.DF2)
    _, y = fir.fir_interpolate(torch.zeros(ch, 7, dtype=torch.float64), u,
                               h2, C.DF1)
    xh = torch.cat([torch.zeros(ch, hist, dtype=torch.float64), x], dim=-1)
    lib = F.conv_transpose1d(xh[:, None], torch.from_numpy(h8)[None, None],
                             stride=C.DF)[:, 0, C.DF * hist: C.DF * (hist + n)]
    assert float((lib - y).abs().max()) < 1e-12 * float(y.abs().max())


def test_k3_bound_arithmetic_matches_the_hand_count():
    """K3 at the chain's shapes: 24 taps a phase at x2 and 8 at x4, 28.7k
    FMAs and the volume a channel; 1.15 KB in (the audio, both histories,
    the scale) and 8.3 KB out (y, both new histories): 2.89 us of bytes
    at 1024 channels, against 0.9 us of fp32."""
    ch, n = 1024, C.AUDIO_BLOCK
    flops = chip_smoke.k3_flops(ch, n)
    assert flops == ch * (2 * (512 * 24 + 2048 * 8) + 2048)
    nbytes = 4 * ch * ((n + 23 + 7 + 1) + (8 * n + 23 + 7))
    b = chip_smoke.bound(flops, nbytes)
    assert b["bound_by"] == "bytes"
    assert abs(b["bound_ms"] * 1e3 - 2.89) < 0.01
    assert abs(flops / chip_smoke.PEAK_FP32 * 1e6 - 0.9) < 0.05


def test_jittered_sources_spin_after_every_barrier():
    """kernel_sanitize.py's race check builds every source with a spin
    after each block and cluster barrier and each call of a named-barrier
    helper (C1's four: its two roles' waits and arrivals; B1's four: a
    channel's two warps at each exchange), and a lane's
    own spin after each call of N1's warp barrier helper (its two
    `warp_sync()`: before and after the predictors' walk, where a
    frame's lanes exchange its scratch).  S1 has no site: no shared
    memory, its lanes meet only in shuffles."""
    import re

    import kernel_sanitize
    from t41x_torch.kernels import _build
    total = named = lanes = 0
    for f in sorted(_build.SRC_DIR.glob("*.cu")):
        src = f.read_text()
        text, sites = kernel_sanitize.jittered(src)
        calls = len(re.findall(r"named_bar_(?:sync|arrive)\(\w", src)) - len(
            re.findall(r"void named_bar_(?:sync|arrive)\(", src))
        warp = src.count("warp_sync();")
        assert sites == (src.count("__syncthreads();")
                         + src.count("cluster.sync();") + calls + warp)
        assert sites > 0 or "__shared__" not in src, f.name
        assert text.count("t41x_jitter(__LINE__);") == sites - warp
        assert text.count("t41x_jitter_lane(__LINE__);") == warp
        assert text.count("static __device__ __forceinline__ void "
                          "t41x_jitter(unsigned site)") == 1
        # the helpers' definitions are left alone
        assert "void named_bar_sync(int id) t41x_jitter" not in text
        assert "void warp_sync() t41x_jitter" not in text
        total += sites
        named += calls
        lanes += warp
    assert named == 8 and lanes == 2
    assert total >= 30


def test_chip_scripts_never_import_jax():
    """chip_smoke.py, kernel_ab.py, kernel_sanitize.py and
    kernel_study.py run on the card's machine, which has no JAX:
    importing them, and building kernel_sanitize's rows on the CPU, loads
    nothing of JAX or t41x."""
    code = (
        "import sys, torch\n"
        "sys.modules['jax'] = None\n"
        "import chip_smoke, kernel_ab, kernel_sanitize, kernel_study\n"
        "g = torch.Generator().manual_seed(0)\n"
        "rows = kernel_sanitize.kernel_rows(torch.device('cpu'), 3, g)\n"
        "assert len(rows) == 26, len(rows)\n"  # K1-K8, B1, C1, N1 (2), S1,
        # E1 (3)
        "bad = [m for m in sys.modules if m == 't41x' or "
        "m.startswith(('t41x.', 'jax.', 'jaxlib'))]\n"
        "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
