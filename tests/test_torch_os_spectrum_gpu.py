"""B1, the spectrum-tap band-pass kernel, on the card.

Every case needs a CUDA card and skips without one; the file imports
nothing of `t41x` or JAX, so the card's machine runs it as

    python -m pytest --noconftest -m gpu tests/test_torch_os_spectrum_gpu.py

B1 (`t41x_torch/csrc/os_spectrum.cu`) at 1, 7 (ragged: a block holds 4
channels), 1024 and 4096 channels, on (B, C) lead dimensions, on real
input (nfm's audio taken as complex), at scale 1 and not, from random
histories over streamed blocks: against a float64 `np.fft` reference
and against its plain version (`os_filter_matmul_spectrum`, cuBLAS) on
the card; the new history is the scaled input bit for bit.  In the
chain: one launch a block of `RxChain.block` on the `ssb_pan` spec, the
`bandpass` segment of a captured graph one device op, no GEMM left in
the graph's replay, the replay equal to the eager blocks.
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.kernels import os_spectrum as kspec
from t41x_torch.runner import _clone, capture
from t41x_torch.utils import tracing

pytestmark = pytest.mark.gpu

CONFIGS = Path(__file__).resolve().parent.parent / "sdrbench" / "configs"
F, HALF = kspec.F, kspec.HALF
BLOCKS = 3
# the worst channel's ||got - ref|| / ||ref||: against float64 (B1 reads
# ~1.5e-7 run through a CPU emulation of its source), and against the
# plain version's fp32 GEMMs (~4e-7 from float64 themselves)
REL_F64, REL_PLAIN = 1e-6, 3e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 runs only there")
    tracing.reset()
    yield torch.device("cuda")
    tracing.reset()


def _chain(dev, **kw):
    return RxChain(ChainSpec(**kw), device=dev)


def _blocks(lead, real, seed):
    rng = np.random.default_rng(seed)
    shape = (BLOCKS,) + lead + (HALF,)
    z = rng.standard_normal(shape) + (0 if real else 1j) * \
        rng.standard_normal(shape)
    return (0.3 * z).astype(np.complex64)


def _worst_rel(got, ref) -> float:
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = ref.cpu().numpy() if isinstance(ref, torch.Tensor) else ref
    num = np.linalg.norm((got - ref).reshape(-1, ref.shape[-1]), axis=-1)
    den = np.linalg.norm(ref.reshape(-1, ref.shape[-1]), axis=-1)
    return float((num / den).max())


def _check(chain, lead, real, scale, seed):
    """B1 over BLOCKS streamed blocks from a random history: against
    float64 and the plain version, the history carried on each side."""
    dev, t = chain.device, chain.tensors
    ops = (t["os_F"], t["os_W2"], t["os_mask_sq"])
    xs = _blocks(lead, real, seed)
    h0 = _blocks(lead, real, seed + 1)[0]
    sk = sp = torch.from_numpy(h0).to(dev)
    h64 = h0.astype(np.complex128)
    mask = chain.mask.astype(np.complex128)
    n0 = kspec.os_spectrum.launches
    for b in range(BLOCKS):
        x = torch.from_numpy(xs[b]).to(dev)
        sk, yk, speck = kspec.os_spectrum(sk, x, *ops, t["os_tab"], scale)
        sp, yp, specp = kspec.os_spectrum_plain(sp, x, *ops, scale)
        assert yk.shape == x.shape and speck.shape == lead + (F,)
        assert bool(torch.isfinite(yk).all() and torch.isfinite(speck).all())
        assert torch.equal(sk, x * scale if scale != 1.0 else x)
        x64 = xs[b].astype(np.complex128) * np.float32(scale)
        X = np.fft.fft(np.concatenate([h64, x64], -1), axis=-1)
        h64 = x64
        y64 = np.fft.ifft(X * mask, axis=-1)[..., HALF:]
        s64 = np.abs(X) ** 2 * np.abs(mask) ** 2
        assert _worst_rel(yk, y64) <= REL_F64
        assert _worst_rel(speck, s64) <= REL_F64
        assert _worst_rel(yk, yp) <= REL_PLAIN
        assert _worst_rel(speck, specp) <= REL_PLAIN
    assert kspec.os_spectrum.launches == n0 + BLOCKS


@pytest.mark.parametrize("scale", [1.0, "vol"])
@pytest.mark.parametrize("ch", [1, 7, 1024, 4096])
def test_b1_against_float64_and_plain(cuda, ch, scale):
    chain = _chain(cuda)
    _check(chain, (ch,), False, chain.vol_scale if scale == "vol" else 1.0,
           seed=ch)


@pytest.mark.parametrize("lead", [(2, 7), (8, 130)])
def test_b1_on_lead_dimensions(cuda, lead):
    chain = _chain(cuda)
    _check(chain, lead, False, chain.vol_scale, seed=sum(lead))


@pytest.mark.parametrize("ch", [7, 1024])
def test_b1_on_real_input(cuda, ch):
    """nfm's post-demod band-pass: real audio as complex, scale 1."""
    _check(_chain(cuda, mode="nfm"), (ch,), True, 1.0, seed=3 * ch)


def test_b1_refuses_other_lengths(cuda):
    chain = _chain(cuda)
    t = chain.tensors
    x = torch.zeros(4, 128, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        kspec.os_spectrum(x, x, t["os_F"], t["os_W2"], t["os_mask_sq"],
                          t["os_tab"])
    x = torch.zeros(4, HALF, dtype=torch.complex64, device=cuda)
    with pytest.raises(ValueError):
        kspec.os_spectrum(x, x, t["os_F"], t["os_W2"], t["os_mask_sq"],
                          None)


def _pan(dev, channels=256, blocks=2):
    """The `ssb_pan` chain over `blocks` seeded q15 blocks: (chain, fn,
    state, inputs) as `runner.capture` takes them."""
    spec = json.loads((CONFIGS / "ssb_pan.json").read_text())["chain"]
    chain = RxChain(ChainSpec(**spec), device=dev)
    params = default_params((channels,), device=dev)
    g = torch.Generator(device=dev).manual_seed(21)
    data = [tuple(torch.randint(-8000, 8000, (channels, 2048),
                                dtype=torch.int16, device=dev, generator=g)
                  for _ in range(2)) for _ in range(blocks)]

    def fn(st):
        outs = {}
        for b, blk in enumerate(data):
            st, o = chain.block(params, st, blk)
            outs.update({f"{k}.{b}": v for k, v in o.items()})
        return st, outs

    return chain, fn, chain.init_state((channels,)), \
        [t for b in data for t in b]


def test_one_launch_a_block_in_the_pan_chain(cuda):
    chain, fn, st, _ = _pan(cuda, blocks=4)
    n0 = kspec.os_spectrum.launches
    fn(st)
    assert kspec.os_spectrum.launches == n0 + 4


def test_pan_graph_bandpass_is_one_op_and_no_gemm(cuda):
    """A captured `ssb_pan` graph of two blocks: each `bandpass` segment
    of its stage map is one device op, its replay launches B1 once a
    block and no GEMM, and its outputs equal the eager blocks' bit for
    bit."""
    _, fn, state, inputs = _pan(cuda)
    st_eager = _clone(state)
    with torch.cuda.device(cuda):
        graph, out = capture(fn, state, inputs, cuda)
    m = tracing.maps()[-1]
    band = [n for s, n in m.segments if s == "bandpass"]
    assert band == [1, 1], m.segments
    graph.replay()
    torch.cuda.synchronize(cuda)
    _, ref = fn(st_eager)
    for k, v in ref.items():
        assert torch.equal(out[k], v), k
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1)
        torch.cuda.synchronize(cuda)
        time.sleep(0.01)
        graph.replay()
        torch.cuda.synchronize(cuda)
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert sum("os_spectrum_kernel" in n for n in names) == 2, names
    assert not [n for n in names if "gemm" in n.lower()], names
