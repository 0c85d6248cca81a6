"""N1, the noise blanker's kernel: what runs without a card.

The dispatch `t41x_torch.dsp.nb.noise_blanker` takes the plain version
for CPU tensors and for `use_kernel=False` (no launch counted), and
hands a CUDA tensor to N1's wrapper (`t41x_torch/kernels/nb.py`), which
imports without CUDA and refuses a float64, non-contiguous or
out-of-range frame before any launch (a faked library and device, as
tests/test_torch_device_guard.py fakes them).  The plain version is held
against `t41x.dsp.nb.noise_blanker` on the card tests' stimuli
(tests/test_torch_nb_gpu.py `nb_frames`, made with numpy from a seed) at
n 64, 256 and 1000 and leading shapes (), (7,) and (2, 5), silent
frames, impulses at the hit guard's edges, adjacent impulses that merge
and crowded impulse noise (N1's slow path), at the bounds of
tests/test_torch_stages.py: rtol 2e-4 / atol 2e-5, the blanked mask
equal, samples outside the mask equal to the input bit for bit.  The
walk N1 implements (`t41x_torch.dsp.nb.walk_by_runs`: the mask's runs,
chained into groups by gaps shorter than ORDER, each group walked
alone) is held bit for bit against `_run_pred` and the plain cross-fade
weights on every stimulus kind and on masks built to put runs at the
frame's edges and at every gap around ORDER.  The chain's nb spec
passes `use_kernels` through to the dispatch, and `chip_smoke.py`
counts N1's operations and bound as the kernel's note states them and
makes its crowded stimulus as `nb_frames` does.
"""

import contextlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t41x import constants as C
from t41x.dsp import nb as jnb
from t41x_torch.chain import ChainSpec, RxChain, default_params
from t41x_torch.dsp import nb as tnb
from t41x_torch.kernels import _build, nb as knb
from test_torch_nb_gpu import KINDS, nb_frames

ROOT = Path(__file__).resolve().parent.parent


def _close(got, ref, rtol=2e-4, atol=2e-5, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol,
                               atol=atol, err_msg=msg)


def _regions(mask: np.ndarray) -> np.ndarray:
    """Blanked regions a frame: rising edges of the mask."""
    m = mask.reshape(-1, mask.shape[-1])
    return (m[:, 1:] & ~m[:, :-1]).sum(-1) + m[:, 0]


def _hold_against_t41x(x: np.ndarray, msg: str) -> np.ndarray:
    """noise_blanker_plain against t41x on frames x; returns the mask."""
    ty = tnb.noise_blanker_plain(torch.from_numpy(x))
    jy = np.asarray(jnb.noise_blanker(jnp.asarray(x)))
    _close(ty, jy, msg=msg)
    mask, margin = tnb.decision_margin(torch.from_numpy(x))
    mask = mask.numpy()
    # the blanked mask is t41x's, and outside it the input, bit for bit
    np.testing.assert_array_equal(mask, jy != x, err_msg=msg)
    np.testing.assert_array_equal(mask, ty.numpy() != x, err_msg=msg)
    np.testing.assert_array_equal(ty.numpy()[~mask].view(np.int32),
                                  x[~mask].view(np.int32), err_msg=msg)
    assert np.isfinite(ty.numpy()).all(), msg
    # decisions are made only at the guarded samples [13, n - 14), and
    # the dilated mask stays inside [10, n - 11): a zero-filled shift
    # gives what the wrapping roll gives
    n = x.shape[-1]
    t = np.arange(n)
    assert np.isinf(margin.numpy()[..., (t < 13) | (t >= n - 14)]).all()
    assert not mask[..., (t < 10) | (t >= n - 11)].any(), msg
    return mask


@pytest.mark.parametrize("lead", [(), (7,), (2, 5)])
@pytest.mark.parametrize("n", [64, 256, 1000])
def test_plain_matches_t41x(n, lead):
    rng = np.random.default_rng(n + 3 * len(lead))
    x = nb_frames(rng, lead, n, "tone")
    mask = _hold_against_t41x(x, f"n {n} lead {lead}")
    assert mask.any()


# the crowded stimulus' blanked samples at seed 11, 8 frames, n 64 then 256
CROWDED_BLANKED = {64: 247, 256: 1207}


@pytest.mark.parametrize("kind",
                         ["silent", "edges", "adjacent", "random", "crowded"])
def test_plain_matches_t41x_on_edge_cases(kind):
    rng = np.random.default_rng(11)
    for n in (64, 256):
        x = nb_frames(rng, (8,), n, kind)
        mask = _hold_against_t41x(x, f"{kind} n {n}")
        if kind == "crowded":
            _assert_crowded(mask, CROWDED_BLANKED[n])
        if kind == "silent":
            assert not mask.any()
            assert np.array_equal(
                tnb.noise_blanker_plain(torch.from_numpy(x)).numpy(), x)
        elif kind == "edges":
            # impulses at 13 and n - 15 lie inside the guard: blanked
            assert mask[0::4].any(-1).all() and mask[2::4].any(-1).all()
        elif kind == "adjacent":
            # three impulses 3 and 4 samples apart: one merged region
            assert (_regions(mask) == 1).all()
            assert (mask.sum(-1) >= 7 + 2 * tnb.PL + 1).all()


def _assert_crowded(mask: np.ndarray, blanked: int) -> None:
    """A crowded stimulus' mask: every fourth frame from the first one run
    over the blankable range [10, n - 11); at least a quarter of the
    frames blanked over 60% of it, some in several merged runs (a group
    closer than ORDER); the pinned count of blanked samples."""
    m = mask.reshape(-1, mask.shape[-1])
    n = m.shape[-1]
    print(f"crowded {m.shape[0]} x {n}: {int(m.sum())} blanked")
    assert int(m.sum()) == blanked
    assert (_regions(m[0::4]) == 1).all() and m[0::4, 10:n - 11].all()
    share = m.sum(-1) / (n - 21)
    assert (share >= 0.6).mean() >= 0.25
    assert ((share >= 0.6) & (_regions(m) > 1)).any()


def _pred_and_weights(x: torch.Tensor, mask: torch.Tensor, a: torch.Tensor):
    """The plain version's predictors and cross-fade weights."""
    fwd = tnb._run_pred(x, mask, a)
    bwd = tnb._run_pred(x.flip(-1), mask.flip(-1), a).flip(-1)
    d_fw = tnb._distance_from_start(mask)
    d_bw = tnb._distance_from_start(mask.flip(-1)).flip(-1)
    return fwd, bwd, d_fw / torch.clamp(d_fw + d_bw, min=1.0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [64, 256, 1000])
def test_walk_by_runs_is_the_plain_walk(kind, n):
    """N1's walk (runs, groups, each group alone, weights from the runs)
    equals `_run_pred` and the plain weights bit for bit."""
    x = torch.from_numpy(nb_frames(np.random.default_rng(n + 7), (6,), n,
                                   kind))
    lpcs, _, _, mask = tnb._detect(x, tnb.NB_THRESH)
    a = -lpcs[..., 1:]
    got = tnb.walk_by_runs(x, mask, a)
    for g, w, what in zip(got, _pred_and_weights(x, mask, a),
                          ("forward", "backward", "weights")):
        assert torch.equal(g, w), f"{kind} n {n}: {what}"
    if kind != "silent":
        assert mask.any()


def _edge_masks(n: int) -> torch.Tensor:
    """Masks with runs at the frame's edges [ORDER, n - ORDER) and gaps of
    ORDER - 1, ORDER and ORDER + 1 first, then of every length from 1 to
    2 ORDER + 1, runs of 1 to 30 samples."""
    gaps = [tnb.ORDER - 1, tnb.ORDER, tnb.ORDER + 1,
            *range(1, 2 * tnb.ORDER + 2)]
    rows = []
    for first_len in (1, 7, 30):
        m = torch.zeros(n, dtype=torch.bool)
        t = tnb.ORDER
        for i in range(n):
            ln = first_len if i == 0 else 1 + (3 * i) % 13
            if t + ln > n - tnb.ORDER:
                break
            m[t:t + ln] = True
            t += ln + gaps[i % len(gaps)]
        m[n - tnb.ORDER - 1] = True   # a run that ends at the last place
        rows.append(m)
    m = torch.zeros(n, dtype=torch.bool)
    m[tnb.ORDER:n - tnb.ORDER] = True   # one run over everything
    rows.append(m)
    return torch.stack(rows)


@pytest.mark.parametrize("n", [64, 256])
def test_walk_by_runs_on_edge_masks(n):
    """Runs at the frame's edges and gaps around ORDER, from random frames
    and predictors: the walk equals the plain version bit for bit with
    groups split at gaps of ORDER, and not with a rule one sample
    looser (gaps of ORDER - 1 then walked from the input alone)."""
    masks = _edge_masks(n)
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((len(masks), n))
                         .astype(np.float32))
    a = torch.from_numpy((0.3 * rng.standard_normal((len(masks), tnb.ORDER))
                          / np.arange(1, tnb.ORDER + 1)).astype(np.float32))
    want = _pred_and_weights(x, masks, a)
    for g, w in zip(tnb.walk_by_runs(x, masks, a), want):
        assert torch.equal(g, w)
    loose = tnb.walk_by_runs(x, masks, a, gap=tnb.ORDER - 1)
    assert not torch.equal(loose[0], want[0])
    assert not torch.equal(loose[1], want[1])
    assert torch.equal(loose[2], want[2])


def test_runs_and_groups():
    m = torch.zeros(60, dtype=torch.bool)
    for s, e in ((10, 17), (20, 27), (37, 38), (48, 50)):
        m[s:e] = True
    runs = tnb.blank_runs(m)
    assert runs == [(10, 17), (20, 27), (37, 38), (48, 50)]
    # gaps 3, 10 and 10: a gap of ORDER starts a new group
    assert tnb.run_groups(runs) == [[(10, 17), (20, 27)], [(37, 38)],
                                    [(48, 50)]]
    assert tnb.run_groups(runs, gap=11) == [runs]
    assert tnb.blank_runs(torch.zeros(5, dtype=torch.bool)) == []
    with pytest.raises(ValueError):
        tnb.walk_by_runs(torch.zeros(1, 30), torch.arange(30)[None] == 3,
                         torch.zeros(1, tnb.ORDER))


def test_chip_smoke_crowded_stimulus():
    """chip_smoke.py's crowded frames (torch, on the card's generator)
    follow `nb_frames`' recipe: every fourth frame one run over the
    blankable range, most of the rest crowded."""
    import chip_smoke

    g = torch.Generator().manual_seed(5)
    x = chip_smoke.nb_stimulus("crowded", 16, 256, g, torch.device("cpu"))
    mask = tnb.decision_margin(x)[0].numpy()
    _assert_crowded(mask, 2549)
    tone = chip_smoke.nb_stimulus("tone", 64, 256, g, torch.device("cpu"))
    assert not tone[8::16].any() and tnb.decision_margin(tone)[0].any()
    with pytest.raises(ValueError):
        chip_smoke.nb_stimulus("dense", 4, 256, g, torch.device("cpu"))


def test_dispatch_takes_the_plain_version_on_the_cpu():
    x = torch.from_numpy(nb_frames(np.random.default_rng(1), (5,), 256))
    before = knb.launch.launches
    want = tnb.noise_blanker_plain(x)
    for kw in ({}, dict(use_kernel=True), dict(use_kernel=False)):
        assert torch.equal(tnb.noise_blanker(x, **kw), want)
    assert knb.launch.launches == before


def test_dispatch_launches_n1_for_cuda_tensors(monkeypatch):
    """A CUDA tensor goes to N1's wrapper, contiguous and with the
    threshold; with use_kernel=False to the plain version."""
    calls = []
    monkeypatch.setattr(knb, "launch",
                        lambda x, thresh: calls.append(("N1", x, thresh)))
    monkeypatch.setattr(tnb, "noise_blanker_plain",
                        lambda x, thresh: calls.append(("plain", x, thresh)))
    x = torch.zeros(256, 6).t()       # a strided view
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    tnb.noise_blanker(x, 3.0)
    tnb.noise_blanker(x, use_kernel=False)
    monkeypatch.undo()
    (k1, xk, tk), (k2, xp, tp) = calls
    assert (k1, tk, k2, tp) == ("N1", 3.0, "plain", tnb.NB_THRESH)
    assert xk.is_contiguous() and torch.equal(xk, x) and xp is x


def test_kernel_module_imports_without_cuda():
    code = ("import sys, torch\n"
            "sys.modules['triton'] = None\n"
            "from t41x_torch.kernels import _build, nb\n"
            "assert not torch.cuda.is_available()\n"
            "assert _build._lib is None and nb.launch.launches == 0\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 0, res.stderr


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


def test_wrapper_refuses_before_any_launch(fake_library):
    calls = fake_library
    before = knb.launch.launches
    good = torch.zeros(3, 256)
    bad = [torch.zeros(3, 256, dtype=torch.float64),
           torch.zeros(256, 3).t(),
           torch.zeros(3, knb.N_MIN - 1),
           torch.zeros(3, knb.N_MAX + 1),
           torch.zeros(())]
    for x in bad:
        with pytest.raises(ValueError):
            knb.launch(x)
    for words in (torch.zeros(3, 8, dtype=torch.int64),
                  torch.zeros(3, 7, dtype=torch.int32),
                  torch.zeros(8, 3, dtype=torch.int32).t()):
        with pytest.raises(ValueError):
            knb.launch(good, masks=words)
    assert calls == [] and knb.launch.launches == before
    # what it takes: every n in range, the frames on the leading axes
    words = torch.zeros(6, knb.mask_words(1000), dtype=torch.int32)
    x = torch.zeros(2, 3, 1000)
    y = knb.launch(x, 2.0, words)
    (name, args), = calls
    assert name == "t41x_nb" and y.shape == x.shape
    assert args == (x.data_ptr(), 6, 1000, 2.0, y.data_ptr(),
                    words.data_ptr(), 0xBEEF)
    knb.launch(torch.zeros(knb.N_MIN))
    assert calls[-1][1][1:3] == (1, knb.N_MIN)
    assert knb.launch.launches == before + 2


def test_mask_words_unpack():
    words = torch.tensor([[1 - 2**31, 0b101], [0, -1]], dtype=torch.int32)
    m = knb.unpack_mask(words, 40).numpy()
    assert knb.mask_words(40) == 2 and knb.mask_words(64) == 2
    assert list(np.flatnonzero(m[0])) == [0, 31, 32, 34]
    assert list(np.flatnonzero(m[1])) == list(range(32, 40))


def test_kernel_source_agrees_with_the_wrapper():
    """nb.cu's order, guard, dilation and frame range are the plain
    version's and the wrapper's."""
    src = (_build.SRC_DIR / "nb.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("ORDER") == tnb.ORDER and const("PL") == tnb.PL
    assert const("EDGE") == 14 and const("N_MAX") == knb.N_MAX
    assert knb.N_MIN == tnb.ORDER + 1
    # a stamps row: the phases, then the total cycles and nanoseconds
    assert const("N_PHASES") == len(knb.N1_PHASES)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_chain_passes_use_kernels_to_the_blanker(monkeypatch, use_kernels):
    seen = []
    plain = tnb.noise_blanker_plain

    def spy(x, thresh=tnb.NB_THRESH, use_kernel=True):
        seen.append((tuple(x.shape), use_kernel))
        return plain(x, thresh)

    monkeypatch.setattr(tnb, "noise_blanker", spy)
    chain = RxChain(ChainSpec(mode="usb", nb_on=True, use_kernels=use_kernels),
                    device="cpu")
    rng = np.random.default_rng(2)
    iq = torch.from_numpy((rng.standard_normal((2, C.BLOCK_SIZE))
                           + 1j * rng.standard_normal((2, C.BLOCK_SIZE)))
                          .astype(np.complex64) * 0.1)
    chain.block(default_params((2,), device="cpu"), chain.init_state((2,)),
                iq)
    assert seen == [((2, C.AUDIO_BLOCK), use_kernels)]


def test_n1_bound_at_the_chain_shape():
    """chip_smoke.py's count for N1 at 1024 frames of 256: 72 operations
    a sample (lags, FIRs, variance, hit test), 151 a frame (Levinson,
    threshold) and 45 a blanked sample (two predictions, the
    cross-fade), so at most ~118 a sample, ~30 k a frame; its bound is
    its bytes, 8 a sample, 0.63 us."""
    import chip_smoke

    x = torch.zeros(1024, 256)
    none = chip_smoke.n1_flops(x, torch.zeros(1024, 256, dtype=torch.bool))
    every = chip_smoke.n1_flops(x, torch.ones(1024, 256, dtype=torch.bool))
    assert none == 72 * 1024 * 256 + 151 * 1024
    assert every / 1024 == 72 * 256 + 151 + 45 * 256
    assert 29_000 < every / 1024 < 31_000
    for flops in (none, every):
        b = chip_smoke.bound(flops, 2 * x.numel() * 4)
        assert b["bound_by"] == "bytes"
        assert abs(b["bound_ms"] * 1e3 - 0.626) < 0.001
