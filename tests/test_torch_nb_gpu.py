"""N1, the noise blanker's kernel, on the card.

Every case here needs a CUDA card and skips without one; the file
imports nothing of `t41x` or JAX, so the card's machine runs it as

    python -m pytest --noconftest -m gpu tests/test_torch_nb_gpu.py

N1 (`t41x_torch/csrc/nb.cu`) against `noise_blanker_plain` on the card
at 1, 7, 130 and 1024 frames x n 64, 256, 1000 and 1024, on the CPU
tests' stimuli (tone, noise and impulses; silent frames; impulses at the
guard's edges; adjacent impulses that merge; crowded impulse noise,
N1's slow path: long runs, and groups of runs closer than the
predictors' order) and on random frames, to
`parity.nb_decisions`: the blank masks equal but at decisions within
1e-4 of the threshold (counted; 0 expected), the output outside N1's
mask equal to the input bit for bit, the frames with equal masks >= 55
dB from the plain version, no NaN; plus one CUDA graph capture of the
dispatch replayed against the eager launch, and the wrapper's refusals.
The stimuli are this file's, so that the CPU tests
(`tests/test_torch_nb_kernel.py`) hold the plain version against t41x
on the same frames.
"""

import numpy as np
import pytest
import torch

from t41x_torch.dsp import nb as tnb
from t41x_torch.kernels import nb as knb
from t41x_torch.utils import parity

pytestmark = pytest.mark.gpu

KINDS = ("tone", "silent", "edges", "adjacent", "random", "crowded")
SPAN = tnb.ORDER + tnb.PL + 1   # the tone's impulses lie in [SPAN, n - SPAN)


def nb_frames(rng, lead: tuple, n: int, kind: str = "tone") -> np.ndarray:
    """float32 frames (*lead, n) of 24 kHz audio.  tone: a 600 Hz tone in
    light noise with 1-3 impulses a frame (as tests/test_torch_stages.py
    makes them); silent: zeros; edges: the tone with impulses at the hit
    guard's edges (hits count at [13, n - 14): impulses at 13, 12, n - 15
    and n - 14 by turns); adjacent: the tone with impulses 3 and 4
    samples apart, whose blanked regions merge (hits up to 2 PL + 1
    apart do); random: unit normal noise; crowded: impulse noise on most
    of the blankable range [10, n - 11) by turns of four frames: a train
    of +8, +8, -8, -8 impulses at most 7 samples apart over the whole
    guard in light noise, no tone (one run over [10, n - 11) at n 64, 256,
    1000 and 1024); the tone with random-sign impulses of 3 every 7
    samples (long runs); every 8 samples (runs of 7, one unset sample
    apart: a group of runs closer than ORDER); bursts of impulses 2-5
    apart."""
    ch = int(np.prod(lead, dtype=int))
    t = np.arange(n) / 24000.0
    x = (0.3 * np.sin(2 * np.pi * 600.0 * t + rng.uniform(0, 6, (ch, 1)))
         + 0.02 * rng.standard_normal((ch, n)))
    if kind == "silent":
        x[:] = 0.0
    elif kind == "random":
        x = rng.standard_normal((ch, n))
    for c in range(ch):
        sign = (-1) ** c
        if kind == "tone":
            k = c % 3 + 1
            for pos in rng.choice(np.arange(SPAN, n - SPAN), size=k,
                                  replace=False):
                x[c, pos] += 1.5 * sign
        elif kind == "edges":
            pos = (13, 12, n - 15, n - 14)[c % 4]
            x[c, pos] += 2.0 * sign
        elif kind == "adjacent":
            p = n // 2 - 4 + c % 5
            x[c, [p, p + 3, p + 7]] += 2.0 * sign
        elif kind == "crowded":
            _crowd(rng, x[c], c % 4, sign)
    return x.astype(np.float32).reshape(*lead, n)


def _crowd(rng, x: np.ndarray, turn: int, sign: float) -> None:
    """A crowded frame in place (see nb_frames)."""
    n = x.shape[-1]
    lo, hi = tnb.ORDER + tnb.PL, n - 15   # the first and last guarded hit
    if turn == 0:
        x[:] = 0.02 * rng.standard_normal(n)
        k = -(-(hi - lo) // 7) + 1
        pos = np.round(np.linspace(lo, hi, k)).astype(int)
        x[pos] += 8.0 * sign * np.array([1, 1, -1, -1])[np.arange(k) % 4]
    elif turn in (1, 2):
        step = 6 + turn
        pos = np.arange(lo + rng.integers(0, step), hi + 1, step)
        x[pos] += 3.0 * rng.choice([-1.0, 1.0], pos.size)
    else:
        for _ in range(max(1, n // 64)):
            s = rng.integers(lo, hi - 24)
            pos = np.arange(s, s + rng.integers(6, 24), rng.integers(2, 6))
            x[pos] += 2.0 * rng.choice([-1.0, 1.0], pos.size)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _check(x):
    """N1 against the plain version on frames x: the report of
    `parity.nb_decisions`, asserted ok."""
    y_k, mask_k = knb.launch_with_mask(x)
    y_p = tnb.noise_blanker_plain(x)
    mask_p, margin = tnb.decision_margin(x)
    torch.cuda.synchronize()
    rep = parity.nb_decisions(x, y_k, mask_k, y_p, mask_p, margin)
    assert rep["ok"], rep
    # the dispatch launches the same kernel: the same output, bit for bit
    assert torch.equal(tnb.noise_blanker(x), y_k)
    return rep


@pytest.mark.parametrize("kind", ["tone", "random", "crowded"])
@pytest.mark.parametrize("n", [64, 256, 1000, 1024])
@pytest.mark.parametrize("frames", [1, 7, 130, 1024])
def test_n1_equals_the_plain_version(cuda, frames, n, kind):
    rng = np.random.default_rng(frames * 31 + n)
    x = torch.from_numpy(nb_frames(rng, (frames,), n, kind)).to(cuda)
    before = knb.launch.launches
    rep = _check(x)
    assert knb.launch.launches == before + 2
    if kind == "tone" and n >= 256:
        assert rep["blanked_samples"] > 0
    if kind == "crowded":
        # the first frame is one run over the blankable range [10, n - 11)
        print(f"crowded {frames} x {n}: {rep['blanked_samples']} blanked")
        assert rep["blanked_samples"] >= n - 21


@pytest.mark.parametrize("kind", ["silent", "edges", "adjacent"])
@pytest.mark.parametrize("lead", [(), (7,), (2, 5)])
def test_n1_on_the_cpu_tests_stimuli(cuda, lead, kind):
    rng = np.random.default_rng(len(lead) * 5 + KINDS.index(kind))
    for n in (64, 256, 1000):
        x = torch.from_numpy(nb_frames(rng, lead, n, kind)).to(cuda)
        rep = _check(x)
        if kind == "silent":
            assert rep["blanked_samples"] == 0
            assert torch.equal(knb.launch(x), x)
        else:
            assert rep["blanked_samples"] > 0


def test_n1_captures_into_a_cuda_graph(cuda):
    rng = np.random.default_rng(3)
    xs = [torch.from_numpy(nb_frames(rng, (1024,), 256)).to(cuda)
          for _ in range(2)]
    static = xs[0].clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tnb.noise_blanker(static)   # builds the library before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = knb.launch.launches
    with torch.cuda.graph(graph):
        out = tnb.noise_blanker(static)
    assert knb.launch.launches == before + 1
    for x in xs:
        static.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, tnb.noise_blanker(x))


def test_n1_refuses_what_it_does_not_take(cuda):
    before = knb.launch.launches
    for bad in (torch.zeros(4, 256, dtype=torch.float64, device=cuda),
                torch.zeros(256, 4, device=cuda).t(),
                torch.zeros(4, knb.N_MIN - 1, device=cuda),
                torch.zeros(4, knb.N_MAX + 1, device=cuda)):
        with pytest.raises(ValueError):
            knb.launch(bad)
    assert knb.launch.launches == before
