"""The arithmetic order of the AGC kernels K2 and K5, held on the CPU.

`t41x_torch/csrc/agc.cu` computes the window peak as a doubling table
over a block's (time, channel) tile, runs the recurrence with every
branch of `agc_step` folded into three candidate volts and a few
selects, and evaluates the gain curve after the recurrence instead of
inside it.  The kernels run only on a card; these tests hold a Python
model of each of those orders bit for bit against the port's plain
versions (`t41x_torch.dsp.agc`), from random carried states that reach
all five AGC states.  The last test holds the plain `agc_apply` against
the scalar transcription of the reference's loop
(`tests/test_agc_oracle.py`).
"""

import numpy as np
import pytest
import torch

from t41x_torch.dsp import agc as tagc
from test_agc_oracle import scalar_agc_oracle

torch.set_num_threads(1)
T = torch.from_numpy

CB = 8              # K2's channels per thread block (agc.cu)
PITCH = CB + 1      # its shared-memory row pitch
MODES = [1, 2, 3, 4]
# a near-silence, a burst, a deeper silence, a moderate level
LEVELS = (0.001, 0.3, 0.0005, 0.05)


def _cx(rng, *shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            * scale).astype(np.complex64)


def _rand_state(rng, p, ch):
    """Any of the five states, live hang counters, either decay type."""
    ring = _cx(rng, ch, p.attack_buffsize, scale=0.1)
    u = lambda lo, hi: T(rng.uniform(lo, hi, ch).astype(np.float32))  # noqa
    ri = lambda hi: T(rng.integers(0, hi, ch).astype(np.int32))  # noqa
    return tagc.AGCState(T(ring), T(np.abs(ring)), u(p.min_volts, 1.5),
                         u(0.0, 1.5), u(0.0, 0.5), u(0.0, 0.1), ri(300),
                         ri(2), ri(5))


def _streams(rng, p, st, n):
    """One block's ring-max and |out| streams (ch, n), as agc_apply forms
    them, and the state with the new delay line."""
    x = T(_cx(rng, st.ring.shape[0], n, scale=LEVELS[rng.integers(4)]))
    full = torch.cat([st.ring, x], dim=-1)
    abs_full = torch.cat([st.abs_ring, x.abs()], dim=-1)
    rm = tagc._sliding_window_max(abs_full, p.attack_buffsize)[..., 1:1 + n]
    st = st._replace(ring=full[..., n:], abs_ring=abs_full[..., n:])
    return rm, abs_full[..., :n], st


def _kernel_window_peak(abs_full: np.ndarray, b: int, n: int) -> np.ndarray:
    """agc.cu's window peak, index for index: per block of CB channels a
    time-major (L, PITCH) tile (cells no thread writes hold NaN, which
    fmaxf ignores as np.fmax does), width-2w tables from width-w ones
    over flat index ranges, then ring_max[t] = max of two width-s
    windows, s the largest power of two <= b."""
    ch, L = abs_full.shape
    out = np.empty((ch, n), np.float32)
    for c0 in range(0, ch, CB):
        nc = min(CB, ch - c0)
        sabs = np.full(L * PITCH, np.nan, np.float32)
        sabs.reshape(L, PITCH)[:, :nc] = abs_full[c0:c0 + nc].T
        src, width = sabs, 1
        while 2 * width <= b:
            dst = np.full(L * PITCH, np.nan, np.float32)
            hi, off = (L - 2 * width + 1) * PITCH, width * PITCH
            f = np.arange(PITCH, hi)
            dst[f] = np.fmax(src[f], src[f + off])
            src, width = dst, 2 * width
        f = np.arange(n * PITCH)
        srm = np.fmax(src[f + PITCH], src[f + (1 + b - width) * PITCH])
        out[c0:c0 + nc] = srm.reshape(n, PITCH)[:, :nc].T
    return out


@pytest.mark.parametrize("n", [1, 63, 64, 96, 256])
def test_kernel_window_peak_matches_sliding_window_max(n):
    """At L = b + n, 13 channels: a full block and a ragged one of 5."""
    rng = np.random.default_rng(50 + n)
    b = tagc.agc_params(2).attack_buffsize
    abs_full = np.abs(_cx(rng, 13, b + n))
    want = tagc._sliding_window_max(T(abs_full), b)[..., 1:1 + n]
    got = _kernel_window_peak(abs_full, b, n)
    np.testing.assert_array_equal(got, want.numpy())


def _kernel_step(p, carry, rm, ao):
    """agc.cu's agc_step: three candidate volts (attack, fast decay, the
    slow release with its multiplier chosen from the state, 0 to hold,
    state 3's scaled by a further 0.05) and selects."""
    volts, sv, fb, hb, hc, dt, st = carry
    W, i32 = torch.where, torch.int32
    is0, is1, is3 = st == 0, st == 1, st == 3
    fast_back = p.fast_backmult * ao + p.onemfast_backmult * fb
    hang_back = p.hang_backmult * ao + p.onemhang_backmult * hb
    hcm = torch.clamp(hc - 1, min=0)
    s0_hang = (hang_back > p.hang_level) & (p.hang_enable == 1)
    hold = (is0 & s0_hang) | ((is1 | (st == 2)) & (hcm > 0))
    use_dm = is0 | (is1 & (dt == 0)) | is3
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    m_slow = W(hold, f32(0.0), W(use_dm, f32(p.decay_mult),
                                 f32(p.hang_decay_mult)))
    st_slow = W(hold, 2, W(use_dm, 3, 4))

    diff = rm - volts
    attack = rm >= volts
    s0_fast = volts > p.pop_ratio * fast_back
    fast = (is0 & s0_fast) | (is1 & (volts > sv))
    v_att = volts + diff * p.attack_mult
    v_fast = volts + diff * p.fast_decay_mult
    v_slow = volts + (diff * m_slow) * W(is3, f32(0.05), f32(1.0))
    nv = W(attack, v_att, W(fast, v_fast, v_slow))

    s0_rel = ~attack & is0 & ~s0_fast
    return (torch.clamp(nv, min=p.min_volts),
            W(attack & (st >= 2), volts, sv), fast_back, hang_back,
            W(s0_rel & s0_hang, p.hang_counter_init, hcm).to(i32),
            W(s0_rel, W(s0_hang, 1, 0), dt).to(i32),
            W(attack, 0, W(fast, 1, st_slow)).to(i32))


@pytest.mark.parametrize("mode", MODES)
def test_kernel_step_and_gain_order_match_plain(mode):
    """The recurrence in the kernel's form, writing volts alone, then the
    gain curve over all samples, against the plain step with the gain
    curve inside the loop: bit for bit, over streams that reach all
    five states."""
    rng = np.random.default_rng(60 + mode)
    p = tagc.agc_params(mode)
    st = _rand_state(rng, p, 37)
    c_plain = c_kern = tuple(st[2:])
    seen = set(st.state.tolist())
    for _ in range(4):
        rm, ao, st = _streams(rng, p, st, 256)
        fused, v_kern = [], []
        for t in range(rm.shape[-1]):
            c_plain = tagc.agc_step(p, c_plain, rm[:, t], ao[:, t])
            fused.append(tagc.gain_curve(p, c_plain[0]))
            c_kern = _kernel_step(p, c_kern, rm[:, t], ao[:, t])
            v_kern.append(c_kern[0])
            seen |= set(c_plain[6].tolist())
        for a, r in zip(c_kern, c_plain):
            assert a.dtype == r.dtype and torch.equal(a, r)
        after = tagc.gain_curve(p, torch.stack(v_kern, dim=-1))
        assert torch.equal(after, torch.stack(fused, dim=-1))
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("mode", MODES)
def test_plain_agc_matches_scalar_oracle(mode):
    """The port's plain agc_apply against the literal transcription of
    the reference's per-sample loop, on the oracle test's bursty
    stimulus and at its tolerance."""
    p = tagc.agc_params(mode)
    rng = np.random.default_rng(mode)
    n = 3000
    env = np.sin(2 * np.pi * 3.0 * np.arange(n) / 24000) > 0
    x = (0.4 * env * rng.standard_normal(n)
         + 0.005 * rng.standard_normal(n)).astype(np.complex64)
    _, got = tagc.agc_apply(p, tagc.agc_state(p), T(x))
    np.testing.assert_allclose(got.numpy(), scalar_agc_oracle(p, x),
                               rtol=2e-4, atol=2e-5, err_msg=f"mode {mode}")
