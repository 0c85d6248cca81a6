"""The arithmetic order of the redesigned K6 (SAM PLL) and K7 (LMS),
held on the CPU.

`t41x_torch/csrc/sam.cu` runs the phase loop two steps at a time (phase
t+1 = mod(phase t + fil t-1) does not wait for step t's detector),
keeps sin and cos of each phase, and forms the mixer products, the audio
and the two fade-leveler trackers after the loop; its floor-mod avoids
`fmodf` on the range the loop produces.  `t41x_torch/csrc/xanr.cu`
forms sigma, inv_sigp and nel's factor for every step ahead of the
loop, selects between the two candidate leak factors, and sums the
prediction over 8 lanes of 8 taps.  The kernels run only on a card;
these tests hold a Python model of each order against the port's plain
versions: K6 bit for bit with `sam_scan` (fade leveler on and off, from
random carried states), its floor-mod against `torch.remainder` on the
loop's range and at its edges, K7 within chip_smoke.py's 1e-4 / 1e-5
over 3 blocks of `xanr_scan` with the leak index at its fixed points
120 and 200, and its lane order equal to the 32-lane butterfly of
`torch.sum` on the card.
"""

import numpy as np
import pytest
import torch

from t41x_torch.demod import sam as tsam
from t41x_torch.dsp import nr as tnr

torch.set_num_threads(1)
T = torch.from_numpy
TWO_PI = torch.tensor(tsam._TWO_PI, dtype=torch.float32)  # as the kernel


# ---- K6 ---------------------------------------------------------------------

def _pmod(a: torch.Tensor) -> torch.Tensor:
    """sam.cu's pmod: a - 2 pi on [2 pi, 4 pi), a on (-2 pi, 2 pi), fmod
    outside; then the divisor's sign."""
    inside = (a > -TWO_PI) & (a < 2 * TWO_PI)
    m = torch.where(inside, torch.where(a >= TWO_PI, a - TWO_PI, a),
                    torch.fmod(a, TWO_PI))
    return torch.where(m < 0, m + TWO_PI, m)


def _bits(a: torch.Tensor) -> np.ndarray:
    return a.numpy().view(np.int32)


def test_k6_floor_mod_equals_remainder():
    """Bit for bit (zeros' signs included) with the plain version's
    torch.remainder: dense around 0, 2 pi, 4 pi and -2 pi, at the loop's
    edges, on its range (-1.1, 2 pi + 1.1), and far outside."""
    rng = np.random.default_rng(40)
    tp = np.float32(TWO_PI)
    # every float within 4096 ulps of 2 pi, 4 pi and -2 pi; steps of
    # 2^-23 around 0
    near = [e + np.arange(-4096, 4097, dtype=np.float32)
            * np.spacing(np.float32(max(abs(e), 1.0)))
            for e in (np.float32(0.0), tp, 2 * tp, -tp)]
    up = np.nextafter
    special = np.array([0.0, -0.0, up(tp, 0), tp, up(tp, 8), up(2 * tp, 0),
                        2 * tp, -1e-30, -1e-45, -1e-7, -1.0, up(-tp, 0),
                        -tp, up(-tp, -8), 100.0, -100.0, 1e6, -1e6],
                       np.float32)
    a = T(np.concatenate(near + [
        special, rng.uniform(-1.1, tp + 1.1, 1 << 20).astype(np.float32),
        rng.uniform(-40.0, 40.0, 1 << 16).astype(np.float32)]))
    np.testing.assert_array_equal(_bits(_pmod(a)),
                                  _bits(torch.remainder(a, tsam._TWO_PI)))


def _k6_model(p, st, y):
    """sam.cu, step for step: the phase loop two steps at a time, then
    the audio from the stored sin and cos, then the trackers."""
    i, q = y.real, y.imag
    n = y.shape[-1]
    phz, fil, om2 = st.phzerror, st.fil_out, st.omega2
    atan2 = tsam.atan2_poly

    def mix(s, c, t):
        return c * i[..., t] + s * q[..., t], c * q[..., t] - s * i[..., t]

    def loop_filter(det, om2):
        om2 = torch.clamp(om2 + p.g2 * det, p.omega_min, p.omega_max)
        return p.g1 * det + om2, om2

    sins, coss = [], []
    s0, c0 = torch.sin(phz), torch.cos(phz)
    t = 0
    while t + 2 <= n:
        phz1 = _pmod(phz + fil)
        s1, c1 = torch.sin(phz1), torch.cos(phz1)
        re0, im0 = mix(s0, c0, t)
        re1, im1 = mix(s1, c1, t + 1)
        sins += [s0, s1]
        coss += [c0, c1]
        fil0, om2 = loop_filter(atan2(im0, re0), om2)
        fil, om2 = loop_filter(atan2(im1, re1), om2)
        phz = _pmod(phz1 + fil0)
        s0, c0 = torch.sin(phz), torch.cos(phz)
        t += 2
    if t < n:
        re0, im0 = mix(s0, c0, t)
        sins.append(s0)
        coss.append(c0)
        fil, om2, del_ = *loop_filter(atan2(im0, re0), om2), fil
        phz = _pmod(phz + del_)
    s, co = torch.stack(sins, -1), torch.stack(coss, -1)
    ai, bi, aq, bq = co * i, s * i, co * q, s * q
    a = (ai - bi) + (aq + bq)
    dc, dci = st.dc, st.dc_insert
    if p.fade_leveler:
        pa, pr = p.onem_mtauR * a, p.onem_mtauI * (ai + bq)
        dcs, dcis = [], []
        for t in range(n):
            dc = p.mtauR * dc + pa[..., t]
            dci = p.mtauI * dci + pr[..., t]
            dcs.append(dc)
            dcis.append(dci)
        a = (a + torch.stack(dcis, -1)) - torch.stack(dcs, -1)
    return tsam.SAMState(phz, fil, om2, dc, dci), a


def _sam_y(rng, ch, n, b):
    t = (np.arange(n) + n * b) / 24000.0
    y = np.exp(2j * np.pi * 120.0 * t) * (1.0 + 0.4 * np.cos(
        2 * np.pi * 400.0 * t)) * np.linspace(0.5, 1.0, ch)[:, None]
    noise = rng.standard_normal((ch, n)) + 1j * rng.standard_normal((ch, n))
    return T((y + 0.01 * noise).astype(np.complex64))


def _sam_rand_state(rng, p, ch):
    """Phases outside [0, 2 pi), omega2 inside and at both clips."""
    u = lambda lo, hi: rng.uniform(lo, hi, ch).astype(np.float32)  # noqa
    om2 = u(p.omega_min, p.omega_max)
    om2[::3], om2[1::3] = p.omega_max, p.omega_min
    return tsam.SAMState(*map(T, (u(-8.0, 20.0), u(-1.0, 1.0), om2,
                                  u(-0.5, 0.5), u(0.0, 1.0))))


@pytest.mark.parametrize("n", [64, 255, 256])
@pytest.mark.parametrize("fade", [0, 1])
def test_k6_order_matches_sam_scan(fade, n):
    rng = np.random.default_rng(41 + n + fade)
    p = tsam.sam_params(fade_leveler=fade)
    ch = 7
    for st in (tsam.sam_state((ch,)), _sam_rand_state(rng, p, ch)):
        sm = sp = st
        for b in range(3):
            y = _sam_y(rng, ch, n, b)
            sm, am = _k6_model(p, sm, y)
            sp, ap = tsam.sam_scan(p, sp, y)
            np.testing.assert_array_equal(_bits(am), _bits(ap))
            for f in sp._fields:
                np.testing.assert_array_equal(
                    _bits(getattr(sm, f)), _bits(getattr(sp, f)), f)


# ---- K7 ---------------------------------------------------------------------

def _butterfly_sum(v: torch.Tensor) -> torch.Tensor:
    """What a 32-lane xor butterfly over taps (l, l + 32) leaves on every
    lane: pairs (l, l + 32), then halving (torch.sum's order over 64
    elements on the card)."""
    v = v[..., :32] + v[..., 32:]
    h = 16
    while h:
        v = v[..., :h] + v[..., h:2 * h]
        h //= 2
    return v[..., 0]


def _lane_sum(v: torch.Tensor, lanes: int) -> torch.Tensor:
    """xanr.cu's prediction sum: tap k = j + lanes m on lane j, a halving
    tree over m in each lane, then the xor butterfly over the lanes."""
    acc = v.reshape(v.shape[:-1] + (64 // lanes, lanes))
    h = acc.shape[-2] // 2
    while h:
        acc = acc[..., :h, :] + acc[..., h:2 * h, :]
        h //= 2
    v = acc[..., 0, :]
    h = lanes // 2
    while h:
        v = v[..., :h] + v[..., h:2 * h]
        h //= 2
    return v[..., 0]


@pytest.mark.parametrize("lanes", [32, 16, 8, 4])
def test_k7_lane_order_is_the_butterfly(lanes):
    """Any lane layout of the kernel sums in the 32-lane butterfly's
    order, bit for bit."""
    rng = np.random.default_rng(42)
    v = T((rng.standard_normal((512, 64))
           * np.exp(rng.uniform(-8, 8, (512, 64)))).astype(np.float32))
    np.testing.assert_array_equal(_bits(_lane_sum(v, lanes)),
                                  _bits(_butterfly_sum(v)))


def _k7_model(p, st, x, lanes=8):
    """xanr.cu, step for step: the input-only factors ahead of the loop,
    both candidate leak factors, the lane-layout sum."""
    n, hd = x.shape[-1], p.taps + p.delay
    pad = torch.cat([st.dline.flip(-1), x], dim=-1)
    win = pad.unfold(-1, p.taps, 1)[..., 1:n + 1, :]   # (..., n, taps)
    sigma = _butterfly_sum(win * win)
    inv_sigp = 1.0 / (sigma + 1e-10)
    nelf = 1.0 - p.two_mu * sigma * inv_sigp
    w, lidx, ngamma = st.w.flip(-1), st.lidx, st.ngamma

    def leak(lidx):
        l2 = lidx * lidx
        return p.gamma * (l2 * l2) * p.den_mult

    c0p = 1.0 - p.two_mu * ngamma
    ys = []
    for t in range(n):
        r = win[..., t, :]
        lidx_new = torch.where(
            lidx + p.lincr > p.lidx_max, p.lidx_max,
            torch.clamp(lidx + p.lincr - p.ldecr, min=p.lidx_min))
        ng_keep, ng_new = leak(lidx), leak(lidx_new)
        xn = x[..., t]
        yp = _lane_sum(w * r, lanes)
        error = xn - yp
        ys.append(error if p.notch else yp)
        mue = p.two_mu * error
        nel = (error * nelf[..., t]).abs()
        nev = ((xn - c0p * yp) - mue * sigma[..., t] * inv_sigp[..., t]).abs()
        step = nev < nel
        lidx = torch.where(step, lidx_new, lidx)
        ngamma = torch.where(step, ng_new, ng_keep)
        c0 = 1.0 - p.two_mu * ngamma
        c1 = mue * inv_sigp[..., t]
        w = c0[..., None] * w + c1[..., None] * r
        c0p = c0
    y = torch.stack(ys, dim=-1) * (1.0 if p.notch else p.post_gain)
    return tnr.XanrState(pad[..., -hd:].flip(-1), w.flip(-1), lidx,
                         ngamma), y


@pytest.mark.parametrize("lidx", [120.0, 200.0])
@pytest.mark.parametrize("notch", [False, True])
def test_k7_order_within_bounds_of_xanr_scan(notch, lidx):
    rng = np.random.default_rng(43)
    ch = 6
    p = tnr.XanrParams(notch=notch)
    st = tnr.xanr_state(p, (ch,))._replace(
        lidx=torch.full((ch,), lidx),
        w=T((rng.standard_normal((ch, 64)) * 0.01).astype(np.float32)),
        dline=T((rng.standard_normal((ch, 80)) * 0.2).astype(np.float32)))
    sm = sp = st
    for b in range(3):
        x = T((rng.standard_normal((ch, 256)) * 0.2).astype(np.float32))
        sm, ym = _k7_model(p, sm, x)
        sp, yp = tnr.xanr_scan(p, sp, x)
        np.testing.assert_allclose(ym.numpy(), yp.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"y block {b}")
        for f in sp._fields:
            np.testing.assert_allclose(getattr(sm, f).numpy(),
                                       getattr(sp, f).numpy(), rtol=1e-4,
                                       atol=1e-5, err_msg=f"{f} block {b}")
        np.testing.assert_array_equal(sm.dline.numpy(), sp.dline.numpy())
        np.testing.assert_array_equal(sm.lidx.numpy(), sp.lidx.numpy())
